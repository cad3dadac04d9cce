"""Serving-run driver: real env sessions (port of
``sheeprl_tpu/serve/drivers.py::run_env_sessions``). Each session is a plain
client thread of :class:`~sheeprl_tpu_torch.serve.server.PolicyServer` playing
one environment episode with served actions."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from sheeprl_tpu_torch.serve.server import (
    DeadlineExceeded,
    PolicyServer,
    ServerClosed,
    ServerOverloaded,
)

__all__ = ["run_env_sessions"]

# client etiquette under overload: honour the shed's retry-after a bounded
# number of times, retry a deadline-missed request a bounded number of times
_ADMISSION_RETRIES = 8
_DEADLINE_RETRIES = 2


def _open_with_retry(server: PolicyServer, seed: int, record: Dict[str, Any]):
    for _ in range(_ADMISSION_RETRIES):
        try:
            return server.open_session(seed=seed)
        except ServerOverloaded as exc:
            record["admission_retries"] = record.get("admission_retries", 0) + 1
            time.sleep(min(exc.retry_after_s, 5.0))
    return server.open_session(seed=seed)  # last try: let the rejection surface


def run_env_sessions(
    server: PolicyServer,
    cfg: Any,
    *,
    sessions: int,
    max_session_steps: int = 1000,
    log_dir: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Drive ``sessions`` concurrent env episodes through the server; returns
    one record per session: ``{seed, steps, reward, actions, error}``."""
    from sheeprl_tpu_torch.utils.env import make_env

    results: List[Dict[str, Any]] = [{} for _ in range(sessions)]

    def _client(i: int) -> None:
        record: Dict[str, Any] = {"seed": int(cfg.seed) + i, "steps": 0, "reward": 0.0, "actions": []}
        results[i] = record
        env = None
        session = None
        try:
            env = make_env(cfg, record["seed"], i, log_dir, "serve", vector_env_idx=i)()
            session = _open_with_retry(server, record["seed"], record)
            obs = env.reset(seed=record["seed"])[0]
            for _ in range(max_session_steps):
                for attempt in range(_DEADLINE_RETRIES + 1):
                    try:
                        action = session.step(obs)
                        break
                    except DeadlineExceeded:
                        # the request never reached the device (carry intact):
                        # retrying the same observation preserves the episode
                        record["deadline_retries"] = record.get("deadline_retries", 0) + 1
                        if attempt >= _DEADLINE_RETRIES:
                            raise
                record["actions"].append(np.asarray(action))
                obs, reward, terminated, truncated, _ = env.step(
                    np.asarray(action).reshape(env.action_space.shape)
                )
                record["reward"] += float(np.asarray(reward))
                record["steps"] += 1
                if bool(terminated) or bool(truncated):
                    break
        except (ServerClosed, ServerOverloaded, DeadlineExceeded, TimeoutError) as exc:
            record["error"] = repr(exc)
        finally:
            if session is not None:
                session.close()
            if env is not None:
                env.close()

    threads = [threading.Thread(target=_client, args=(i,), daemon=True) for i in range(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results
