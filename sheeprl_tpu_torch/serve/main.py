"""``python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt> [serve.* overrides]``
(port of ``sheeprl_tpu/serve/main.py``).

The config is read from the checkpoint's own ``config.yaml`` (written by either
package; ``_target_``/``cls`` paths of the JAX package are re-pointed at the
port), a ``serve`` block of serving knobs is merged over it (defaults below,
then dotted ``serve.*`` CLI overrides), the checkpoint is resolved by
``resolve_checkpoint_path`` (a run dir resolves to its newest valid checkpoint),
and the family's extractor builds the policy the server batches.

Serving knobs (``serve.*``) and what the port does with them:

- ``slots``, ``max_batch_wait_ms``, ``greedy``, ``sessions``,
  ``max_session_steps``, ``request_timeout``, ``log_dir``, ``max_queue``,
  ``deadline_ms``, ``degraded_wait_factor``, ``drain_grace_s`` — as in the JAX
  package;
- ``prime``, ``explore``, ``reload``, ``supervisor`` and ``telemetry`` — kept so
  the key set matches, but not yet ported: only their off values are accepted.
  ``telemetry.enabled`` therefore defaults to false here.

Each run writes ``summary.json`` into its log dir: sessions, ticks, served
steps, wall time and the device-step latency percentiles.

Exit codes: ``0`` every session completed, ``1`` a session failed or the server
crashed, ``2`` nothing to drive, ``75`` SIGTERM -> drained cleanly.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

__all__ = ["SERVE_DEFAULTS", "build_serve_cfg", "serve_main"]

SERVE_DEFAULTS: Dict[str, Any] = {
    "slots": 4,
    "max_batch_wait_ms": 2.0,
    "greedy": True,
    "sessions": 2,
    "max_session_steps": 1000,
    "request_timeout": 120.0,
    "log_dir": None,  # default: logs/serve/<algo>_<timestamp>
    "prime": False,
    "max_queue": None,
    "deadline_ms": None,
    "explore": {"fraction": 0.0, "noise": 0.3},
    "degraded_wait_factor": 4.0,
    "drain_grace_s": 10.0,
    "reload": {"enabled": False, "poll_s": 2.0, "watch_dir": None},
    "supervisor": {"enabled": False, "max_restarts": 3, "backoff": 1.0, "backoff_cap": 60.0},
    "telemetry": {"enabled": False, "every": 256},
}


def _check_unported(cfg) -> None:
    serve = cfg.serve
    unported = []
    if bool(serve.get("prime")):
        unported.append("serve.prime")
    if float((serve.get("explore") or {}).get("fraction") or 0.0) > 0.0:
        unported.append("serve.explore.fraction")
    if bool((serve.get("reload") or {}).get("enabled")):
        unported.append("serve.reload.enabled")
    if bool((serve.get("supervisor") or {}).get("enabled")):
        unported.append("serve.supervisor.enabled")
    if bool((serve.get("telemetry") or {}).get("enabled")):
        unported.append("serve.telemetry.enabled")
    if (((cfg.get("metric") or {}).get("telemetry") or {}).get("http_port")) is not None:
        unported.append("metric.telemetry.http_port")
    if ((cfg.get("resilience") or {}).get("fault") or {}).get("kind"):
        unported.append("resilience.fault.kind")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not yet ported to sheeprl_tpu_torch (only the off values are accepted)"
        )


def build_serve_cfg(overrides: Sequence[str]):
    """Checkpoint's config.yaml + serve defaults + dotted CLI overrides. Returns
    the dotdict cfg with ``checkpoint_path`` resolved and ``serve`` populated."""
    import yaml

    from sheeprl_tpu_torch.config import dotdict, repoint_targets, set_by_path, yaml_load
    from sheeprl_tpu_torch.resilience.discovery import resolve_checkpoint_path

    kv = dict(o.split("=", 1) for o in overrides if "=" in o)
    ckpt_arg = kv.get("checkpoint_path")
    if ckpt_arg is None:
        raise ValueError("you must specify checkpoint_path=... (a checkpoint file or a run dir)")
    ckpt_path = Path(resolve_checkpoint_path(ckpt_arg))
    cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not cfg_path.is_file():
        cfg_path = ckpt_path.parent / "config.yaml"
    if not cfg_path.is_file():
        raise ValueError(f"cannot serve {ckpt_path}: no config.yaml found next to the checkpoint")
    with open(cfg_path) as f:
        base = repoint_targets(yaml.safe_load(f))
    # serving is single-controller, one env worth of obs per session
    base["env"]["num_envs"] = 1
    base["env"]["capture_video"] = False
    base.setdefault("fabric", {})
    base["fabric"]["devices"] = 1
    base["checkpoint_path"] = str(ckpt_path)
    base["serve"] = copy.deepcopy(SERVE_DEFAULTS)
    cfg = dotdict(base)
    for key, raw in kv.items():
        if key == "checkpoint_path":
            continue
        try:
            value = yaml_load(raw)
        except yaml.YAMLError:
            value = raw
        set_by_path(cfg, key, value, create=True)
    cfg.seed = int(kv.get("seed", base.get("seed", 42)))
    return cfg


def _default_log_dir(cfg) -> str:
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.join("logs", "serve", f"{cfg.algo.name}_{stamp}")


def _watch_drain(server, grace_s: float, stop: threading.Event, drained: Dict[str, bool]) -> None:
    from sheeprl_tpu_torch.resilience import signals

    while not stop.wait(0.2):
        if signals.preemption_requested():
            drained["yes"] = True
            print(
                f"[sheeprl-serve] preemption requested: draining (grace {grace_s:.0f}s)",
                file=sys.stderr,
                flush=True,
            )
            server.drain(grace_s)
            return


def serve_main(args: Optional[Sequence[str]] = None) -> int:
    """The ``serve`` verb. Returns the process exit code."""
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.resilience import signals
    from sheeprl_tpu_torch.serve.drivers import run_env_sessions
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    overrides = list(args if args is not None else sys.argv[1:])
    cfg = build_serve_cfg(overrides)
    _check_unported(cfg)
    serve_cfg = cfg.serve

    sessions = int(serve_cfg.sessions)
    if sessions < 1:
        print(
            "[sheeprl-serve] serve.sessions=0: nothing to drive; set serve.sessions=N to run "
            "N concurrent env sessions to completion.",
            file=sys.stderr,
        )
        return 2

    fabric = Fabric(
        devices=1,
        accelerator=cfg.fabric.get("accelerator", "auto"),
        precision=cfg.fabric.get("precision", "32-true"),
        float32_matmul_precision=cfg.get("float32_matmul_precision", "high"),
    )
    fabric.seed_everything(int(cfg.seed))
    log_dir = serve_cfg.get("log_dir") or _default_log_dir(cfg)
    os.makedirs(log_dir, exist_ok=True)

    state = load_checkpoint(cfg.checkpoint_path)
    policy = resolve_serve_policy(fabric, cfg, state)
    server = PolicyServer(
        policy,
        slots=int(serve_cfg.slots),
        max_batch_wait_ms=float(serve_cfg.max_batch_wait_ms),
        base_seed=int(cfg.seed),
        request_timeout=float(serve_cfg.request_timeout),
        max_queue=serve_cfg.get("max_queue"),
        deadline_ms=serve_cfg.get("deadline_ms"),
        degraded_wait_factor=float(serve_cfg.get("degraded_wait_factor") or 4.0),
    )
    print(
        f"[sheeprl-serve] serving {cfg.algo.name} from {cfg.checkpoint_path} on {fabric.device_name} — "
        f"{serve_cfg.slots} slots, {sessions} env session(s), log dir {log_dir}",
        flush=True,
    )

    handler_installed = signals.install_preemption_handler()
    stop = threading.Event()
    drained = {"yes": False}
    grace = float(serve_cfg.get("drain_grace_s") or 10.0)
    watcher = threading.Thread(
        target=_watch_drain, args=(server, grace, stop, drained), name="sheeprl-serve-watch", daemon=True
    )
    t0 = time.perf_counter()
    server.start()
    watcher.start()
    try:
        results = run_env_sessions(
            server,
            cfg,
            sessions=sessions,
            max_session_steps=int(serve_cfg.max_session_steps),
            log_dir=log_dir,
        )
    finally:
        stop.set()
        watcher.join(timeout=grace + 30.0)
        server.close()
        if handler_installed:
            signals.uninstall_preemption_handler()
    wall = time.perf_counter() - t0

    summary = {
        "algo": str(cfg.algo.name),
        "device": fabric.device_name,
        "slots": int(serve_cfg.slots),
        "sessions": sessions,
        "sessions_completed": sum(1 for r in results if not r.get("error")),
        "wall_s": wall,
        **server.stats.as_dict(),
    }
    summary["steps_per_s"] = summary["steps"] / wall if wall > 0 else None
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    for r in results:
        print(
            f"[sheeprl-serve] session seed={r.get('seed')}: {r.get('steps', 0)} steps, "
            f"reward {r.get('reward', 0.0):.2f}" + (f" — ERROR {r['error']}" if r.get("error") else "")
        )
    print(
        f"[sheeprl-serve] {summary['ticks']} ticks, {summary['steps']} steps in {wall:.2f}s "
        f"(tick p50 {summary['tick_ms_p50']} ms, p99 {summary['tick_ms_p99']} ms)",
        flush=True,
    )
    if drained["yes"]:
        print(f"[sheeprl-serve] drained after preemption request (code {signals.PREEMPTED_EXIT_CODE})")
        return signals.PREEMPTED_EXIT_CODE
    if server._error is not None:
        print(f"[sheeprl-serve] server crashed: {server._error!r}", file=sys.stderr)
        return 1
    return 1 if any(r.get("error") for r in results) else 0
