"""The port's serve supervisor, prime and explore slots, on the CPU.

- a ``crash`` fault at a served step kills the server; the supervisor restarts
  it in-process once (one ``restart`` event with the sessions the crash lost),
  the fault does not fire again, and the verb exits 0;
- a ``sigterm`` fault drains the server and the verb exits 75 without a
  restart, supervised or not;
- a failure every attempt hits (a step that always raises, as a sticky CUDA
  error would) uses up ``max_restarts`` and the verb raises it after a
  ``giveup`` event;
- ``serve.prime=true`` runs the slot step and attach once and exits 0 without
  serving a session or writing a stream;
- explore slots add the same session-seeded noise as the JAX server: two
  policies that always act 0, one per package, served side by side, deliver
  bit-equal actions, and those are ``default_rng(seed).normal(0, noise)``.

The JAX package runs these through its own ``serve_main`` in
``tests/test_serve/test_robustness.py``; here the port's runs are read through
the JAX package's stream reader.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import overrides


def _write_run(root: Path) -> Path:
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    from test_torch_helpers import _jax_agent

    ckpt = root / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"
    jax_save(str(ckpt), {"agent": _jax_agent("discrete", (), 3)[1]})
    with open(root / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(jax_compose(overrides("discrete")).as_dict(), f, sort_keys=False)
    return root


def _serve(run: Path, log_dir: Path, *extra: str) -> int:
    from sheeprl_tpu_torch.resilience import faults, signals
    from sheeprl_tpu_torch.serve.main import serve_main

    faults.reset_faults()
    signals.reset_preemption()
    try:
        return serve_main([f"checkpoint_path={run}", "fabric.accelerator=cpu", "serve.sessions=2",
                           "serve.slots=2", f"serve.log_dir={log_dir}", *extra])
    finally:
        faults.reset_faults()
        signals.reset_preemption()


def _events(log_dir: Path):
    from sheeprl_tpu.obs.jsonl import read_events  # the JAX package's reader

    return read_events(str(log_dir / "telemetry.jsonl"))


@pytest.mark.timeout(300)
def test_crash_restarts_once_and_exits_0(tmp_path):
    run = _write_run(tmp_path / "run")
    log = tmp_path / "log"
    rc = _serve(run, log, "serve.max_session_steps=8", "env.wrapper.n_steps=8", "serve.supervisor.enabled=true",
                "serve.supervisor.backoff=0", "resilience.fault.kind=crash", "resilience.fault.at_policy_step=6")
    assert rc == 0
    events = _events(log)
    restarts = [e for e in events if e["event"] == "restart"]
    assert len(restarts) == 1 and restarts[0]["reason"] == "crash" and restarts[0]["sessions_lost"] == 2
    assert "InjectedFaultError" in restarts[0]["error"]
    assert [e["kind"] for e in events if e["event"] == "fault"] == ["crash"]
    assert [e["status"] for e in events if e["event"] == "supervisor"] == ["completed"]
    # two attempts' streams in one file: the crashed one's summary is not clean
    summaries = [e for e in events if e["event"] == "summary"]
    assert [s["clean_exit"] for s in summaries] == [False, True] and [s["attempt"] for s in summaries] == [0, 1]
    summary = json.loads((log / "summary.json").read_text())
    assert summary["restarts"] == 1 and summary["sessions_completed"] == 2 and summary["steps"] == 16


@pytest.mark.timeout(300)
@pytest.mark.parametrize("supervised", [False, True], ids=["plain", "supervised"])
def test_sigterm_drains_and_exits_75_without_restart(tmp_path, supervised):
    run = _write_run(tmp_path / "run")
    log = tmp_path / "log"
    rc = _serve(run, log, "serve.max_session_steps=1000000", "env.wrapper.n_steps=1000000",
                "serve.drain_grace_s=0.2", f"serve.supervisor.enabled={str(supervised).lower()}",
                "resilience.fault.kind=sigterm", "resilience.fault.at_policy_step=10")
    assert rc == 75
    events = _events(log)
    assert not [e for e in events if e["event"] in ("restart", "giveup")]
    assert [e["status"] for e in events if e["event"] == "drain"] == ["begin", "end"]
    assert [e["status"] for e in events if e["event"] == "supervisor"] == (["preempted"] if supervised else [])


@pytest.mark.timeout(300)
def test_exhausted_restarts_raise_the_error(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.serve.slots import SlotTable

    def sticky(self, obs, mask):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(SlotTable, "step", sticky)
    run = _write_run(tmp_path / "run")
    log = tmp_path / "log"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _serve(run, log, "serve.max_session_steps=8", "serve.supervisor.enabled=true",
               "serve.supervisor.max_restarts=2", "serve.supervisor.backoff=0")
    events = _events(log)
    assert [e["attempt"] for e in events if e["event"] == "restart"] == [1, 2]
    giveup = [e for e in events if e["event"] == "giveup"]
    assert len(giveup) == 1 and giveup[0]["attempts"] == 2 and giveup[0]["sessions_lost_total"] == 6


@pytest.mark.timeout(300)
def test_prime_warms_without_serving(tmp_path, capsys):
    run = _write_run(tmp_path / "run")
    log = tmp_path / "log"
    assert _serve(run, log, "serve.prime=true") == 0
    out = capsys.readouterr().out
    assert "primed dreamer_v3 on cpu" in out and "the slot step and attach ran once at 2 slots" in out
    assert "kernel libraries built 0, loaded 0" in out and "compiled" not in out
    assert "session seed=" not in out and not log.exists()


def test_explore_slots_add_the_reference_session_noise():
    from sheeprl_tpu.serve.policy import ObsSpec as JaxObsSpec
    from sheeprl_tpu.serve.policy import ServePolicy as JaxPolicy
    from sheeprl_tpu.serve.server import PolicyServer as JaxServer

    from sheeprl_tpu_torch.serve.policy import ObsSpec, ServePolicy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    port_policy = ServePolicy(
        algo="zero", device=torch.device("cpu"), init_slots=lambda n: {},
        step_slots=lambda carry, obs, noise: (torch.zeros(obs["state"].shape[0], 2), carry),
        noise_spec={}, obs_spec={"state": ObsSpec((3,), np.float32)}, action_shape=(2,),
    )
    jax_policy = JaxPolicy(
        algo="zero", params={"w": jnp.zeros(())}, init_slot=lambda params, key: {"key": key},
        step_slot=lambda params, carry, obs: (jnp.zeros((2,), jnp.float32) + params["w"], carry),
        obs_spec={"state": JaxObsSpec((3,), np.float32)}, action_shape=(2,),
    )
    seeds, steps, noise = [7, 8], 5, 0.3
    streams = {}
    for name, server in (("port", PolicyServer(port_policy, slots=2, explore_fraction=0.5, explore_noise=noise)),
                         ("jax", JaxServer(jax_policy, slots=2, explore_fraction=0.5, explore_noise=noise))):
        out = {}
        with server:
            sessions = [server.open_session(seed=s) for s in seeds]  # slot 0 (the explore slot), then slot 1

            def client(i):
                out[i] = [np.asarray(sessions[i].step({"state": np.zeros(3, np.float32)})) for _ in range(steps)]
                sessions[i].close()

            threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert server.explore_slots == 1
        streams[name] = out
    rng = np.random.default_rng(seeds[0])
    expected = [rng.normal(0.0, noise, (2,)).astype(np.float32) for _ in range(steps)]
    for i in range(2):
        for ours, theirs in zip(streams["port"][i], streams["jax"][i]):
            np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.stack(streams["port"][0]), np.stack(expected))
    assert not np.any(np.stack(streams["port"][1]))  # the greedy slot's actions are untouched
