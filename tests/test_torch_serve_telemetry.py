"""The port's serving telemetry against the JAX package's readers, on the CPU.

Two serving runs of the port (the small Dreamer-V3 agent, one slot, one
session), each through ``serve_main`` with telemetry at its default (on):

- ``slow_tick``: booted from a run's first checkpoint with a newer one beside
  it and ``serve.reload.enabled=true``, so the reloader applies it, and a
  ``slow_tick`` fault of 300 ms a tick from served step 65 of 96;
- ``session_flood``: ``serve.max_queue=0`` and a flood of 8 sessions at served
  step 2, which the full table sheds.

Then:

- every event the port writes passes the JAX package's ``obs/schema.py``;
- the JAX package's ``diagnose`` over the port's streams finds what the port's
  copy finds: ``latency_regression`` for the slow ticks, ``shed_rate`` for
  the flood;
- the window blocks of the port's ``ServingTelemetry`` equal the JAX one's fed
  the same ticks (its latency percentiles are JAX's ``_percentiles``);
- ``/healthz`` answers 200 ``ok`` while a server runs and 503 ``draining``
  once it drains, and closes with the server.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from test_torch_helpers import overrides

# the slow ticks stall 300 ms each, over ten times a served tick's p99 on this
# agent alone (~27 ms), so that the last two windows' p99 stays above twice the
# run's median p99 (diagnose's latency_regression ratio) however much a loaded
# host slows the other ticks
SLOW_AT, SLOW_MS, STEPS, EVERY = 65, 300.0, 96, 16


def _write_run(root: Path, seeds=(3,)) -> Path:
    """A run dir of the small DV3 agent written by the JAX package, one
    checkpoint per seed (the later ones newer)."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    from test_torch_helpers import _jax_agent

    ckpt_dir = root / "version_0" / "checkpoint"
    paths = []
    for i, seed in enumerate(seeds):
        paths.append(ckpt_dir / f"ckpt_{8 * i}_0.ckpt")
        jax_save(str(paths[-1]), {"agent": _jax_agent("discrete", (), seed)[1]})
    with open(root / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(jax_compose(overrides("discrete")).as_dict(), f, sort_keys=False)
    return paths[0]


def _serve(args) -> int:
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.serve.main import serve_main

    faults.reset_faults()
    try:
        return serve_main(args)
    finally:
        faults.reset_faults()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{kind: log dir} of the two runs (module docstring)."""
    root = tmp_path_factory.mktemp("serve_streams")
    boot = _write_run(root / "run", seeds=(3, 4))
    common = ["fabric.accelerator=cpu", "serve.sessions=1", "serve.slots=1", f"serve.max_session_steps={STEPS}",
              f"env.wrapper.n_steps={STEPS}", f"serve.telemetry.every={EVERY}"]
    out = {"slow_tick": root / "slow", "session_flood": root / "flood"}
    rc = _serve([f"checkpoint_path={boot}", *common, f"serve.log_dir={out['slow_tick']}",
                 "serve.reload.enabled=true", "serve.reload.poll_s=0.05", "resilience.fault.kind=slow_tick",
                 f"resilience.fault.at_policy_step={SLOW_AT}", f"resilience.fault.factor={SLOW_MS}"])
    assert rc == 0
    rc = _serve([f"checkpoint_path={boot}", *common, f"serve.log_dir={out['session_flood']}", "serve.max_queue=0",
                 "resilience.fault.kind=session_flood", "resilience.fault.at_policy_step=2",
                 "resilience.fault.factor=8"])
    assert rc == 0
    return out


def _events(log_dir: Path):
    return [json.loads(line) for line in (log_dir / "telemetry.jsonl").read_text().splitlines()]


@pytest.mark.timeout(300)
def test_port_events_pass_the_jax_schema(streams):
    from sheeprl_tpu.obs.schema import SCHEMA_VERSION, validate_stream

    kinds = set()
    for log_dir in streams.values():
        assert validate_stream(str(log_dir / "telemetry.jsonl")) == []
        events = _events(log_dir)
        kinds |= {e["event"] for e in events}
        start = events[0]
        assert start["event"] == "start" and start["schema"] == SCHEMA_VERSION
        assert start["platform"] == "cpu" and start["fingerprint"]["algo"] == "dreamer_v3"
        windows = [e for e in events if e["event"] == "window"]
        assert len(windows) == STEPS // EVERY and sum(w["steps"] for w in windows) == STEPS
        assert all(w["hbm"] is None for w in windows)  # no allocator stats on the CPU
        assert all(set(w["compile"]) == {"count", "seconds", "window_count", "window_seconds"} for w in windows)
        assert events[-1]["event"] == "summary" and events[-1]["clean_exit"] is True
    assert {"start", "window", "fault", "reload", "health", "summary"} <= kinds
    reload = next(e for e in _events(streams["slow_tick"]) if e["event"] == "reload")
    assert reload["status"] == "applied" and reload["version"] == 1


@pytest.mark.timeout(300)
def test_jax_diagnose_finds_what_the_port_finds(streams):
    from sheeprl_tpu.obs.diagnose import diagnose_run as jax_diagnose

    from sheeprl_tpu_torch.obs.diagnose import diagnose_run

    for log_dir in streams.values():
        ours, theirs = diagnose_run(str(log_dir)), jax_diagnose(str(log_dir))
        key = lambda r: [(f["detector"], f["severity"], f["summary"]) for f in r["findings"]]  # noqa: E731
        assert key(ours) == key(theirs) and key(ours)


def test_window_percentiles_match_jax():
    """The port's ServingTelemetry and the JAX one, fed the same ticks and a
    reload: the same window serve blocks, whose latency percentiles are JAX's
    ``_percentiles`` of the window's samples, and the same promotion verdict
    (its event passes the JAX schema too)."""
    import tempfile

    from sheeprl_tpu.obs.schema import validate_stream
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.telemetry import ServingTelemetry as JaxTelemetry
    from sheeprl_tpu.serve.telemetry import _percentiles as jax_percentiles

    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.telemetry import ServingTelemetry, _percentiles

    cfg = {"algo": {"name": "dreamer_v3"}, "metric": {"telemetry": {"slo": {"enabled": False}}}}
    jfabric = JaxFabric(devices=1, accelerator="cpu")
    jfabric._setup()
    rng = np.random.default_rng(0)
    samples = []
    with tempfile.TemporaryDirectory() as tmp:
        sides = {
            "port": ServingTelemetry(Fabric(accelerator="cpu"), cfg, f"{tmp}/port", every=8, diagnosis=False),
            "jax": JaxTelemetry(jfabric, cfg, f"{tmp}/jax", every=8, diagnosis=False),
        }
        for tick in range(40):
            batch = int(rng.integers(1, 4))
            latencies = list(rng.gamma(2.0, 1.5, batch))
            samples.append(latencies)
            for tel in sides.values():
                tel.observe_tick(batch=batch, slots=4, active=3, queue_depth=int(tick % 3 == 0),
                                 step_seconds=0.001, wait_seconds=0.0005, latencies_ms=latencies,
                                 started=int(tick == 0), finished=int(tick == 39), shed=int(tick == 5),
                                 state_bytes=1024, weight_version=int(tick >= 20), degraded=False)
                if tick == 19:
                    tel.observe_reload(version=1)
        for tel in sides.values():
            tel.close()
        events = {name: [json.loads(line) for line in open(f"{tmp}/{name}/telemetry.jsonl")] for name in sides}
        assert validate_stream(f"{tmp}/port/telemetry.jsonl") == []
    # the reload at tick 19 is judged once 32 steps served at version 1
    for name in sides:
        assert [e["verdict"] for e in events[name] if e["event"] == "promotion"] == ["promote"]
    windows = {name: [e for e in events[name] if e["event"] == "window"] for name in sides}
    assert len(windows["port"]) == len(windows["jax"]) >= 5
    for ours, theirs in zip(windows["port"], windows["jax"]):
        for block in (ours["serve"], theirs["serve"]):
            block["sessions"].pop("per_sec")  # sessions over the window's wall time
        assert ours["serve"] == theirs["serve"] and ours["steps"] == theirs["steps"]
    # the first window's latencies, from the ticks that filled it
    steps, first = 0, []
    for latencies in samples:
        first += latencies
        steps += len(latencies)
        if steps >= 8:
            break
    assert windows["port"][0]["serve"]["latency_ms"] == _percentiles(first) == jax_percentiles(first)


@pytest.mark.timeout(300)
def test_slow_tick_raises_latency_regression(streams):
    events = _events(streams["slow_tick"])
    fault = next(e for e in events if e["event"] == "fault")
    assert fault["kind"] == "slow_tick" and fault["step"] == SLOW_AT and fault["factor"] == SLOW_MS
    findings = [f for e in events if e["event"] == "health" and e.get("status") == "diagnosis"
                for f in e["findings"]]
    assert any(f["detector"] == "latency_regression" for f in findings)
    windows = [e for e in events if e["event"] == "window"]
    # the stall shows in every window after the fault's, not before it
    assert all(w["serve"]["latency_ms"]["p50"] >= SLOW_MS for w in windows if w["step"] - EVERY >= SLOW_AT)
    assert windows[0]["serve"]["weights"]["version"] in (0, 1) and windows[-1]["serve"]["weights"]["version"] == 1


@pytest.mark.timeout(300)
def test_session_flood_raises_shed_rate(streams):
    events = _events(streams["session_flood"])
    fault = next(e for e in events if e["event"] == "fault")
    assert fault["kind"] == "session_flood" and fault["factor"] == 8.0
    findings = [f for e in events if e["event"] == "health" and e.get("status") == "diagnosis"
                for f in e["findings"]]
    assert any(f["detector"] == "shed_rate" for f in findings)
    summary = events[-1]
    assert summary["serve"]["sessions_shed"] == 8 and summary["serve"]["sessions_finished"] == 1


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())
    except (urllib.error.URLError, ConnectionError):
        return None, {}  # no answer (the endpoint is not up, or closed): the caller polls on


def _wait_health(url: str, status: str, timeout: float = 120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, body = _get(url)
        if body.get("status") == status:
            return code, body
        time.sleep(0.05)
    raise AssertionError(f"/healthz never reported {status!r}")


@pytest.mark.timeout(300)
def test_healthz_moves_through_readiness_states(tmp_path):
    from sheeprl_tpu.obs.schema import validate_stream

    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.resilience import signals
    from sheeprl_tpu_torch.serve.main import _ServeAttempt, build_serve_cfg

    boot = _write_run(tmp_path / "run")
    cfg = build_serve_cfg([f"checkpoint_path={boot}", "fabric.accelerator=cpu", "serve.sessions=1",
                           "serve.slots=1", "serve.max_session_steps=1000000", "env.wrapper.n_steps=1000000",
                           "serve.drain_grace_s=5", "metric.telemetry.http_port=0"])
    attempt = _ServeAttempt(cfg, Fabric(accelerator="cpu"), str(tmp_path / "log"))
    port = attempt.telemetry.metrics_endpoint.port
    url = f"http://127.0.0.1:{port}/healthz"
    info = {}
    runner = threading.Thread(target=lambda: info.update(attempt.run()))
    signals.reset_preemption()
    runner.start()
    try:
        code, body = _wait_health(url, "ok")
        assert code == 200 and body["ready"] is True and body["weight_version"] == 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
            assert resp.status == 200
        signals.request_preemption()
        # the session never ends by itself, so the drain waits out its whole
        # grace: /healthz says "draining" for 5 s, far longer than a poll
        code, body = _wait_health(url, "draining")
        assert code == 503 and body["ready"] is False
        runner.join(timeout=120)
    finally:
        signals.request_preemption()
        runner.join(timeout=120)
        signals.reset_preemption()
    assert not runner.is_alive() and info["preempted"] is True
    with pytest.raises(OSError):  # the endpoint closed with the server
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    assert validate_stream(str(tmp_path / "log" / "telemetry.jsonl")) == []
    drains = [e["status"] for e in _events(tmp_path / "log") if e["event"] == "drain"]
    assert drains == ["begin", "end"]
