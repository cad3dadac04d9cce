"""The port's ``DistributedCoordinator`` held to the JAX one
(``sheeprl_tpu/resilience/distributed.py``) on the same scripted inputs.

Both run on a fake clock (their module's ``time`` patched), and their monitor
and heartbeat loops run synchronously: each ``_stop.wait`` advances the clock
one poll and applies that tick's scripted store writes to both planes. The JAX
coordinator reads the fake KV of ``tests/test_resilience/test_distributed.py``;
the port's reads a dict-backed ``StoreKV``. Each case compares the decision
dict, the abort record and the ``health`` events field for field (exact: the
inputs are the same integers and clock readings).
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import pytest

from sheeprl_tpu.resilience import distributed as jax_dist
from sheeprl_tpu.resilience import signals as jax_signals
from sheeprl_tpu_torch.resilience import distributed as port_dist
from sheeprl_tpu_torch.resilience import signals as port_signals


def _jax_fake_kv_class():
    path = Path(__file__).resolve().parent / "test_resilience" / "test_distributed.py"
    spec = importlib.util.spec_from_file_location("jax_resilience_distributed_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FakeKV


JaxFakeKV = _jax_fake_kv_class()


class PortFakeKV:
    """A dict standing in for ``parallel/distributed.py::StoreKV``."""

    def __init__(self) -> None:
        self.store = {}

    def set(self, key, value):
        self.store[key] = str(value)

    def get(self, key):
        return self.store.get(key)

    def get_many(self, keys):
        return {k: self.store[k] for k in keys if k in self.store}

    def delete(self, key):
        self.store.pop(key, None)


class Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


class ScriptedStop:
    """A coordinator's ``_stop``: each ``wait`` advances the clock by its
    timeout, runs ``tick(n)`` and returns False, ``ticks`` times; then True."""

    def __init__(self, clock: Clock, ticks: int, tick=lambda n: None) -> None:
        self.clock, self.ticks, self.tick, self.n = clock, ticks, tick, 0

    def wait(self, timeout=None) -> bool:
        if self.n >= self.ticks:
            return True
        self.clock.now += float(timeout)
        self.tick(self.n)
        self.n += 1
        return False

    def set(self) -> None:
        self.n = self.ticks


@pytest.fixture
def pair(monkeypatch):
    """Both packages' modules on one fake clock and their own fake planes."""
    clock = Clock()
    fake_time = type("FakeTime", (), {"monotonic": staticmethod(clock.monotonic), "time": staticmethod(time.time),
                                      "sleep": staticmethod(lambda s: None)})
    jax_kv, port_kv = JaxFakeKV(), PortFakeKV()
    for module, kv in ((jax_dist, jax_kv), (port_dist, port_kv)):
        monkeypatch.setattr(module, "time", fake_time)
        monkeypatch.setattr(module, "_kv", lambda kv=kv: kv)
    for signals in (jax_signals, port_signals):
        signals.reset_preemption()
    yield clock, jax_kv, port_kv
    for signals in (jax_signals, port_signals):
        signals.reset_preemption()
    for module in (jax_dist, port_dist):
        coord = module.active_coordinator()
        if coord is not None:
            coord.close()


def _both(rank, nprocs, ns, **kwargs):
    events = {"jax": [], "port": []}
    coords = {
        "jax": jax_dist.DistributedCoordinator(rank, nprocs, namespace=ns,
                                               emit=lambda ev, **f: events["jax"].append((ev, f)), **kwargs),
        "port": port_dist.DistributedCoordinator(rank, nprocs, namespace=ns,
                                                 emit=lambda ev, **f: events["port"].append((ev, f)), **kwargs),
    }
    return coords, events


def _write_both(jax_kv, port_kv, key, value):
    jax_kv.key_value_set(key, value)
    port_kv.set(key, value)


def _run_monitor(coords, clock, ticks, tick=lambda n: None):
    """Each coordinator's monitor loop over the same scripted ticks, from the
    same clock reading."""
    start = clock.now
    for coord in coords.values():
        clock.now = start
        coord._stop = ScriptedStop(clock, ticks, tick)
        coord._monitor_loop()


def test_preempt_agreement_with_no_skew(pair):
    """A signal on rank 1 only: both packages publish the same request, the
    leader the same decision, and both ranks flip at the same step."""
    clock, jax_kv, port_kv = pair
    verdicts = {}
    for name, mod, kv in (("jax", jax_dist, jax_kv), ("port", port_dist, port_kv)):
        start = clock.now
        c0 = mod.DistributedCoordinator(0, 2, heartbeat_enabled=False, namespace="t/agree", poll_interval=0.01)
        c1 = mod.DistributedCoordinator(1, 2, heartbeat_enabled=False, namespace="t/agree", poll_interval=0.01)
        seq = []
        for step in (0, 4, 8):
            c0.step(step)
            c1.step(step)
            clock.now += 0.05
        c1.step(12, local_preempt=True)
        seq.append(c1.preempt_requested())
        clock.now += 0.05
        c0.step(12)
        decision = c0.decision()
        for step in range(16, int(decision["stop_step"]) + 16, 4):
            c0.step(step)
            c1.step(step)
            clock.now += 0.05
            seq.append((c0.preempt_requested(), c1.preempt_requested()))
        verdicts[name] = (decision, c1.decision(), seq)
        c0.close()
        c1.close()
        clock.now = start
    assert verdicts["port"] == verdicts["jax"]
    decision = verdicts["port"][0]
    assert decision["requested_by"] == [1] and decision["stop_step"] > 12
    assert json.loads(port_kv.store["t/agree/ctl/decision"]) == json.loads(jax_kv.store["t/agree/ctl/decision"])
    assert json.loads(port_kv.store["t/agree/ctl/req/r1"]) == json.loads(jax_kv.store["t/agree/ctl/req/r1"])
    # the gang agreed: each package's process reports preempted, its own signal unseen
    assert port_signals.preemption_requested() and jax_signals.preemption_requested()
    assert not port_signals.local_preemption_requested() and not jax_signals.local_preemption_requested()


def test_the_leaders_own_signal_decides(pair):
    clock, jax_kv, port_kv = pair
    coords, _ = _both(0, 2, "t/lead", heartbeat_enabled=False, poll_interval=0.01)
    for coord in coords.values():
        coord.step(0)
    clock.now += 0.5
    for coord in coords.values():
        coord.step(8, local_preempt=True)
    assert coords["port"].decision() == coords["jax"].decision() is not None
    assert port_kv.store["t/lead/ctl/decision"] == jax_kv.store["t/lead/ctl/decision"]


def test_heartbeat_silence_declares_the_peer_dead(pair):
    """The peer beats three times, then falls silent: both declare it dead at
    the same tick, with the same abort record and health event."""
    clock, jax_kv, port_kv = pair
    coords, events = _both(0, 2, "t/hb", heartbeat_interval=0.05, heartbeat_timeout=0.3, startup_timeout=5.0)

    def tick(n):
        if n < 6 and n % 2 == 0:
            _write_both(jax_kv, port_kv, "t/hb/hb/r1", json.dumps({"n": n // 2 + 1}))

    _run_monitor(coords, clock, 20, tick)
    abort = coords["port"].abort_info()
    assert abort == coords["jax"].abort_info() and abort["rank"] == 1 and abort["observed_by"] == 0
    assert events["port"] == events["jax"] and [e for e, _ in events["port"]] == ["health"]
    assert events["port"][0][1]["status"] == "rank_dead" and events["port"][0][1]["silent_seconds"] >= 0.3
    assert json.loads(port_kv.store["t/hb/ctl/abort"]) == json.loads(jax_kv.store["t/hb/ctl/abort"])
    for coord, error in ((coords["port"], port_dist.RankFailureError), (coords["jax"], jax_dist.RankFailureError)):
        with pytest.raises(error, match="rank 1 of this 2-process run was declared dead"):
            coord.check_abort()


def test_the_startup_timeout_covers_a_peer_that_never_started(pair):
    clock, _, _ = pair
    coords, events = _both(0, 2, "t/hb2", heartbeat_interval=0.05, heartbeat_timeout=0.2, startup_timeout=0.3)
    _run_monitor(coords, clock, 12)
    assert coords["port"].abort_info() == coords["jax"].abort_info() is not None
    assert coords["port"].abort_info()["rank"] == 1
    assert events["port"] == events["jax"]


def test_a_vanished_heartbeat_key_takes_the_heartbeat_timeout(pair):
    """A peer whose key disappears after it beat (a dying store) is declared
    dead within heartbeat.timeout, not the far larger startup timeout."""
    clock, jax_kv, port_kv = pair
    coords, events = _both(0, 2, "t/hb3", heartbeat_interval=0.05, heartbeat_timeout=0.3, startup_timeout=60.0)

    def tick(n):
        if n == 0:
            _write_both(jax_kv, port_kv, "t/hb3/hb/r1", json.dumps({"n": 1}))
        if n == 2:
            jax_kv.store.pop("t/hb3/hb/r1", None)
            port_kv.store.pop("t/hb3/hb/r1", None)

    _run_monitor(coords, clock, 12, tick)
    abort = coords["port"].abort_info()
    assert abort == coords["jax"].abort_info() and abort["rank"] == 1 and abort["silent_seconds"] < 1.0
    assert events["port"] == events["jax"]


def test_an_abort_published_by_a_peer_is_consumed(pair):
    """A rank that did not see the death itself aborts too: the verdict rides
    the control plane, into the same RankFailureError and health event."""
    clock, jax_kv, port_kv = pair
    coords, events = _both(0, 3, "t/ab", heartbeat_enabled=False, poll_interval=0.01)
    _write_both(jax_kv, port_kv, "t/ab/ctl/abort",
                json.dumps({"rank": 2, "reason": "heartbeat timeout", "observed_by": 1}))
    clock.now += 0.05
    messages = {}
    for name, error in (("jax", jax_dist.RankFailureError), ("port", port_dist.RankFailureError)):
        coords[name].step(4)
        with pytest.raises(error, match="rank 2") as info:
            coords[name].check_abort()
        messages[name] = str(info.value)
    assert messages["port"] == messages["jax"]
    assert coords["port"].abort_info() == coords["jax"].abort_info()
    assert events["port"] == events["jax"] and events["port"][0][1]["observed_by"] == 1
