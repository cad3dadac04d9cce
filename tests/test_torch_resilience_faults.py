"""The port's fault plane held to the JAX one (``resilience/faults.py``):
``lr_spike`` on the same parameters, rank targeting, ``stale_heartbeat``
silencing the heartbeat writer, and the CLI's resilience checks, which raise
where the JAX CLI's do (and refuse by name what the port does not run).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from sheeprl_tpu.resilience import distributed as jax_dist
from sheeprl_tpu.resilience import faults as jax_faults
from sheeprl_tpu_torch.resilience import distributed as port_dist
from sheeprl_tpu_torch.resilience import faults as port_faults
from test_torch_helpers import jax_sac, numpy_tree, port_sac


@pytest.fixture(autouse=True)
def _clean():
    jax_faults.reset_faults()
    port_faults.reset_faults()
    yield
    jax_faults.reset_faults()
    port_faults.reset_faults()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_lr_spike_scales_the_trainers_parameters_as_the_jax_fault_does():
    """One armed spike, factor 32, on the same SAC parameters: the port's
    agent, read back in the Flax layout, equals the JAX tree within 1e-6 (a
    float32 multiply on both sides), and a second round is untouched."""
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax

    _, _, params, _ = jax_sac()
    agent, _ = port_sac(params=params)
    for faults in (jax_faults, port_faults):
        faults.FaultPlan("lr_spike", 4, factor=32.0).maybe_fire(4, lambda *a, **k: None)
    theirs = numpy_tree(jax_faults.apply_armed_learn_fault(params))
    assert port_faults.apply_armed_learn_fault(agent)
    ours = dict(_leaves(sac_to_flax(agent)))
    spiked = dict(_leaves(theirs))
    assert sorted(ours) == sorted(spiked)
    for key, value in spiked.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=1e-6, err_msg=key)
    before = dict(_leaves(params))
    assert any(np.abs(v).max() > 0 and not np.allclose(spiked[k], v) for k, v in before.items())
    # one-shot: consumed by the round it hit
    assert jax_faults.consume_learn_fault() is None and not port_faults.apply_armed_learn_fault(agent)


def test_rank_targeting():
    """Each kind of training, each target and each process: the same plan or
    none (the default target is rank 0, the driving rank)."""
    for kind, rank_cfg in ((k, r) for k in port_faults.TRAINING_KINDS for r in (None, 0, 1, 2)):
        cfg = {"fault": {"kind": kind, "at_policy_step": 10, **({"rank": rank_cfg} if rank_cfg is not None else {})}}
        for process_rank in (None, 0, 1, 2):
            theirs = jax_faults.build_fault_plan(cfg, process_rank=process_rank)
            ours = port_faults.build_fault_plan(cfg, process_rank=process_rank)
            assert (ours is None) == (theirs is None), (rank_cfg, process_rank)
            if ours is not None:
                assert (ours.kind, ours.at, ours.rank, ours.factor) == (theirs.kind, theirs.at, theirs.rank,
                                                                        theirs.factor)


def test_stale_heartbeat_silences_the_writer(monkeypatch):
    """The heartbeat loop over the same scripted ticks: both beat until the
    fault fires, then neither writes again (a zombie does not recover), and
    reset_faults clears it."""
    from test_torch_resilience_coordinator import JaxFakeKV, PortFakeKV, ScriptedStop

    class Clock:
        now = 0.0

    clock = Clock()
    jax_kv, port_kv = JaxFakeKV(), PortFakeKV()
    monkeypatch.setattr(jax_dist, "_kv", lambda: jax_kv)
    monkeypatch.setattr(port_dist, "_kv", lambda: port_kv)
    beats = {}
    for name, mod, faults, kv in (("jax", jax_dist, jax_faults, jax_kv), ("port", port_dist, port_faults, port_kv)):
        coord = mod.DistributedCoordinator(0, 2, namespace="t/stale", heartbeat_interval=0.05)
        plan = faults.build_fault_plan({"fault": {"kind": "stale_heartbeat", "at_policy_step": 4}}, process_rank=0)

        def tick(n, plan=plan, kv=kv, name=name):
            if n == 3:
                plan.maybe_fire(4, lambda *a, **k: None)
            beats.setdefault(name, []).append(json.loads(kv.store.get("t/stale/hb/r0", "{}")).get("n"))

        coord._stop = ScriptedStop(clock, 8, tick)
        coord._heartbeat_loop()
        assert faults.heartbeat_stalled()
        coord._stop = ScriptedStop(clock, 0)
        coord.close()
    assert beats["port"] == beats["jax"] == [None, 1, 2, 3, 3, 3, 3, 3]
    port_faults.reset_faults()
    assert not port_faults.heartbeat_stalled()


def test_the_cli_checks_the_resilience_group_as_the_jax_cli_does():
    """Values the JAX CLI rejects, the port's rejects with the same message;
    the fault kinds of training run, ``env_step`` is refused by name in
    training, and a gang runs the decoupled algorithms only, as two processes."""
    from sheeprl_tpu.cli import check_configs as jax_check
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    base = ["exp=sac_decoupled", "env.id=Pendulum-v1"]
    for bad in (["resilience.fault.kind=crash", "resilience.fault.at_policy_step=-1"],
                ["resilience.fault.kind=crash", "resilience.fault.rank=-1"],
                ["resilience.supervisor.max_restarts=-1"],
                ["resilience.watchdog.enabled=true", "resilience.watchdog.timeout=0"],
                ["resilience.distributed.gang.processes=1"],
                ["resilience.distributed.gang.processes=2", "resilience.fault.kind=kill_rank",
                 "resilience.fault.rank=2"],
                ["resilience.distributed.heartbeat.interval=5", "resilience.distributed.heartbeat.timeout=4"],
                ["resilience.fault.kind=no_such_fault"]):
        with pytest.raises(ValueError) as theirs:
            jax_check(jax_compose(base + bad))
        with pytest.raises(ValueError) as ours:
            check_configs(compose(base + bad))
        assert str(ours.value) == str(theirs.value), bad
    for kind in port_faults.TRAINING_KINDS:
        for exp in ("sac", "ppo", "dreamer_v3", "sac_decoupled"):
            assert callable(check_configs(compose([f"exp={exp}", f"resilience.fault.kind={kind}",
                                                   "resilience.supervisor.enabled=true",
                                                   "resilience.watchdog.enabled=true"])))
    with pytest.raises(NotImplementedError, match="resilience.fault.kind=env_step in training: .* RestartOnException"):
        check_configs(compose(["exp=sac", "resilience.fault.kind=env_step"]))
    for exp in ("sac_decoupled", "ppo_decoupled", "dreamer_v3_decoupled"):
        assert callable(check_configs(compose([f"exp={exp}", "resilience.distributed.gang.processes=2"])))
    for exp in ("sac", "ppo", "dreamer_v3"):
        with pytest.raises(NotImplementedError, match=f"gang.processes >= 2 of {exp}: .* coupled algorithm"):
            check_configs(compose([f"exp={exp}", "resilience.distributed.gang.processes=2"]))
    with pytest.raises(NotImplementedError, match="learner slice"):
        check_configs(compose(["exp=sac_decoupled", "resilience.distributed.gang.processes=3"]))
