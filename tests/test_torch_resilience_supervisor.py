"""The in-process supervisor and the progress watchdog, held to the JAX
package's.

Tiny SAC and Dreamer-V3 runs on the CPU, each under
``resilience.supervisor.enabled`` with a ``crash`` and a ``sigterm`` fault:
the port's run resumes from the newest valid checkpoint and completes to
``total_steps``, and the run base's ``telemetry.jsonl`` holds the same
sequence of event names and reasons as the JAX supervisor's on the same
config (times and paths aside).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from test_torch_helpers import SAC_SMALL

SAC_RUN = [*SAC_SMALL, "env.sync_env=True", "algo.learning_starts=16", "checkpoint.every=32", "env.max_episode_steps=24",
           "algo.total_steps=96", "metric.log_level=0", "algo.run_test=False"]
DV3_RUN = [
    "exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "fabric.accelerator=cpu", "env.capture_video=False",
    "env.sync_env=True",
    "env.num_envs=2", "env.screen_size=16", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=2",
    "algo.learning_starts=4", "algo.replay_ratio=0.5", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "buffer.size=64", "buffer.memmap=False",
    "checkpoint.every=4", "algo.total_steps=16", "metric.log_level=0", "algo.run_test=False",
]
RUNS = {"sac": (SAC_RUN, 40), "dv3": (DV3_RUN, 8)}


@pytest.fixture(autouse=True)
def _clean():
    from sheeprl_tpu.resilience import faults as jax_faults
    from sheeprl_tpu.resilience import signals as jax_signals
    from sheeprl_tpu_torch.resilience import faults, signals

    for module in (jax_faults, faults):
        module.reset_faults()
    for module in (jax_signals, signals):
        module.reset_preemption()
    yield
    for module in (jax_faults, faults):
        module.reset_faults()
    for module in (jax_signals, signals):
        module.reset_preemption()


def _events(run_base: Path):
    """(event, reason or status or kind, attempt, resume checkpoint's name)."""
    out = []
    for line in (run_base / "telemetry.jsonl").read_text().splitlines():
        e = json.loads(line)
        resume = e.get("resume_from")
        out.append((e["event"], e.get("reason") or e.get("status") or e.get("kind"), e.get("attempt"),
                    Path(resume).name if resume else None))
    return out


@pytest.mark.parametrize("algo,fault", [("sac", "crash"), ("sac", "sigterm"), ("dv3", "crash"), ("dv3", "sigterm")])
def test_a_supervised_run_recovers_as_the_jax_supervisor_does(algo, fault, tmp_path, monkeypatch):
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.resilience.discovery import find_latest_checkpoint

    monkeypatch.chdir(tmp_path)
    args, at = RUNS[algo]
    args = args + ["resilience.supervisor.enabled=true", "resilience.supervisor.backoff=0.05",
                   f"resilience.fault.kind={fault}", f"resilience.fault.at_policy_step={at}", "run_name=r"]
    jax_run(args + ["root_dir=jax"])
    summary = run(args + ["root_dir=port"])
    total = int([a for a in args if a.startswith("algo.total_steps=")][0].split("=")[1])
    assert summary["policy_steps"] == total and not summary["preempted"]
    assert Path(summary["checkpoint"]).name == f"ckpt_{total}_0.ckpt"
    ours, theirs = _events(Path("logs/runs/port/r")), _events(Path("logs/runs/jax/r"))
    assert ours == theirs
    names = [e for e, *_ in ours]
    assert names[names.index("fault"):names.index("restart")].count("fault") == 1
    restart = ours[names.index("restart")]
    assert restart[1] == ("crash" if fault == "crash" else "preempt") and restart[3] is not None
    assert names[-1] == "supervisor" and ours[-1][1] == "completed"
    # the restart resumed from the first attempt's newest valid checkpoint
    first = Path("logs/runs/port/r/version_0")
    assert restart[3] == Path(find_latest_checkpoint(str(first))).name


def test_the_watchdog_reports_a_stall_as_the_jax_one_does_and_aborts_the_main_thread():
    """A stall: both watchdogs emit one ``health`` event with the same fields
    (the stall's seconds and the stacks' text aside); with ``abort`` the port's
    raises ``WatchdogError`` in the main thread, and a pause (a checkpoint
    write) suppresses detection."""
    from sheeprl_tpu.resilience.watchdog import ProgressWatchdog as JaxWatchdog
    from sheeprl_tpu_torch.resilience.watchdog import ProgressWatchdog, WatchdogError, watchdogs_paused

    events = {"jax": [], "port": []}
    for name, cls in (("jax", JaxWatchdog), ("port", ProgressWatchdog)):
        dog = cls(0.2, lambda ev, name=name, **f: events[name].append((ev, f)), _exit=lambda code: None).start()
        dog.feed(7)
        time.sleep(0.6)
        dog.stop()
    for name in events:
        assert [e for e, _ in events[name]] == ["health"]
    ours, theirs = events["port"][0][1], events["jax"][0][1]
    assert sorted(ours) == sorted(theirs)
    for key in ("step", "status", "timeout", "abort"):
        assert ours[key] == theirs[key]
    assert ours["status"] == "stalled" and "MainThread" in ours["stacks"]

    exits = []
    dog = ProgressWatchdog(0.2, lambda *a, **k: None, abort=True, grace=5.0, _exit=exits.append)
    with watchdogs_paused():
        dog.start()
    with watchdogs_paused():
        time.sleep(0.5)  # paused: no stall
    assert dog.stall_count == 0
    dog.feed(1)
    with pytest.raises(WatchdogError):
        for _ in range(300):
            time.sleep(0.01)
    dog.stop()
    assert exits == []


def test_the_cli_maps_a_peers_death_and_a_watchdog_abort_to_their_exit_codes(monkeypatch, tmp_path):
    """``RankFailureError`` reaching the CLI exits 77, a watchdog's abort 76;
    either way the CLI stops every watchdog and closes the coordinator."""
    import sheeprl_tpu_torch.cli as cli
    from sheeprl_tpu_torch.resilience import distributed, signals, watchdog

    monkeypatch.chdir(tmp_path)
    for error, code in ((distributed.RankFailureError("rank 1 of this 2-process run was declared dead"),
                         signals.RANK_FAILED_EXIT_CODE),
                        (watchdog.WatchdogError(), signals.WATCHDOG_EXIT_CODE)):
        dog = watchdog.ProgressWatchdog(30.0, lambda *a, **k: None).start()
        coord = distributed.DistributedCoordinator(0, 2, heartbeat_enabled=False, namespace="t/cli")

        def fail(cfg, error=error):
            raise error

        monkeypatch.setattr(cli, "run_algorithm", fail)
        with pytest.raises(SystemExit) as info:
            cli.run(SAC_RUN + ["root_dir=t", "run_name=r"])
        assert info.value.code == code
        assert not watchdog._active and dog._thread is None
        assert distributed.active_coordinator() is None and coord._stop.is_set()
