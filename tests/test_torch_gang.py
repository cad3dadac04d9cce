"""Two real CPU gangs of ``exp=sac_decoupled`` under the port's
``supervise_gang`` (``resilience.distributed.gang.processes=2``): the
supervisor spawns a player (rank 0) and a learner (rank 1), with heartbeats
every 0.2 s, a 4 s heartbeat timeout and a 120 s startup timeout, and each
gang runs under a hard timeout that kills every child
(``test_torch_helpers.py::gang_run``). The JAX package's smokes of the same
two faults are ``tests/test_resilience/test_gang_smoke.py``.

- ``kill_rank`` on the learner: the player exits 77 within the heartbeat
  timeout + 10 s of the kill, and the gang restarts from the newest
  manifest-complete checkpoint and completes.
- ``sigterm`` to the learner only: the player's coordinator turns the
  learner's request into one stop step, both exit 75 there, and the gang
  restarts (``restart_on_preempt``) and completes.
"""

from __future__ import annotations

import json
from pathlib import Path

from sheeprl_tpu.resilience import discovery as jax_discovery
from sheeprl_tpu_torch.resilience import discovery
from test_torch_helpers import SAC_SMALL, gang_run

HEARTBEAT_TIMEOUT = 4.0
TOTAL = 256
BASE = [
    "exp=sac_decoupled", *SAC_SMALL[1:], "algo.learning_starts=16", "checkpoint.every=32", "env.max_episode_steps=24",
    f"algo.total_steps={TOTAL}", "metric.log_level=0", "algo.run_test=False", "root_dir=gang",
    "resilience.distributed.gang.processes=2", "resilience.distributed.gang.grace=15",
    "resilience.supervisor.backoff=0.05", "resilience.distributed.heartbeat.interval=0.2",
    f"resilience.distributed.heartbeat.timeout={HEARTBEAT_TIMEOUT:g}",
    "resilience.distributed.heartbeat.startup_timeout=120", "resilience.distributed.channel.timeout=90",
    "resilience.fault.rank=1", "resilience.fault.at_policy_step=100",
]


def _tails(run: Path) -> str:
    return "\n".join(f"--- {p.name}:\n{p.read_text()[-2000:]}" for p in sorted((run / "gang").glob("*.log")))


def _events(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()] if path.is_file() else []


def _subsequence(events, wanted):
    """The events matching each of ``wanted`` (predicates), in order."""
    found, it = [], iter(events)
    for want in wanted:
        for event in it:
            if want(event):
                found.append(event)
                break
        else:
            raise AssertionError(f"missing event #{len(found)} in {[(e['event'], e.get('status')) for e in events]}")
    return found


def _completed(run: Path):
    """The last attempt reached total_steps with a committed manifest."""
    last = run / "version_1" / "checkpoint" / f"ckpt_{TOTAL}_0.ckpt"
    manifest = discovery.read_manifest(str(last))
    assert manifest is not None and manifest["complete"] and manifest["ranks_committed"] == [0]
    assert jax_discovery.find_latest_checkpoint(str(run)) == discovery.find_latest_checkpoint(str(run)) == str(last)


def test_a_killed_learner_ends_the_player_with_77_and_the_gang_restarts_from_its_newest_complete_set(tmp_path):
    rc, seconds = gang_run(BASE + ["run_name=kill", "resilience.fault.kind=kill_rank"], tmp_path, "run_name=kill")
    run = tmp_path / "logs" / "runs" / "gang" / "kill"
    assert rc == 0, _tails(run)
    events = _events(run / "telemetry.jsonl")
    spawn0, dead, exit0, restart, spawn1, exit1 = _subsequence(events, [
        lambda e: e["event"] == "gang" and e["status"] == "spawn" and e["attempt"] == 0,
        lambda e: e["event"] == "health" and e["status"] == "rank_dead" and e["rank"] == 1,
        lambda e: e["event"] == "gang" and e["status"] == "attempt_exit",
        lambda e: e["event"] == "restart",
        lambda e: e["event"] == "gang" and e["status"] == "spawn" and e["attempt"] == 1,
        lambda e: e["event"] == "gang" and e["status"] == "attempt_exit" and e["attempt"] == 1,
    ])
    assert exit0["outcome"] == "crash" and exit0["exit_codes"] == {"0": 77, "1": -9}
    assert exit0["dead_ranks"] == {"1": -9} and restart["reason"] == "crash"
    # the player's 77 came within the heartbeat timeout + 10 s of the kill
    kill = [e for e in _events(run / "telemetry.rank1.jsonl") if e["event"] == "fault"][0]
    assert kill["kind"] == "kill_rank" and exit0["time"] - kill["time"] <= HEARTBEAT_TIMEOUT + 10.0
    # the restart resumed from attempt 0's newest manifest-complete checkpoint
    first = run / "version_0"
    newest = discovery.find_latest_checkpoint(str(first))
    assert str(tmp_path / restart["resume_from"]) == newest == jax_discovery.find_latest_checkpoint(str(first))
    assert discovery.read_manifest(newest)["complete"]
    assert exit1["outcome"] == "completed" and exit1["exit_codes"] == {"0": 0, "1": 0}
    _completed(run)
    print(f"[gang kill_rank] {seconds:.1f} s, kill to teardown {exit0['time'] - kill['time']:.1f} s")


def test_a_sigterm_to_the_learner_stops_both_at_one_agreed_step_and_the_gang_restarts(tmp_path):
    rc, seconds = gang_run(BASE + ["run_name=term", "resilience.fault.kind=sigterm"], tmp_path, "run_name=term")
    run = tmp_path / "logs" / "runs" / "gang" / "term"
    assert rc == 0, _tails(run)
    events = _events(run / "telemetry.jsonl")
    preempt, emergency, exit0, restart, exit1 = _subsequence(events, [
        lambda e: e["event"] == "preempt" and e.get("requested_by") == [1],
        lambda e: e["event"] == "checkpoint" and e["reason"] == "preempt",
        lambda e: e["event"] == "gang" and e["status"] == "attempt_exit",
        lambda e: e["event"] == "restart",
        lambda e: e["event"] == "gang" and e["status"] == "attempt_exit" and e["attempt"] == 1,
    ])
    learner = _events(run / "telemetry.rank1.jsonl")
    assert [e["event"] for e in learner] == ["fault", "preempt"] and learner[0]["kind"] == "sigterm"
    # the player took the emergency checkpoint at the agreed stop step
    assert emergency["step"] < preempt["stop_step"] <= emergency["step"] + 2
    assert exit0["outcome"] == "preempt" and exit0["exit_codes"] == {"0": 75, "1": 75}
    assert restart["reason"] == "preempt" and Path(restart["resume_from"]).name == f"ckpt_{emergency['step']}_0.ckpt"
    assert exit1["outcome"] == "completed"
    _completed(run)
    print(f"[gang sigterm] {seconds:.1f} s")
