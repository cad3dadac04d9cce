"""The resume and crash paths of the decoupled entries as two processes on
the CPU (``python -m sheeprl_tpu_torch`` launched as a player, rank 0, and a
learner, rank 1, each single-threaded; ``test_torch_decoupled_processes.py``
holds the runs themselves).

- a checkpoint written by the JAX package's own two-process ``ppo_decoupled``
  run (``tests/test_parallel/_decoupled_worker.py``) resumes in the port's
  two-process run and in its thread mode, to the same checkpoint;
- a learner whose ``checkpoint.resume_from`` cannot load ends the player in
  seconds, with ``ChannelPeerError`` naming the learner's reason, not after
  the channel's timeout (30 minutes by default);
- a player that fails before its first round releases the learner, and both
  exit.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys

import pytest

from test_torch_helpers import REPO_ROOT, SUBPROCESS_ENV, assert_checkpoints_equal, two_process_run
from test_torch_ppo_decoupled import TINY as PPO_TINY


@pytest.mark.timeout(240)
def test_a_jax_two_process_checkpoint_resumes_in_both_modes(tmp_path):
    """The JAX package's player and learner processes (a dry run of 2 envs x
    8 steps, the checkpoint after its one round) write the checkpoint; the
    port resumes it for two more rounds as two processes and as a thread,
    and both write the same checkpoint."""
    from sheeprl_tpu_torch.cli import run

    worker = REPO_ROOT / "tests" / "test_parallel" / "_decoupled_worker.py"
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(SUBPROCESS_ENV, PYTHONPATH=str(REPO_ROOT))
    with socket.create_server(("127.0.0.1", 0)) as sock:  # the JAX coordinator takes an address
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, str(worker), coordinator, "2", str(i), str(jax_dir / f"out{i}.json")],
                              cwd=str(jax_dir), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=150)[0].decode() for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("the JAX two-process run did not end:\n" + "\n".join(p.communicate()[0].decode()[-2000:]
                                                                                   for p in procs))
    assert [p.returncode for p in procs] == [0, 0], "\n".join(log[-3000:] for log in logs)
    (ckpt,) = jax_dir.glob("logs/runs/decoupled2p/ppo/*/checkpoint/ckpt_16_0.ckpt")
    args = ["exp=ppo_decoupled", f"checkpoint.resume_from={ckpt}", "fabric.accelerator=cpu", "dry_run=False",
            "algo.total_steps=48", "root_dir=res", "run_name=run"]
    threaded = run(args)
    assert threaded["train_phases"] == 2 and threaded["policy_steps"] == 48
    rcs, logs, _ = two_process_run(args, tmp_path / "two")
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    name = "ckpt_48_0.ckpt"
    assert_checkpoints_equal(tmp_path / "two" / threaded["log_dir"] / "checkpoint" / name,
                             tmp_path / threaded["log_dir"] / "checkpoint" / name)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("failing", ["learner", "player"])
def test_a_role_that_fails_ends_both_processes(failing, tmp_path):
    """The learner: its copy of the run to resume holds a truncated
    checkpoint (the player's is whole). The player: a buffer smaller than a
    rollout fails its loop after the handshake, before the first round."""
    from sheeprl_tpu_torch.cli import run

    args = PPO_TINY + ["algo.total_steps=48"]
    if failing == "learner":
        first = run(args)
        run_dir = tmp_path / first["log_dir"]
        broken = tmp_path / "learner_host" / "version_0"
        shutil.copytree(run_dir, broken, ignore=shutil.ignore_patterns("*.ckpt", "*.sha256"))
        ckpt = run_dir / "checkpoint" / "ckpt_16_0.ckpt"
        (broken / "checkpoint" / ckpt.name).write_bytes(ckpt.read_bytes()[:100])
        rcs, logs, seconds = two_process_run(args, tmp_path / "two", [f"checkpoint.resume_from={ckpt}"],
                                             [f"checkpoint.resume_from={broken / 'checkpoint' / ckpt.name}"])
        assert rcs[0] != 0 and rcs[1] != 0 and seconds < 60
        assert "ChannelPeerError: the learner process failed: rank 1: checkpoint resume load failed" in logs[0]
    else:
        rcs, logs, seconds = two_process_run(args, tmp_path / "two", ["buffer.size=1"])
        assert rcs == [1, 0] and seconds < 60, logs
        assert "The size of the buffer (1) cannot be lower than the rollout steps" in logs[0]
        assert "Traceback" not in logs[1]
