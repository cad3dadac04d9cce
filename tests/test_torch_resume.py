"""Two launch and resume faults of the port, repaired, at the tiny Dreamer-V3
widths on the CPU:

- the default launch (``env.capture_video`` true, the config's default) used
  to raise; it now warns once and records nothing, as the JAX package does
  when it cannot record;
- a memory-mapped replay buffer checkpointed with ``buffer.checkpoint=True``
  (the exp's defaults) could not be resumed: the live buffer's
  ``MemmapArray.__del__`` deleted the files the pickled buffer refers to. The
  JAX package has the same fault (``sheeprl_tpu/utils/memmap.py``'s
  ``__del__``), so these tests run the port alone. Checkpoint rotation now
  deletes a memmap file only when no kept checkpoint lists it.
"""

from __future__ import annotations

import gc
import os

import numpy as np
import pytest

TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=discrete_dummy",
    "fabric.accelerator=cpu",
    "env.num_envs=2",
    "env.screen_size=16",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=2",
    "algo.learning_starts=4",
    "algo.replay_ratio=0.5",
    "algo.horizon=3",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "buffer.size=64",
    "checkpoint.every=4",
    "root_dir=tiny",
    "run_name=run",
]


def test_default_launch_warns_about_video_and_runs(tmp_path, capsys):
    """``dry_run=True`` at the exp's sequence length, with no
    ``env.capture_video`` override: one warning, then training, a checkpoint,
    a test episode; ``evaluation`` of the checkpoint the same way."""
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils import env as env_module

    args = [a for a in TINY if not a.startswith("algo.per_rank_sequence_length")] + ["dry_run=True"]
    env_module._warn_no_video_recorder.cache_clear()
    with pytest.warns(UserWarning, match="no video recorder") as record:
        summary = run(args)
    assert sum("no video recorder" in str(w.message) for w in record) == 1
    assert summary["gradient_steps"] >= 1 and summary["test_reward"] is not None
    assert not list((tmp_path / summary["log_dir"]).rglob("*.mp4"))
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={tmp_path / summary['checkpoint']}", "fabric.accelerator=cpu"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out


def test_memmap_buffer_checkpoint_resumes_and_trains(tmp_path):
    """Train to 12 policy steps with the buffer in memmap files and in the
    checkpoint; once the first run's buffer is gone, resume from
    ``ckpt_12_0.ckpt``: the resumed run reads the files, adds rows and trains."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    args = TINY + ["buffer.memmap=True", "buffer.checkpoint=True", "env.capture_video=False"]
    first = run(args + ["algo.total_steps=12"])
    ckpt = tmp_path / first["checkpoint"]
    assert ckpt.name == "ckpt_12_0.ckpt" and first["gradient_steps"] >= 1
    gc.collect()  # the first run's buffer is gone: its files must not be
    listed = (ckpt.parent / (ckpt.name + ".memmap")).read_text().split()
    assert listed and all(os.path.isfile(p) for p in listed)
    rows_before = [b._pos for b in load_checkpoint(str(ckpt))["rb"].buffer]

    resumed = run(args + ["algo.total_steps=24", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 24
    assert resumed["gradient_steps"] >= 1
    rb = load_checkpoint(str(tmp_path / resumed["checkpoint"]))["rb"]
    assert [b._pos for b in rb.buffer] > rows_before
    assert all(b.is_memmap for b in rb.buffer)
    assert np.isfinite(np.asarray(rb.buffer[0]["state"])).all()


def test_rotation_deletes_only_files_no_kept_checkpoint_lists(tmp_path):
    """keep_last=2 over three checkpoints of buffers in three directories,
    the second and third sharing one file: the first checkpoint goes with its
    sidecars and its own file; the files the kept ones list stay."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.utils.checkpoint import save_run_checkpoint

    folder = tmp_path / "checkpoint"
    row = {
        "terminated": np.zeros((1, 1, 1), np.float32),
        "truncated": np.zeros((1, 1, 1), np.float32),
        "state": np.ones((1, 1, 3), np.float32),
    }
    files = []
    for i, name in enumerate(("a", "b", "b")):
        rb = EnvIndependentReplayBuffer(
            4, n_envs=1, obs_keys=("state",), memmap=True, memmap_dir=tmp_path / name, buffer_cls=SequentialReplayBuffer
        )
        rb.add(row)
        save_run_checkpoint(str(folder / f"ckpt_{i}_0.ckpt"), {"iter_num": i}, replay_buffer=rb, keep_last=2)
        os.utime(folder / f"ckpt_{i}_0.ckpt", (i + 1, i + 1))  # distinct ages
        files.append(sorted(str(a.filename) for b in rb.buffer for a in b.buffer.values()))
        del rb
        gc.collect()  # a checkpointed buffer leaves its files behind
    assert sorted(os.listdir(folder)) == sorted(
        f"ckpt_{i}_0.ckpt{s}" for i in (1, 2) for s in ("", ".sha256", ".memmap")
    )
    assert not any(os.path.exists(f) for f in files[0])
    assert all(os.path.isfile(f) for f in files[1] + files[2])
