"""The port's ``EpisodeBuffer`` against the JAX package's, and memory-mapped
replay across checkpoints, on the CPU.

- the same adds (two envs, episodes cut by ``terminated`` and by
  ``truncated``, a buffer small enough to evict) leave the same episodes,
  and two buffers seeded alike sample the same sequences draw for draw, with
  and without ``prioritize_ends``, with and without the next observations;
- a memory-mapped buffer's episodes ride a checkpoint: the sidecar lists their
  files, an episode the checkpoint refers to keeps its files when it is
  evicted (one it does not is deleted with its folder), and the checkpoint
  loads the episodes back;
- Plan2Explore's memmap buffer from exploration to finetuning and back
  (``buffer.load_from_exploration``, ``checkpoint.keep_last=1``): the
  exploration checkpoint keeps its files through the finetuning run, which
  reads them, and the exploration run resumes with its buffer. The JAX
  package deletes its files when its exploration run ends, so its checkpoint
  refers to files that are gone.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest


def _episodes(rng, n_envs: int, steps: int):
    """``steps`` rows for ``n_envs`` envs: ends drawn with probability 1/5,
    half of them truncations."""
    for _ in range(steps):
        end = rng.uniform(size=(1, n_envs, 1)) < 0.2
        trunc = end & (rng.uniform(size=(1, n_envs, 1)) < 0.5)
        yield {
            "obs": rng.standard_normal((1, n_envs, 3)).astype(np.float32),
            "actions": rng.standard_normal((1, n_envs, 2)).astype(np.float32),
            "terminated": (end & ~trunc).astype(np.float32),
            "truncated": trunc.astype(np.float32),
        }


@pytest.mark.parametrize("prioritize_ends", [False, True], ids=["uniform", "prioritize-ends"])
def test_adds_evictions_and_samples_match_the_jax_buffer(prioritize_ends):
    from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    kw = dict(minimum_episode_length=1, n_envs=2, obs_keys=("obs",), prioritize_ends=prioritize_ends)
    ours, theirs = EpisodeBuffer(24, **kw), JaxEpisodeBuffer(24, **kw)
    ours.seed(3)
    theirs.seed(3)
    rng = np.random.default_rng(0)
    for i, data in enumerate(_episodes(rng, 2, 80)):
        if i % 7 == 3:  # a reset row for env 1 alone, as the loops add them
            sub = {k: v[:, 1:] for k, v in data.items()}
            ours.add(sub, [1], validate_args=True)
            theirs.add(sub, [1], validate_args=True)
        ours.add(data)
        theirs.add(data)
    assert len(ours) == len(theirs) <= 24 and ours._cum_lengths == theirs._cum_lengths
    assert len(ours.buffer) == len(theirs.buffer) >= 3
    for a, b in zip(ours.buffer, theirs.buffer):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for sample_next_obs in (False, True, False):
        kwargs = dict(batch_size=5, n_samples=2, sequence_length=2, sample_next_obs=sample_next_obs)
        mine, ref = ours.sample(**kwargs), theirs.sample(**kwargs)
        assert sorted(mine) == sorted(ref) and mine["obs"].shape == (2, 2, 5, 3)
        for k in ref:
            np.testing.assert_array_equal(mine[k], ref[k])


def test_memmap_episodes_ride_a_checkpoint(tmp_path):
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, load_run_buffer, save_run_checkpoint

    rb = EpisodeBuffer(12, minimum_episode_length=1, obs_keys=("obs",), memmap=True, memmap_dir=tmp_path / "mm")
    rb.seed(1)

    def add_episode(length: int, value: float):
        data = {"obs": np.full((length, 1, 3), value, np.float32), "terminated": np.zeros((length, 1, 1), np.float32),
                "truncated": np.zeros((length, 1, 1), np.float32)}
        data["terminated"][-1] = 1.0
        rb.add(data)

    add_episode(4, 1.0)
    add_episode(4, 2.0)
    ckpt = str(tmp_path / "ckpt" / "ckpt_8_0.ckpt")
    save_run_checkpoint(ckpt, {"iter_num": 8}, replay_buffer=rb)
    listed = open(ckpt + ".memmap").read().split()
    assert len(listed) == 2 * 3 and all(os.path.isfile(f) for f in listed)
    add_episode(4, 3.0)
    add_episode(6, 4.0)  # evicts the two checkpointed episodes: their files stay
    assert [float(ep["obs"][0, 0]) for ep in rb.buffer] == [3.0, 4.0]
    assert all(os.path.isfile(f) for f in listed)
    third = os.path.dirname(rb.buffer[0]["obs"].filename)
    add_episode(6, 5.0)  # evicts the third, which no checkpoint lists: its folder goes
    assert not os.path.exists(third)
    restored = load_run_buffer(load_checkpoint(ckpt))
    assert isinstance(restored, EpisodeBuffer) and restored._cum_lengths == [4, 8]
    assert [float(np.asarray(ep["obs"])[0, 0]) for ep in restored.buffer] == [1.0, 2.0]
    assert restored.sample(batch_size=3, sequence_length=2)["obs"].shape == (1, 2, 3, 3)


def test_memmap_buffer_from_exploration_to_finetuning_and_back(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_dv3_train import SCREEN
    from test_torch_helpers import p2e_overrides

    small = [o for o in p2e_overrides() if not o.startswith(("exp=", "metric."))]
    common = [*small, "env.capture_video=False", "env.num_envs=2", f"env.screen_size={SCREEN}",
              "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=2", "algo.replay_ratio=0.5",
              "algo.horizon=3", "buffer.size=16", "buffer.memmap=True", "checkpoint.every=4",
              "checkpoint.keep_last=1", "metric.log_level=0", "root_dir=mm"]
    exploration = ["exp=p2e_dv3_exploration", *common, "algo.learning_starts=4", "run_name=expl"]
    first = run(exploration + ["algo.total_steps=12", "fabric.accelerator=cpu"])
    expl_ckpt = str(tmp_path / first["checkpoint"])
    assert glob.glob(os.path.join(os.path.dirname(expl_ckpt), "*.ckpt")) == [expl_ckpt]  # keep_last=1
    listed = open(expl_ckpt + ".memmap").read().split()
    assert listed and all(os.path.isfile(f) for f in listed)

    ft = run(["exp=p2e_dv3_finetuning", *common, "algo.learning_starts=8", "run_name=ft", "algo.total_steps=24",
              f"checkpoint.exploration_ckpt_path={expl_ckpt}", "buffer.load_from_exploration=True",
              "fabric.accelerator=cpu"])
    assert ft["gradient_steps"] >= 1
    # the finetuning run wrote into the exploration run's files, and its own
    # checkpoint (the one it keeps) lists them, so its rotation keeps them
    assert set(open(str(tmp_path / ft["checkpoint"]) + ".memmap").read().split()) == set(listed)
    assert all(os.path.isfile(f) for f in listed)
    resumed = run(exploration + ["algo.total_steps=20", f"checkpoint.resume_from={expl_ckpt}",
                                 "fabric.accelerator=cpu"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] >= 1
    rb = load_checkpoint(str(tmp_path / resumed["checkpoint"]))["rb"]
    assert sum(b._pos for b in rb.buffer) > 0

    # the JAX package: its exploration run deletes the files when it ends
    from sheeprl_tpu.cli import run as jax_run

    jax_run([*exploration, "root_dir=jax_mm", "algo.total_steps=12", "fabric.accelerator=cpu", "env.sync_env=True",
             "buffer.prefetch.enabled=False"])
    jax_dir = tmp_path / "logs" / "runs" / "jax_mm" / "expl" / "version_0"
    assert glob.glob(str(jax_dir / "checkpoint" / "*.ckpt"))
    assert not glob.glob(str(jax_dir / "memmap_buffer" / "**" / "*.memmap"), recursive=True)
