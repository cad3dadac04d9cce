"""The port's replay buffers, inline sampler, vector env and training
checkpoints, on the CPU.

- The buffers are copies of the JAX package's numpy buffers: seeded alike and
  fed the same rows, both sample the same indices, so every sampled array is
  equal, bit for bit (uniform, next-observation, sequence and per-env
  sampling, across the wrap-around, in memory and memory-mapped).
- The vector env behaves as ``gymnasium.vector.SyncVectorEnv`` with
  ``autoreset_mode=SAME_STEP`` on the three dummy envs: the same observations,
  rewards, flags and ``final_obs`` infos.
- A training checkpoint carries the buffer with its newest rows marked
  truncated (the live buffer keeps its flags), reads back through the port's
  restricted unpickler, and only the newest ``keep_last`` stay.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jbuf
from sheeprl_tpu_torch.data import buffers as tbuf


def _rows(rng, steps: int, n_envs: int) -> dict:
    return {
        "rgb": rng.integers(0, 256, (steps, n_envs, 3, 4, 4)).astype(np.uint8),
        "state": rng.standard_normal((steps, n_envs, 5)).astype(np.float32),
        "actions": rng.standard_normal((steps, n_envs, 2)).astype(np.float32),
        "terminated": (rng.uniform(size=(steps, n_envs, 1)) > 0.8).astype(np.float32),
        "truncated": np.zeros((steps, n_envs, 1), np.float32),
    }


def _assert_same(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("sample_next_obs", [False, True])
def test_replay_buffer_samples_the_same_rows(sample_next_obs):
    rng = np.random.default_rng(0)
    ours = tbuf.ReplayBuffer(7, n_envs=3, obs_keys=("rgb", "state"))
    theirs = jbuf.ReplayBuffer(7, n_envs=3, obs_keys=("rgb", "state"))
    ours.seed(5)
    theirs.seed(5)
    for steps in (3, 2, 4, 1):  # the third add wraps around the 7 rows
        data = _rows(rng, steps, 3)
        ours.add(data)
        theirs.add(data)
        _assert_same(
            ours.sample(4, sample_next_obs=sample_next_obs, n_samples=2),
            theirs.sample(4, sample_next_obs=sample_next_obs, n_samples=2),
        )
    assert ours.full and theirs.full


@pytest.mark.parametrize("memmap", [False, True])
def test_env_independent_sequential_buffer_samples_the_same_sequences(memmap, tmp_path):
    rng = np.random.default_rng(1)
    kw = dict(obs_keys=("rgb", "state"), memmap=memmap)
    ours = tbuf.EnvIndependentReplayBuffer(
        9, n_envs=3, memmap_dir=tmp_path / "ours" if memmap else None, buffer_cls=tbuf.SequentialReplayBuffer, **kw
    )
    theirs = jbuf.EnvIndependentReplayBuffer(
        9, n_envs=3, memmap_dir=tmp_path / "theirs" if memmap else None, buffer_cls=jbuf.SequentialReplayBuffer, **kw
    )
    ours.seed(7)
    theirs.seed(7)
    for step in range(14):
        data = _rows(rng, 1, 3)
        ours.add(data)
        theirs.add(data)
        if step % 3 == 2:
            # reset rows for a subset of the envs, as the loop adds them
            reset = {k: v[:, [0, 2]] for k, v in _rows(rng, 1, 3).items()}
            ours.add(reset, [0, 2])
            theirs.add(reset, [0, 2])
        if step >= 4:
            _assert_same(
                ours.sample(5, n_samples=2, sequence_length=3),
                theirs.sample(5, n_samples=2, sequence_length=3),
            )
    with pytest.raises(ValueError):
        tbuf.SequentialReplayBuffer(4, 1).sample(1)


def test_sample_tensors_lands_torch_tensors():
    buf = tbuf.ReplayBuffer(4, n_envs=2, obs_keys=("state",))
    buf.add(_rows(np.random.default_rng(2), 4, 2))
    out = buf.sample_tensors(3, n_samples=2, dtype=np.float32)
    assert all(isinstance(v, torch.Tensor) and v.shape[:2] == (2, 3) for v in out.values())
    assert out["rgb"].dtype == torch.float32


def test_sample_to_device_keeps_image_keys_uint8():
    from sheeprl_tpu_torch.data.prefetch import sample_to_device

    rb = tbuf.EnvIndependentReplayBuffer(6, n_envs=2, obs_keys=("rgb", "state"), buffer_cls=tbuf.SequentialReplayBuffer)
    rb.seed(0)
    for _ in range(4):
        rb.add(_rows(np.random.default_rng(3), 1, 2))
    block = sample_to_device(rb, 2, batch_size=3, sequence_length=2, uint8_keys=["rgb"], device="cpu")
    assert block["rgb"].dtype == torch.uint8 and block["state"].dtype == torch.float32
    assert block["state"].shape == (2, 2, 3, 5)


# ---------------------------------------------------------------------------------
# the vector env
# ---------------------------------------------------------------------------------
def _vector_pair(kind: str, n_envs: int):
    import gymnasium as gym

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv
    from sheeprl_tpu_torch.utils.env import make_env
    from test_torch_helpers import overrides

    # episodes of 3 steps on every kind, so each run crosses several resets
    ov = overrides(kind, ["env.max_episode_steps=3"])
    cfg, cfg_jax = compose(ov), jax_compose(ov)
    ours = SyncVectorEnv([make_env(cfg, 10 + i, 0, vector_env_idx=i) for i in range(n_envs)])
    theirs = gym.vector.SyncVectorEnv(
        [jax_make_env(cfg_jax, 10 + i, 0, vector_env_idx=i) for i in range(n_envs)],
        autoreset_mode=gym.vector.AutoresetMode.SAME_STEP,
    )
    return ours, theirs


@pytest.mark.parametrize("kind", ["discrete", "multidiscrete", "continuous"])
def test_vector_env_steps_like_gymnasium_same_step_autoreset(kind):
    ours, theirs = _vector_pair(kind, 3)
    assert ours.action_space.shape == theirs.action_space.shape
    for k, space in theirs.single_observation_space.spaces.items():
        assert ours.single_observation_space[k].shape == space.shape
    o1, _ = ours.reset(seed=4)
    o2, _ = theirs.reset(seed=4)
    rng = np.random.default_rng(5)
    finals = 0
    for _ in range(9):
        action = np.stack([ours.single_action_space.sample(rng) for _ in range(3)])
        o1, r1, t1, u1, i1 = ours.step(action)
        o2, r2, t2, u2, i2 = theirs.step(action)
        for k in o2:
            np.testing.assert_array_equal(o1[k], o2[k])
            assert o1[k].dtype == o2[k].dtype
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(u1, u2)
        assert sorted(i1) == sorted(i2)
        if "final_obs" in i2:
            finals += 1
            np.testing.assert_array_equal(i1["_final_obs"], i2["_final_obs"])
            for a, b in zip(i1["final_obs"], i2["final_obs"]):
                assert (a is None) == (b is None)
                if b is not None:
                    for k in b:
                        np.testing.assert_array_equal(a[k], b[k])
    assert finals >= 2
    ours.close()
    theirs.close()


# ---------------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------------
def test_run_checkpoint_carries_the_buffer_and_keeps_the_newest(tmp_path):
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_run_checkpoint

    rb = tbuf.EnvIndependentReplayBuffer(5, n_envs=2, obs_keys=("rgb",), buffer_cls=tbuf.SequentialReplayBuffer)
    rb.seed(3)
    for _ in range(3):
        rb.add(_rows(np.random.default_rng(4), 1, 2))
    live = [b["truncated"].copy() for b in rb.buffer]
    folder = tmp_path / "checkpoint"
    paths = [str(folder / f"ckpt_{i}_0.ckpt") for i in range(3)]
    for i, path in enumerate(paths):
        save_run_checkpoint(path, {"iter_num": i, "opt": {"w": torch.ones(2)}}, replay_buffer=rb, keep_last=2)
        os.utime(path, (1000 + i, 1000 + i))  # a strict age order, whatever the clock's resolution
    assert sorted(os.listdir(folder)) == sorted(
        [os.path.basename(p) for p in paths[1:]] + [os.path.basename(p) + ".sha256" for p in paths[1:]]
    )
    for b, before in zip(rb.buffer, live):
        np.testing.assert_array_equal(b["truncated"], before)
    state = load_checkpoint(paths[-1])
    assert state["iter_num"] == 2 and isinstance(state["opt"]["w"], np.ndarray)
    restored = state["rb"]
    for b in restored.buffer:
        assert b["truncated"][(b._pos - 1) % b.buffer_size].all()
        assert b["terminated"][(b._pos - 1) % b.buffer_size].all()
    # the restored generator continues where the live one stands
    np.testing.assert_array_equal(
        restored.sample(2, sequence_length=2)["rgb"], rb.sample(2, sequence_length=2)["rgb"]
    )
