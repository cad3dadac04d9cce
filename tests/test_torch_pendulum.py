"""The port's Pendulum-v1 (``envs/classic.py``) against
``gymnasium.make("Pendulum-v1")``, bit for bit through truncation, and the
Box2D ids the SAC exps default to, refused by name."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_helpers import SAC_SMALL


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_pendulum_steps_bitwise_like_gymnasium(seed):
    """450 steps of seeded random torques in [-3, 3] (a third outside the
    bounds, clipped by the env) through two 200-step truncations, resets
    without a seed in between: observations, rewards (their type too) and
    flags are bitwise equal."""
    import gymnasium as gym

    from sheeprl_tpu_torch.envs.classic import make

    ours, theirs = make("Pendulum-v1"), gym.make("Pendulum-v1")
    o1, _ = ours.reset(seed=seed)
    o2, _ = theirs.reset(seed=seed)
    torques = np.random.default_rng(seed).uniform(-3.0, 3.0, (450, 1)).astype(np.float32)
    truncations = 0
    for t in range(450):
        assert o1.dtype == o2.dtype == np.float32 and np.array_equal(o1, o2)
        o1, r1, term1, trunc1, _ = ours.step(torques[t])
        o2, r2, term2, trunc2, _ = theirs.step(torques[t])
        assert (r1, term1, trunc1) == (r2, term2, trunc2) and type(r1) is type(r2)
        truncations += trunc2
        if term2 or trunc2:
            o1, _ = ours.reset()
            o2, _ = theirs.reset()
    assert truncations == 2


def test_box2d_ids_are_refused_by_name():
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.envs.classic import make

    with pytest.raises(NotImplementedError, match="Box2D"):
        make("LunarLanderContinuous-v3")
    with pytest.raises(NotImplementedError, match="Box2D"):
        run(["exp=sac", "fabric.accelerator=cpu", "env.capture_video=False", "root_dir=refused"])
    with pytest.raises(NotImplementedError, match="prefetch"):
        run(SAC_SMALL + ["buffer.prefetch.enabled=True"])
