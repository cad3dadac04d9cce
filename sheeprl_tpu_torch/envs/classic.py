"""Classic-control environments in numpy (the machine with the card has no
gymnasium).

:class:`CartPole` transcribes gymnasium's ``CartPoleEnv`` (``CartPole-v1``):
the float64 physics state, the float32 observation, Euler integration in the
same order, the same thresholds, and the same reward after a termination.
Seeding is gymnasium's: ``reset(seed=s)`` makes
``Generator(PCG64(SeedSequence(s)))`` and draws the state from
``uniform(-0.05, 0.05, 4)``; a reset without a seed keeps drawing from that
generator. :func:`make` stands in for ``gymnasium.make``: it adds the 500-step
``TimeLimit`` of ``CartPole-v1``'s registration.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import TimeLimit


class CartPole:
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, render_mode: Optional[str] = None) -> None:
        if render_mode is not None:
            raise NotImplementedError("rendering CartPole is not yet ported to sheeprl_tpu_torch")
        high = np.array(
            [self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf], dtype=np.float32
        )
        self.action_space = spaces.Discrete(2)
        self.observation_space = spaces.Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated: Optional[int] = None

    def step(self, action):
        if self.state is None:
            raise RuntimeError("Call reset before using step method.")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = 1.0
        else:
            # stepping on after a termination: gymnasium warns and pays 0
            self.steps_beyond_terminated += 1
            reward = 0.0
        return np.array(self.state, dtype=np.float32), reward, terminated, False, {}

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        if seed is not None or self.np_random is None:
            if seed is not None and not (isinstance(seed, int) and seed >= 0):
                raise ValueError(f"Seed must be a non-negative python integer, got {seed!r}")
            self.np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        low, high = -0.05, 0.05
        if options is not None:
            low, high = options.get("low", low), options.get("high", high)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}

    def close(self) -> None:
        pass


# gymnasium's registrations: the class and its step budget
_REGISTRY = {"CartPole-v1": (CartPole, 500)}


def make(id: str, render_mode: Optional[str] = None, **kwargs: Any) -> Any:
    """``gymnasium.make`` for the ids the port has: ``CartPole-v1``."""
    if id not in _REGISTRY:
        raise NotImplementedError(
            f"gym environment {id!r} is not yet ported to sheeprl_tpu_torch (ported: {', '.join(_REGISTRY)})"
        )
    cls, max_episode_steps = _REGISTRY[id]
    return TimeLimit(cls(render_mode=render_mode, **kwargs), max_episode_steps=max_episode_steps)
