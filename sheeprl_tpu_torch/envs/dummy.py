"""Deterministic fake environments (port of ``sheeprl_tpu/envs/dummy.py``): dict
observations with an ``rgb`` image and a ``state`` vector, zero rewards, fixed
episode length. Same observation streams as the JAX package's for the same
arguments."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class BaseDummyEnv:
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        step_latency_ms: float = 0.0,
    ):
        self._step_latency_s = float(step_latency_ms) / 1000.0
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                "state": spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32),
            }
        )
        self.reward_range = (-np.inf, np.inf)
        self.render_mode = "rgb_array"
        self._current_step = 0
        self._n_steps = n_steps

    def get_obs(self) -> Dict[str, np.ndarray]:
        return {
            "rgb": np.zeros(self.observation_space["rgb"].shape, dtype=np.uint8),
            "state": np.zeros(self.observation_space["state"].shape, dtype=np.float32),
        }

    def step(self, action):
        if self._step_latency_s > 0:
            time.sleep(self._step_latency_s)
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self.get_obs(), 0.0, done, False, {}

    def reset(self, seed=None, options=None):
        self._current_step = 0
        return self.get_obs(), {}

    def render(self):
        return np.transpose(self.get_obs()["rgb"], (1, 2, 0))

    def close(self):
        pass


class ContinuousDummyEnv(BaseDummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        action_dim: int = 2,
        step_latency_ms: float = 0.0,
    ):
        self.action_space = spaces.Box(-1.0, 1.0, shape=(action_dim,))
        super().__init__(
            image_size=image_size, n_steps=n_steps, vector_shape=vector_shape,
            step_latency_ms=step_latency_ms,
        )


class DiscreteDummyEnv(BaseDummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 4,
        vector_shape: Tuple[int, ...] = (10,),
        action_dim: int = 2,
        step_latency_ms: float = 0.0,
    ):
        self.action_space = spaces.Discrete(action_dim)
        super().__init__(
            image_size=image_size, n_steps=n_steps, vector_shape=vector_shape,
            step_latency_ms=step_latency_ms,
        )


class MultiDiscreteDummyEnv(BaseDummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        action_dims: List[int] = [2, 2],
        step_latency_ms: float = 0.0,
    ):
        self.action_space = spaces.MultiDiscrete(action_dims)
        super().__init__(
            image_size=image_size, n_steps=n_steps, vector_shape=vector_shape,
            step_latency_ms=step_latency_ms,
        )
