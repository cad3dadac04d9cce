"""Factories of the device env plane and its gym-style adapter (port of
``sheeprl_tpu/envs/jax/factory.py``).

One id namespace, :data:`DEVICE_ENV_IDS`, two consumers:

- :func:`make_device_env`: ``cfg.env.id`` resolved, the auto-reset contract
  applied, ``num_envs`` instances on a device. The Anakin loop
  (``algos/ppo/anakin.py``) steps it.
- :class:`DeviceToGymEnv`: one instance stepped on the CPU behind the
  ``make_env`` factory (``env.backend=jax``), so every host-env loop, the test
  episode, evaluation and serving run the same dynamics.

Gridworld ids take an optional size suffix: ``gridworld_four_rooms-16`` is the
16x16 four-rooms member. The config keeps the JAX package's name for the
plane, ``env.backend=jax``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.device.base import DeviceEnv
from sheeprl_tpu_torch.envs.device.classic import CartPole, Pendulum
from sheeprl_tpu_torch.envs.device.gridworld import GridWorld
from sheeprl_tpu_torch.envs.device.wrappers import AutoReset

DEVICE_ENV_IDS = ("CartPole-v1", "Pendulum-v1", "gridworld_empty", "gridworld_four_rooms")


def resolve_device_env(env_id: str) -> Tuple[DeviceEnv, Optional[int]]:
    """The bare env of ``env_id`` and the id's default episode step budget
    (gymnasium's registered limit for the classics, ``4 * N * N`` for a
    gridworld)."""
    if env_id == "CartPole-v1":
        return CartPole(), 500
    if env_id == "Pendulum-v1":
        return Pendulum(), 200
    if env_id.startswith("gridworld_"):
        base, _, size_suffix = env_id.partition("-")
        size = int(size_suffix) if size_suffix else 8
        return GridWorld(size=size, layout=base[len("gridworld_"):]), 4 * size * size
    raise ValueError(f"unknown device env id {env_id!r}; the device env plane provides {DEVICE_ENV_IDS}")


def make_device_env(cfg: Any, num_envs: int, device) -> AutoReset:
    """``cfg.env.id`` under the auto-reset contract, ``num_envs`` instances on
    ``device``. ``cfg.env.max_episode_steps`` overrides the id's budget; a
    value <= 0 turns truncation off."""
    env, default_limit = resolve_device_env(str(cfg.env.id))
    limit = cfg.env.get("max_episode_steps", None)
    limit = default_limit if limit is None else (int(limit) if int(limit) > 0 else None)
    return AutoReset(env, num_envs, device, max_episode_steps=limit)


class DeviceToGymEnv:
    """A gym-style env over one instance of a device env on the CPU (the
    ``env.backend=jax`` plane behind ``make_env``): numpy observations over
    the port's spaces, ``(obs, reward, terminated, truncated, info)`` steps.
    Resets draw from a ``torch.Generator`` seeded with ``seed`` (or with the
    ``seed`` given to :meth:`reset`). With ``apply_default_time_limit`` an
    episode truncates at the id's default step budget; without it, never (the
    caller installs its own limit)."""

    def __init__(self, id: str, seed: int = 0, apply_default_time_limit: bool = True):
        self._env, default_limit = resolve_device_env(id)
        self.id = id
        self._max_episode_steps = default_limit if apply_default_time_limit else None
        self.observation_space = self._env.spec.to_obs_space()
        self.action_space = self._env.spec.action.to_space()
        self._discrete = self._env.spec.action.kind == "discrete"
        self._generator = torch.Generator().manual_seed(int(seed))
        self._state: Optional[torch.Tensor] = None
        self._elapsed = 0

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, obs = self._env.reset(1, self._generator, "cpu")
        self._elapsed = 0
        return obs[0].numpy(), {}

    def step(self, action):
        if self._discrete:
            action = torch.tensor([int(np.asarray(action).reshape(()))])
        else:
            action = torch.as_tensor(np.asarray(action, np.float32)).reshape(1, *self._env.spec.action.shape)
        self._state, obs, reward, terminated = self._env.step(self._state, action)
        self._elapsed += 1
        terminated = bool(terminated[0])
        truncated = bool(
            self._max_episode_steps is not None and self._elapsed >= self._max_episode_steps and not terminated
        )
        return obs[0].numpy(), float(reward[0]), terminated, truncated, {}

    def close(self) -> None:
        pass
