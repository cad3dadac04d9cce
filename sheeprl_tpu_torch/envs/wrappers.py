"""Environment wrappers (port of the parts of ``sheeprl_tpu/envs/wrappers.py``
and of the gymnasium wrappers that ``make_env`` applies to the port's envs),
over the port's own spaces instead of gymnasium's."""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs import spaces


class Wrapper:
    """Forwards everything to the wrapped env; subclasses override what they change."""

    def __init__(self, env: Any) -> None:
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def step(self, action):
        return self.env.step(action)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return self.env.reset(seed=seed, options=options)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        self.env.close()


class InjectedEnvFault(Wrapper):
    """One-shot ``env.step`` exception driven by ``resilience.fault=env_step``
    (``resilience/faults.py``). The armed flag is process-global, so it reaches
    every in-process env: the serve verb's session envs."""

    def step(self, action):
        from sheeprl_tpu_torch.resilience.faults import InjectedFaultError, consume_env_fault

        if consume_env_fault():
            raise InjectedFaultError("resilience.fault=env_step: injected exception in env.step")
        return self.env.step(action)


class ActionRepeat(Wrapper):
    """Repeat each action ``amount`` times, accumulating reward, stopping on done."""

    def __init__(self, env: Any, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = amount

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        terminated = truncated = False
        total_reward = 0.0
        obs, info = None, {}
        for _ in range(self._amount):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total_reward += float(reward)
            if terminated or truncated:
                break
        return obs, total_reward, terminated, truncated, info


class FrameStack(Wrapper):
    """Stack the last ``num_stack`` image frames (optionally dilated) of each cnn key
    along a new leading axis: (num_stack, C, H, W)."""

    def __init__(self, env: Any, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1) -> None:
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack, expected a value greater than zero, got {num_stack}")
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(
                f"Expected an observation space of type spaces.Dict, got: {type(env.observation_space)}"
            )
        self._num_stack = num_stack
        self._dilation = dilation
        self._cnn_keys = []
        self.observation_space = copy.deepcopy(env.observation_space)
        for k, v in env.observation_space.items():
            if cnn_keys and k in cnn_keys and len(v.shape) == 3:
                self._cnn_keys.append(k)
                self.observation_space[k] = spaces.Box(
                    np.repeat(v.low[None, ...], num_stack, axis=0),
                    np.repeat(v.high[None, ...], num_stack, axis=0),
                    (num_stack, *v.shape),
                    v.dtype,
                )
        if not self._cnn_keys:
            raise RuntimeError("Specify at least one valid cnn key to be stacked")
        self._frames = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}

    def _get_obs(self, key: str) -> np.ndarray:
        frames = list(self._frames[key])[self._dilation - 1 :: self._dilation]
        return np.stack(frames, axis=0)

    def step(self, action):
        obs, reward, terminated, truncated, infos = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
            obs[k] = self._get_obs(k)
        return obs, reward, terminated, truncated, infos

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
            obs[k] = self._get_obs(k)
        return obs, infos


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps (gymnasium's TimeLimit)."""

    def __init__(self, env: Any, max_episode_steps: int) -> None:
        super().__init__(env)
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        self._elapsed = 0
        return self.env.reset(seed=seed, options=options)


class DictObservation(Wrapper):
    """A single-array observation as a one-key dict observation."""

    def __init__(self, env: Any, key: str) -> None:
        super().__init__(env)
        self._key = key
        self.observation_space = spaces.Dict({key: env.observation_space})

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return {self._key: obs}, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return {self._key: obs}, info


class MaskVelocityWrapper(Wrapper):
    """Zero the velocity entries of a vector observation (``env.mask_velocities``)."""

    # the JAX package's table, for the ids the port has
    velocity_indices: Dict[str, np.ndarray] = {"CartPole-v1": np.array([1, 3])}

    def __init__(self, env: Any, env_id: str) -> None:
        super().__init__(env)
        if env_id not in self.velocity_indices:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self.mask = np.ones(env.observation_space.shape, dtype=env.observation_space.dtype)
        self.mask[self.velocity_indices[env_id]] = 0.0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs * self.mask, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return obs * self.mask, info


class RecordEpisodeStatistics(Wrapper):
    """At an episode's end, ``info["episode"] = {"r": return, "l": length, "t":
    seconds}``, as ``gymnasium.wrappers.RecordEpisodeStatistics`` reports it."""

    def __init__(self, env: Any) -> None:
        super().__init__(env)
        self.episode_start_time = -1.0
        self.episode_returns = 0.0
        self.episode_lengths = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.episode_returns += reward
        self.episode_lengths += 1
        if terminated or truncated:
            info = dict(info)
            info["episode"] = {
                "r": self.episode_returns,
                "l": self.episode_lengths,
                "t": round(time.perf_counter() - self.episode_start_time, 6),
            }
            self.episode_start_time = time.perf_counter()
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        self.episode_start_time = time.perf_counter()
        self.episode_returns = 0.0
        self.episode_lengths = 0
        return obs, info
