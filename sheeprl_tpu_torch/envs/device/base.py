"""The device env protocol: environments as batched tensors (port of
``sheeprl_tpu/envs/jax/base.py``).

An on-device environment is a few functions over batched tensors plus a static
spec. Its state is one tensor with the batch axes leading and one trailing
axis (CartPole's four physics values, Pendulum's angle and speed, a
gridworld's agent and goal cells), so the auto-reset wrapper selects between
two states with one ``torch.where``:

- ``draw(batch, generator, device) -> state``: fresh episode states of the
  leading shape ``batch``, drawn from the reset distribution;
- ``observe(state) -> obs``: the observation of a state;
- ``step(state, action) -> (state, obs, reward, terminated)``: one step of
  every env of the batch. ``action`` is ``[E]`` integers for a discrete
  action, ``[E, *shape]`` floats for a continuous one.

None of them reads a value back to the host, so a rollout of many steps
enqueues its work on the card without waiting for it. Where the JAX package
draws a reset from a ``jax.random`` key, the port draws it from a
``torch.Generator``, or is handed the state (the tests pass the JAX reset's).
The batch axis is the tensors' own: the JAX ``VmapEnv`` has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces


@dataclass(frozen=True)
class ActionSpec:
    """Static action-space descriptor: ``kind='discrete'`` takes one of
    ``num_actions`` integers, ``kind='continuous'`` a float vector of
    ``shape`` bounded by ``low``/``high``."""

    kind: str  # "discrete" | "continuous"
    num_actions: int = 0
    shape: Tuple[int, ...] = ()
    low: float = -1.0
    high: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in ("discrete", "continuous"):
            raise ValueError(f"unknown action kind {self.kind!r}")

    @property
    def actions_dim(self) -> Tuple[int, ...]:
        """The agents' per-head action dims: one categorical head of
        ``num_actions`` logits, or one continuous head of ``shape``."""
        if self.kind == "discrete":
            return (int(self.num_actions),)
        return tuple(int(s) for s in self.shape)

    def to_space(self) -> spaces.Space:
        if self.kind == "discrete":
            return spaces.Discrete(int(self.num_actions))
        return spaces.Box(self.low, self.high, self.shape, np.float32)


@dataclass(frozen=True)
class EnvSpec:
    """Static environment descriptor: the float32 observation's shape and
    bounds, the action spec, and the episode step budget a wrapper truncates
    at (None: none)."""

    obs_shape: Tuple[int, ...]
    action: ActionSpec
    obs_low: float = -np.inf
    obs_high: float = np.inf
    max_episode_steps: Optional[int] = None

    def to_obs_space(self) -> spaces.Box:
        return spaces.Box(self.obs_low, self.obs_high, self.obs_shape, np.float32)


class DeviceEnv:
    """Base class of the batched environments (see the module docstring)."""

    spec: EnvSpec

    def draw(self, batch: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        raise NotImplementedError

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def reset(self, num_envs: int, generator: Optional[torch.Generator], device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh states of ``num_envs`` envs and their observations."""
        state = self.draw((num_envs,), generator, device)
        return state, self.observe(state)
