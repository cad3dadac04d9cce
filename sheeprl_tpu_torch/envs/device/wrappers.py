"""The auto-reset contract over a batched device env (port of
``sheeprl_tpu/envs/jax/wrappers.py``).

:class:`AutoReset` reproduces the host plane's same-step autoreset: the step
that ends an episode returns the fresh reset observation as the next
observation, the terminal observation rides in
``info["terminal_observation"]``, truncation at the step budget is reported
apart from termination, and the running episode return and length surface in
``info`` on the done step and restart from 0 after it.

The reset is computed every step and selected by the done mask, as the JAX
wrapper does, so the step has no data-dependent control flow and reads
nothing back to the host. The JAX step draws that reset from a key it carries
in its state; the port's :meth:`AutoReset.step` takes the reset state as an
argument (a rollout draws all of its steps' resets at once with
:meth:`AutoReset.draw_resets`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from sheeprl_tpu_torch.envs.device.base import DeviceEnv, EnvSpec


class AutoResetState(NamedTuple):
    inner: torch.Tensor  # [E, ...] the wrapped env's state
    episode_return: torch.Tensor  # [E] float32 running return of the current episode
    episode_length: torch.Tensor  # [E] int32 running length of the current episode


class AutoReset:
    """``num_envs`` instances of ``env`` on ``device`` under the same-step
    autoreset contract, truncating at ``max_episode_steps`` (None: never)."""

    def __init__(self, env: DeviceEnv, num_envs: int, device, max_episode_steps: Optional[int] = None):
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.max_episode_steps = int(max_episode_steps) if max_episode_steps else None
        s = env.spec
        self.spec = EnvSpec(s.obs_shape, s.action, s.obs_low, s.obs_high, self.max_episode_steps)

    def reset(self, generator: Optional[torch.Generator] = None, inner: Optional[torch.Tensor] = None):
        """(state, obs) of fresh episodes, drawn from ``generator`` or started
        from the given ``inner`` states."""
        if inner is None:
            inner = self.env.draw((self.num_envs,), generator, self.device)
        state = AutoResetState(
            inner=inner,
            episode_return=torch.zeros(self.num_envs, dtype=torch.float32, device=self.device),
            episode_length=torch.zeros(self.num_envs, dtype=torch.int32, device=self.device),
        )
        return state, self.env.observe(inner)

    def draw_resets(self, steps: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The reset states of ``steps`` steps at once, ``[steps, E, ...]``."""
        return self.env.draw((steps, self.num_envs), generator, self.device)

    def step(
        self, state: AutoResetState, action: torch.Tensor, reset_inner: torch.Tensor
    ) -> Tuple[AutoResetState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One step of every env: (state, obs, reward, done, info). An env
        that is done this step restarts from ``reset_inner``."""
        inner, obs, reward, terminated = self.env.step(state.inner, action)
        episode_return = state.episode_return + reward
        episode_length = state.episode_length + 1
        if self.max_episode_steps is not None:
            truncated = (episode_length >= self.max_episode_steps) & ~terminated
        else:
            truncated = torch.zeros_like(terminated)
        done = terminated | truncated
        reset_obs = self.env.observe(reset_inner)
        new_state = AutoResetState(
            inner=torch.where(done[:, None], reset_inner, inner),
            episode_return=torch.where(done, 0.0, episode_return),
            episode_length=torch.where(done, 0, episode_length).to(torch.int32),
        )
        info = {
            # the pre-reset observation of this step; valid where done
            "terminal_observation": obs,
            "terminated": terminated,
            "truncated": truncated,
            # the stats of the episode that ended this step; valid where done
            "episode_return": episode_return,
            "episode_length": episode_length,
        }
        return new_state, torch.where(done[:, None], reset_obs, obs), reward, done, info
