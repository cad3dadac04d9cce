"""CartPole and Pendulum as batched float32 tensors (port of
``sheeprl_tpu/envs/jax/classic.py``).

The step formulas keep the JAX package's float32 op order (which transcribes
gymnasium's ``CartPoleEnv`` and ``PendulumEnv``): the same constants folded
the same way, Euler integration in the same order, the same thresholds. The
state is ``[..., 4]`` (x, x_dot, theta, theta_dot) for CartPole and
``[..., 2]`` (theta, theta_dot) for Pendulum; randomness enters only through
the reset draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.envs.device.base import ActionSpec, DeviceEnv, EnvSpec


def _uniform(batch: Sequence[int], width: int, low: float, high: float, generator, device) -> torch.Tensor:
    """``U[low, high)`` of shape ``[*batch, width]``, made on ``device`` (no
    copy from the host)."""
    u = torch.rand((*batch, width), generator=generator, device=device)
    return u * (high - low) + low


class CartPole(DeviceEnv):
    """gymnasium ``CartPole-v1``: 2 discrete actions, reward 1 per step (the
    terminal step included), termination on |x| > 2.4 or |theta| > 12 deg.
    The 500-step truncation is the auto-reset wrapper's."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSPOLE + MASSCART
    LENGTH = 0.5  # half the pole's length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_THRESHOLD = 12 * 2 * math.pi / 360
    X_THRESHOLD = 2.4

    spec = EnvSpec(obs_shape=(4,), action=ActionSpec(kind="discrete", num_actions=2))

    def draw(self, batch: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        return _uniform(batch, 4, -0.05, 0.05, generator, device)

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def step(self, state: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x, x_dot, theta, theta_dot = state.unbind(-1)
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG).to(torch.float32)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * torch.square(theta_dot) * sintheta) / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * torch.square(costheta) / self.TOTAL_MASS)
        )
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta / self.TOTAL_MASS
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        new_state = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = (torch.abs(x) > self.X_THRESHOLD) | (torch.abs(theta) > self.THETA_THRESHOLD)
        reward = torch.ones_like(x)
        return new_state, new_state, reward, terminated


class Pendulum(DeviceEnv):
    """gymnasium ``Pendulum-v1``: a torque in [-2, 2] swings the pendulum up;
    it never terminates (the 200-step truncation is the wrapper's)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    spec = EnvSpec(
        obs_shape=(3,),
        action=ActionSpec(kind="continuous", shape=(1,), low=-2.0, high=2.0),
        obs_low=-8.0,
        obs_high=8.0,
    )

    def draw(self, batch: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        # gymnasium: theta ~ U(-pi, pi), theta_dot ~ U(-1, 1); the JAX package
        # scales one U(-1, 1) draw by (pi, 1)
        u = _uniform(batch, 2, -1.0, 1.0, generator, device)
        return torch.stack([u[..., 0] * math.pi, u[..., 1]], dim=-1)

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        th, thdot = state.unbind(-1)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def step(self, state: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        th, thdot = state.unbind(-1)
        u = torch.clamp(action.reshape(th.shape), -self.MAX_TORQUE, self.MAX_TORQUE)
        angle_norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        costs = torch.square(angle_norm) + 0.1 * torch.square(thdot) + 0.001 * torch.square(u)
        newthdot = thdot + (
            3.0 * self.G / (2.0 * self.L) * torch.sin(th) + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        new_state = torch.stack([newth, newthdot], dim=-1)
        return new_state, self.observe(new_state), -costs, torch.zeros_like(th, dtype=torch.bool)
