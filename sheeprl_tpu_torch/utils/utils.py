"""Shared math and run helpers (port of the parts of ``sheeprl_tpu/utils/utils.py``
the port's algorithms use): symlog/symexp, two-hot encoding, λ-returns, GAE,
advantage normalisation, polynomial decay, the replay-ratio governor, the
run's config dump and the copy of trained weights into a host-side actor."""

from __future__ import annotations

import functools
import os
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: a weakly
    typed scalar takes the array's dtype, so against a bf16 array it is rounded
    to bf16 first (0.1 acts as 0.10009765625). Torch keeps the constant in
    float32 inside a bf16 op, so the port rounds it here; in float32 the value
    is returned as is."""
    if dtype == torch.float32:
        return float(value)
    return float(torch.tensor(float(value), dtype=dtype))


def symlog(x: torch.Tensor) -> torch.Tensor:
    """Dreamer-V3 eq. 10: sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Encode scalars (..., 1) into two-hot vectors (..., num_buckets) over the
    linear support [-support_range, support_range]."""
    if x.ndim == 0:
        x = x[None]
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    x = torch.clamp(x, -support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    bucket_size = (buckets[1] - buckets[0]) if num_buckets > 1 else torch.ones((), dtype=x.dtype, device=x.device)

    right_idxs = torch.searchsorted(buckets, x.contiguous(), side="left")
    left_idxs = torch.clamp(right_idxs - 1, 0, num_buckets - 1)
    right_idxs = torch.clamp(right_idxs, 0, num_buckets - 1)

    left_value = torch.abs(buckets[right_idxs] - x) / bucket_size
    right_value = 1.0 - left_value

    left_oh = torch.nn.functional.one_hot(left_idxs[..., 0], num_buckets).to(x.dtype)
    right_oh = torch.nn.functional.one_hot(right_idxs[..., 0], num_buckets).to(x.dtype)
    return left_oh * left_value + right_oh * right_value


def two_hot_decoder(t: torch.Tensor, support_range: int) -> torch.Tensor:
    num_buckets = t.shape[-1]
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    support = torch.linspace(-support_range, support_range, num_buckets, dtype=t.dtype, device=t.device)
    return torch.sum(t * support, dim=-1, keepdim=True)


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """TD(λ) returns over an imagined trajectory:
    ``ret[t] = r[t] + c[t] * ((1-λ) v[t] + λ ret[t+1])``, the carry starting at
    ``v[T-1]``. Callers pass the inputs already shifted (rewards[1:],
    values[1:], continues[1:] * gamma). Accumulated in float32 whatever the
    inputs' dtype."""
    rewards = rewards.float()
    values = values.float()
    continues = continues.float()
    interm = rewards + continues * values * (1 - lmbda)
    ret = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = interm[t] + continues[t] * lmbda * ret
        out.append(ret)
    return torch.stack(out[::-1], dim=0)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    num_steps: int,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation over a [T, B, ...] rollout; returns
    (returns, advantages) shaped like ``rewards``. ``dones[t]`` flags an
    episode's end at step t; the last step bootstraps from ``next_value``
    masked by ``1 - dones[-1]``."""
    dtype = rewards.dtype
    not_dones = 1.0 - dones.to(dtype)
    values = values.to(dtype)
    next_values = torch.cat([values[1:], next_value[None].to(dtype)], dim=0)
    lastgaelam = torch.zeros_like(rewards[0])
    advantages = [None] * num_steps
    for t in range(num_steps - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * not_dones[t] - values[t]
        lastgaelam = delta + gamma * gae_lambda * not_dones[t] * lastgaelam
        advantages[t] = lastgaelam
    advantages = torch.stack(advantages, dim=0)
    return advantages + values, advantages


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x - mean) / (std + eps)``, the population std (``jnp.std``), over
    the entries ``mask`` keeps when given."""
    if mask is None:
        return (x - x.mean()) / (x.std(correction=0) + eps)
    n = torch.clamp(mask.sum(), min=1)
    mean = torch.sum(x * mask) / n
    var = torch.sum(torch.square(x - mean) * mask) / n
    return (x - mean) / (torch.sqrt(var) + eps)


def polynomial_decay(
    current_step: int,
    *,
    initial: float = 1.0,
    final: float = 0.0,
    max_decay_steps: int = 100,
    power: float = 1.0,
) -> float:
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


class Ratio:
    """Replay-ratio governor: how many gradient steps to run for the env steps
    taken since the last call."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(step * self._ratio)
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "The number of pretrain steps is greater than the number of current steps. "
                        f"This could lead to a higher ratio than the one specified ({self._ratio}). "
                        "Setting the 'pretrain_steps' equal to the number of current steps."
                    )
                    self._pretrain_steps = step
                repeats = int(self._pretrain_steps * self._ratio)
            return repeats
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Mapping[str, Any]) -> "Ratio":
        self._ratio = state["_ratio"]
        self._prev = state["_prev"]
        self._pretrain_steps = state["_pretrain_steps"]
        return self


def save_configs(cfg, log_dir: str) -> None:
    import yaml

    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.as_dict(), f, sort_keys=False)


def sync_actor(act_agent: torch.nn.Module, agent: torch.nn.Module) -> None:
    """Copy the trained weights into the host-side acting agent."""
    if act_agent is not agent:
        with torch.no_grad():
            for dst, src in zip(act_agent.parameters(), agent.parameters()):
                dst.copy_(src)
