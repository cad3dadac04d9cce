"""PPO losses (port of ``sheeprl_tpu/algos/ppo/loss.py``)."""

from __future__ import annotations

import torch


def reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    reduction = reduction.lower()
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")


def policy_loss(
    new_logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    clip_coef: float,
    reduction: str = "mean",
) -> torch.Tensor:
    """The clipped surrogate objective."""
    ratio = torch.exp(new_logprobs - old_logprobs)
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
    return reduce(torch.maximum(pg_loss1, pg_loss2), reduction)


def value_loss(
    new_values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    clip_coef: float,
    clip_vloss: bool,
    reduction: str = "mean",
) -> torch.Tensor:
    """Squared error of the (optionally clipped) value prediction: no 0.5
    factor, and the clipped form uses the clipped prediction only."""
    if clip_vloss:
        values_pred = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    else:
        values_pred = new_values
    return reduce(torch.square(values_pred - returns), reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return -reduce(entropy, reduction)
