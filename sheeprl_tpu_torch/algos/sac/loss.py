"""SAC losses (port of ``sheeprl_tpu/algos/sac/loss.py``)."""

from __future__ import annotations

import torch


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int) -> torch.Tensor:
    """Sum of per-critic MSEs against the shared soft target; ``qf_values`` is
    ``[batch, n]``, ``next_qf_value`` ``[batch, 1]``."""
    return torch.stack([torch.mean((qf_values[..., i : i + 1] - next_qf_value) ** 2) for i in range(num_critics)]).sum()


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, min_qf_values: torch.Tensor) -> torch.Tensor:
    return torch.mean(alpha * logprobs - min_qf_values)


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    return torch.mean(-log_alpha * (logprobs + target_entropy))
