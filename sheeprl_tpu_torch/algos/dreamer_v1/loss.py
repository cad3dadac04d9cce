"""Dreamer-V1 world-model loss (port of ``sheeprl_tpu/algos/dreamer_v1/loss.py``):
the Gaussian KL of posterior and prior, clipped below at the free nats."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import normal_kl


def reconstruction_loss(
    observation_log_probs: Dict[str, torch.Tensor],
    reward_log_prob: torch.Tensor,
    posterior_mean: torch.Tensor,
    posterior_std: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_std: torch.Tensor,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    continue_log_prob: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, kl, state_loss, reward_loss, observation_loss, continue_loss)."""
    observation_loss = -sum(lp.mean() for lp in observation_log_probs.values())
    reward_loss = -reward_log_prob.mean()
    kl = normal_kl(posterior_mean, posterior_std, prior_mean, prior_std).mean()
    state_loss = torch.clamp(kl, min=kl_free_nats)
    if continue_log_prob is not None:
        continue_loss = continue_scale_factor * -continue_log_prob.mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    loss = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return loss, kl, state_loss, reward_loss, observation_loss, continue_loss
