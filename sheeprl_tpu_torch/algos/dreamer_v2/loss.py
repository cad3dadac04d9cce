"""Dreamer-V2 world-model loss (port of ``sheeprl_tpu/algos/dreamer_v2/loss.py``):
KL balancing with alpha (0.8 of it trains the prior) and free nats on the
(optionally averaged) KL."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import categorical_kl


def reconstruction_loss(
    observation_log_probs: Dict[str, torch.Tensor],
    reward_log_prob: torch.Tensor,
    priors_logits: torch.Tensor,
    posteriors_logits: torch.Tensor,
    discrete_size: int,
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    continue_log_prob: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, kl, state_loss, reward_loss, observation_loss, continue_loss)."""
    observation_loss = -sum(lp.mean() for lp in observation_log_probs.values())
    reward_loss = -reward_log_prob.mean()
    lhs = kl = categorical_kl(posteriors_logits.detach(), priors_logits, discrete_size)
    rhs = categorical_kl(posteriors_logits, priors_logits.detach(), discrete_size)
    if kl_free_avg:
        loss_lhs = torch.clamp(lhs.mean(), min=kl_free_nats)
        loss_rhs = torch.clamp(rhs.mean(), min=kl_free_nats)
    else:
        loss_lhs = torch.clamp(lhs, min=kl_free_nats).mean()
        loss_rhs = torch.clamp(rhs, min=kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if continue_log_prob is not None:
        continue_loss = discount_scale_factor * -continue_log_prob.mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    loss = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return loss, kl.mean(), kl_loss, reward_loss, observation_loss, continue_loss
