"""Dreamer-V3 world-model loss (port of ``sheeprl_tpu/algos/dreamer_v3/loss.py``).

Takes per-element log-probs and the prior/posterior logits, returns the scalar
loss and its parts. KL balancing: 0.5 of the dynamics KL and 0.1 of the
representation KL, each clipped below at the free nats.
"""

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
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    continue_log_prob: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, kl, state_loss, reward_loss, observation_loss, continue_loss).

    The log-probs are per element, [T, B]; the logits are [T, B, S*D]."""
    observation_loss = -sum(observation_log_probs.values())
    reward_loss = -reward_log_prob
    kl = categorical_kl(posteriors_logits.detach(), priors_logits, discrete_size)
    dyn_loss = kl_dynamic * torch.clamp(kl, min=kl_free_nats)
    repr_kl = categorical_kl(posteriors_logits, priors_logits.detach(), discrete_size)
    repr_loss = kl_representation * torch.clamp(repr_kl, min=kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    if continue_log_prob is not None:
        continue_loss = continue_scale_factor * -continue_log_prob
    else:
        continue_loss = torch.zeros_like(reward_loss)
    loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return (
        loss,
        kl.mean(),
        kl_loss.mean(),
        reward_loss.mean(),
        observation_loss.mean(),
        continue_loss.mean(),
    )
