"""Dreamer-V2 support (port of ``sheeprl_tpu/algos/dreamer_v2/utils.py``): the
unit-variance normal and soft-target Bernoulli log-probs, the bootstrapped
λ-returns, the metric keys; ``prepare_obs`` and ``test`` are Dreamer-V3's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401 (shared with Dreamer-V3)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}


def _sum_rightmost(x: torch.Tensor, event_dims: int) -> torch.Tensor:
    return x.sum(dim=tuple(range(-event_dims, 0)))


def normal1_logprob(pred: torch.Tensor, target: torch.Tensor, event_dims: int) -> torch.Tensor:
    """log N(target | pred, 1) summed over the rightmost ``event_dims`` dims."""
    return _sum_rightmost(-0.5 * torch.square(target - pred) - _HALF_LOG_2PI, event_dims)


def bernoulli_logprob(logits: torch.Tensor, target: torch.Tensor, event_dims: int) -> torch.Tensor:
    """Soft-target Bernoulli log-prob: the continue targets are
    ``(1 - terminated) * gamma``, not 0/1."""
    return _sum_rightmost(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits), event_dims)


def compute_lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    bootstrap: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """The DV2 λ-returns with an explicit bootstrap, [H, ...]:
    ``ret[t] = r[t] + c[t] ((1 - λ) v[t+1] + λ ret[t+1])``, ``v[H] = ret[H] =
    bootstrap``. Accumulated in float32."""
    rewards, values, continues, bootstrap = (t.float() for t in (rewards, values, continues, bootstrap))
    next_values = torch.cat([values[1:], bootstrap], dim=0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg, out = bootstrap[0], []
    for t in range(rewards.shape[0] - 1, -1, -1):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1], dim=0)
