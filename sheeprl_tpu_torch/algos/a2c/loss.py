"""A2C losses (port of ``sheeprl_tpu/algos/a2c/loss.py``)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.ppo.loss import reduce


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce(-(logprobs * advantages), reduction)


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return reduce(torch.square(values - returns), reduction)
