"""Dreamer-V1 support (port of ``sheeprl_tpu/algos/dreamer_v1/utils.py``): the
metric keys and Dreamer-V1's λ-returns; ``prepare_obs`` and ``test`` are
Dreamer-V3's, as the JAX module takes Dreamer-V2's."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.utils import AGGREGATOR_KEYS  # noqa: F401 (the same metrics)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401 (shared)

MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, horizon: int, lmbda: float = 0.95
) -> torch.Tensor:
    """Dreamer-V1's λ-returns, ``horizon - 1`` of them: ``ret[t] = r[t] +
    c[t] v'[t] + λ c[t] ret[t+1]`` with ``v'[t] = (1 - λ) v[t+1]`` but for the
    last, which bootstraps with the whole ``v[H-1]``. Accumulated in float32."""
    rewards, values, continues = rewards.float(), values.float(), continues.float()
    next_values = torch.cat([values[1:-1] * (1 - lmbda), values[-1:]], dim=0)
    deltas = rewards[: horizon - 1] + next_values * continues[: horizon - 1]
    agg, out = torch.zeros_like(values[0]), []
    for t in range(horizon - 2, -1, -1):
        agg = deltas[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1], dim=0)
