"""Offline Dreamer evaluation (port of
``sheeprl_tpu/algos/offline_dreamer/evaluate.py``): one test episode of a
checkpoint, the actor reading the CEM latent."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate as evaluate_dv3
from sheeprl_tpu_torch.algos.offline_dreamer.agent import build_agent


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_dv3(fabric, cfg, state, build_agent_fn=build_agent)
