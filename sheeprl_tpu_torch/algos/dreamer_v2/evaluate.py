"""Dreamer-V2 evaluation (port of ``sheeprl_tpu/algos/dreamer_v2/evaluate.py``):
one test episode of a checkpoint's agent, sampling its actions."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate as evaluate_dreamer


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, build_agent_fn=build_agent, player_cls=PlayerDV2)
