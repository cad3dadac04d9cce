"""DroQ evaluation (port of ``sheeprl_tpu/algos/droq/evaluate.py``): SAC's,
with the DroQ agent."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.evaluate import evaluate_with


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_with(build_agent, fabric, cfg, state)
