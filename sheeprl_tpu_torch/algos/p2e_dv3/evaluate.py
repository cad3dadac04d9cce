"""Plan2Explore (Dreamer-V3) evaluation (port of
``sheeprl_tpu/algos/p2e_dv3/evaluate.py``): one test episode of an exploration
or a finetuning checkpoint, acting with the task actor."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate as evaluate_dv3
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_dv3(fabric, cfg, state, build_agent_fn=build_agent)
