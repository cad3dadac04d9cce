"""Plan2Explore (Dreamer-V2) evaluation (port of
``sheeprl_tpu/algos/p2e_dv2/evaluate.py``): as Plan2Explore-DV1's, on the
Dreamer-V2 backbone."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_dv2_agent
from sheeprl_tpu_torch.algos.p2e_dv1.evaluate import evaluate_p2e
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_p2e(fabric, cfg, state, build_agent, build_dv2_agent)
