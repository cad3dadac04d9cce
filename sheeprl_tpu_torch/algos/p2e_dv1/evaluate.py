"""Plan2Explore (Dreamer-V1) evaluation (port of
``sheeprl_tpu/algos/p2e_dv1/evaluate.py``): one test episode of an
exploration checkpoint (acting with the task actor) or of a finetuning one
(Dreamer-V1's layout), sampling its actions."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_dv1_agent
from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate as evaluate_dreamer
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent


def evaluate_p2e(fabric, cfg: Dict[str, Any], state: Dict[str, Any], build_p2e, build_dreamer) -> float:
    """The P2E agent's episode (its ``actor`` is the task actor), or the
    backbone's for a checkpoint in the backbone's layout."""
    p2e_layout = state is None or "actor_task" in state["agent"]
    return evaluate_dreamer(fabric, cfg, state, build_agent_fn=build_p2e if p2e_layout else build_dreamer,
                            player_cls=PlayerDV2)


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    return evaluate_p2e(fabric, cfg, state, build_agent, build_dv1_agent)
