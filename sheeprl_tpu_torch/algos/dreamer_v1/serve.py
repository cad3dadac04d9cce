"""Dreamer-V1 serving policy (port of ``sheeprl_tpu/algos/dreamer_v1/serve.py``):
Dreamer-V2's serving shape with Dreamer-V1's Gaussian stochastic state."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.serve import serve_policy
from sheeprl_tpu_torch.serve.policy import ServePolicy


def get_serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    return serve_policy(fabric, cfg, state, "dreamer_v1", build_agent)
