"""Dreamer-V2 serving policy (port of ``sheeprl_tpu/algos/dreamer_v2/serve.py``):
the shared Dreamer serving shape with Dreamer-V2's zero initial carry, its
straight-through categorical posterior and its actor. The LN-GRU kernel runs
once a tick at ``[slots, K]``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent, player_step
from sheeprl_tpu_torch.algos.dreamer_v3.serve import dreamer_serve_policy
from sheeprl_tpu_torch.interop.flax_to_torch import dv2_to_flax, load_dv2_params
from sheeprl_tpu_torch.serve.policy import NoiseSpec, ServePolicy


def init_slots(agent, n: int) -> Dict[str, torch.Tensor]:
    """``n`` fresh carries: zero previous action, recurrent and stochastic states."""
    h, z = agent.zero_state(n)
    return {"action": torch.zeros((n, int(np.sum(agent.actions_dim))), device=h.device), "h": h, "z": z}


def noise_spec(agent, greedy: bool) -> Dict[str, NoiseSpec]:
    """The posterior's noise (Gumbel for Dreamer-V2's categoricals, normal for
    Dreamer-V1's Gaussian); the actor's unless greedy: uniform for the
    TruncatedNormal, Gumbel for discrete heads."""
    spec = {"repr": NoiseSpec(agent.state_noise, agent.stoch_state_size)}
    if not greedy:
        spec["act"] = NoiseSpec("uniform" if agent.is_continuous else "gumbel", int(np.sum(agent.actions_dim)))
    return spec


def serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any], family: str, build_agent_fn) -> ServePolicy:
    """The Dreamer-V1/V2 serving policy of ``build_agent_fn``'s agent."""
    return dreamer_serve_policy(
        fabric,
        cfg,
        state,
        family=family,
        build_agent_fn=build_agent_fn,
        init_slots=init_slots,
        step_fn=player_step,
        noise_spec=noise_spec,
        params_tree=dv2_to_flax,
        load_params=load_dv2_params,
    )


def get_serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    return serve_policy(fabric, cfg, state, "dreamer_v2", build_agent)
