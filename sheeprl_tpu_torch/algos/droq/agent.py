"""The DroQ agent (port of ``sheeprl_tpu/algos/droq/agent.py``): SAC's actor
and a critic ensemble whose members put Dropout and LayerNorm after every
hidden projection (``Dense -> Dropout -> LayerNorm -> ReLU``,
arXiv:2110.02034). Each member takes its own keep-masks."""

from __future__ import annotations

from typing import Any, Dict, Optional

from sheeprl_tpu_torch.algos.sac import agent as sac_agent
from sheeprl_tpu_torch.algos.sac.agent import CriticEnsemble, SACAgent


class DROQCriticEnsemble(CriticEnsemble):
    """``n`` DroQ critics with stacked parameters; ``forward(obs, action,
    keep)`` takes ``[n, rows, hidden]`` keep-masks per hidden layer (none:
    deterministic)."""

    flax_name = "VmapDROQCritic_0"

    def __init__(self, input_dim: int, n: int, hidden_size: int, dropout: float = 0.0) -> None:
        super().__init__(input_dim, n, hidden_size, layer_norm=True, dropout=dropout)


def build_agent(
    fabric, cfg, observation_space, action_space, seed: int, agent_state: Optional[Dict[str, Any]] = None
) -> SACAgent:
    """SAC's ``build_agent`` with the DroQ critics (``algo.critic.dropout``)."""
    return sac_agent.build_agent(
        fabric, cfg, observation_space, action_space, seed, agent_state,
        critic_cls=DROQCriticEnsemble, dropout=float(cfg.algo.critic.dropout),
    )
