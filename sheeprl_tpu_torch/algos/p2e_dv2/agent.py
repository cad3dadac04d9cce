"""Plan2Explore on the Dreamer-V2 backbone (port of
``sheeprl_tpu/algos/p2e_dv2/agent.py``): the Dreamer-V2 agent, whose
``actor``/``critic``/``target_critic`` are the task heads, plus an
exploration actor, an exploration critic with its target, and a disagreement
ensemble of ``n`` members that predict the next stochastic state (the
``stochastic_size x discrete_size`` one-hots) from ``(z, h, a)``.

The checkpoint layout is the JAX package's: ``{"world_model", "actor_task",
"critic_task", "target_critic_task", "actor_exploration",
"critic_exploration", "target_critic_exploration", "ensembles"}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from sheeprl_tpu_torch.algos.dreamer_v2.agent import DV2Agent
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent as build_dv2_agent
from sheeprl_tpu_torch.algos.p2e_dv1.agent import attach_p2e_heads, make_player  # noqa: F401 (shared)


def build_agent(fabric, actions_dim, is_continuous: bool, cfg, obs_space, seed: int,
                agent_state: Optional[Dict[str, Any]] = None) -> DV2Agent:
    """The Dreamer-V2 agent with its Plan2Explore heads on ``fabric.device``."""
    agent = build_dv2_agent(fabric, actions_dim, is_continuous, cfg, obs_space, seed)
    return attach_p2e_heads(agent, fabric, cfg, actions_dim, seed, agent.stoch_state_size, agent_state, targets=True)
