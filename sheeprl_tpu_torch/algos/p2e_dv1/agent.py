"""Plan2Explore on the Dreamer-V1 backbone (port of
``sheeprl_tpu/algos/p2e_dv1/agent.py``): the Dreamer-V1 agent, whose
``actor``/``critic`` are the task heads, plus an exploration actor, an
exploration critic (no target network) and a disagreement ensemble of ``n``
members that predict the next observation embedding from ``(z, h, a)``.

The checkpoint layout is the JAX package's: ``{"world_model", "actor_task",
"critic_task", "actor_exploration", "critic_exploration", "ensembles"}``
(``interop/flax_to_torch.py``: :func:`p2e_dv_to_flax`,
:func:`load_p2e_dv_params`). :func:`attach_p2e_heads` also builds the
Plan2Explore heads of the Dreamer-V2 backbone.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import DV1Agent
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_dv1_agent
from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2
from sheeprl_tpu_torch.algos.p2e_dv3.agent import EnsembleHeads


def attach_p2e_heads(agent, fabric, cfg, actions_dim: Sequence[int], seed: int, output_dim: int,
                     agent_state: Optional[Dict[str, Any]] = None, targets: bool = False):
    """Give a Dreamer-V1/V2 agent its Plan2Explore heads:
    ``actor_exploration`` and ``critic_exploration`` (with ``targets``, a
    ``target_critic_exploration`` copy), initialized as the task heads are
    from a CPU generator, and ``ensembles`` (Dreamer-V3's ``MLPHead``s with
    ``algo.ensembles.dense_act``) predicting ``output_dim`` features. Then
    the agent moves to ``fabric.device`` and loads ``agent_state`` (a
    P2E-layout params tree) when one is given."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_p2e_dv_params

    generator = torch.Generator().manual_seed(int(seed) + 1)
    agent.actor_exploration = copy.deepcopy(agent.actor).cpu()
    agent.actor_exploration.init_weights(generator)
    agent.critic_exploration = copy.deepcopy(agent.critic).cpu()
    agent.critic_exploration.init_weights(generator)
    if targets:
        agent.target_critic_exploration = copy.deepcopy(agent.critic_exploration)
    ens_cfg = cfg.algo.ensembles
    agent.ensembles = EnsembleHeads(
        n=int(ens_cfg.n),
        in_dim=agent.latent_state_size + int(np.sum(actions_dim)),
        units=int(ens_cfg.dense_units),
        n_layers=int(ens_cfg.mlp_layers),
        output_dim=int(output_dim),
        activation=ens_cfg.dense_act,
        dtype=fabric.compute_dtype,
    )
    agent.ensembles.init_weights(generator)
    agent = agent.to(fabric.device)
    if agent_state is not None:
        load_p2e_dv_params(agent, agent_state)
    return agent


def build_agent(fabric, actions_dim, is_continuous: bool, cfg, obs_space, seed: int,
                agent_state: Optional[Dict[str, Any]] = None) -> DV1Agent:
    """The Dreamer-V1 agent with its Plan2Explore heads on ``fabric.device``;
    the ensemble predicts the encoder's output, the observation embedding."""
    agent = build_dv1_agent(fabric, actions_dim, is_continuous, cfg, obs_space, seed)
    return attach_p2e_heads(agent, fabric, cfg, actions_dim, seed, agent.encoder.out_dim, agent_state)


def make_player(actor_type: str):
    """A ``player_cls`` acting with ``actor_type``'s actor (``player_params``
    of the JAX package): the exploration one, or the task one."""
    if actor_type not in ("exploration", "task"):
        raise ValueError(f"algo.player.actor_type must be 'exploration' or 'task', got {actor_type!r}")

    def player_cls(agent, num_envs: int, cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> PlayerDV2:
        actor = agent.actor_exploration if actor_type == "exploration" else agent.actor
        return PlayerDV2(agent, num_envs, cnn_keys, mlp_keys, actor=actor)

    return player_cls
