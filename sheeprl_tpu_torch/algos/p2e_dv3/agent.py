"""Plan2Explore on the Dreamer-V3 backbone (port of
``sheeprl_tpu/algos/p2e_dv3/agent.py``): the Dreamer-V3 agent, whose
``actor``/``critic``/``target_critic`` are the task heads, plus a
disagreement ensemble, an exploration actor and one critic (with its target)
per exploration reward stream.

The checkpoint layout is the JAX package's: ``{"world_model", "actor_task",
"critic_task", "target_critic_task", "actor_exploration",
"critics_exploration": {k: {"module", "target"}}, "ensembles"}``
(``interop/flax_to_torch.py``: :func:`p2e_to_flax`, :func:`load_p2e_params`).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent, PlayerDV3, hafner_init_
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as build_dv3_agent
from sheeprl_tpu_torch.models.models import cast, resolve_activation


class EnsembleHeads(nn.Module):
    """``n`` Dreamer-V3 ``MLPHead``s of one layout on a shared input, their
    parameters stacked over a leading member axis as Flax's ``nn.vmap`` leaves
    them: per stack layer a bias-free ``kernel [n, in, units]`` and a
    LayerNorm ``scale``/``bias [n, units]``, then the head's ``kernel [n,
    units, out]`` and ``bias [n, out]``. Each layer is one batched product
    over the members. ``forward`` maps ``[..., in]`` to ``[n, ..., out]`` in
    the compute ``dtype``, rounding where Flax's bf16 ``Dense`` and
    ``LayerNorm`` round."""

    def __init__(
        self,
        n: int,
        in_dim: int,
        units: int,
        n_layers: int,
        output_dim: int,
        activation: Any = "silu",
        eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n = int(n)
        self.act = resolve_activation(activation)
        self.eps = float(eps)
        self.dtype = dtype
        dims = [in_dim] + [units] * n_layers
        self.kernels = nn.ParameterList(nn.Parameter(torch.zeros(n, dims[i], units)) for i in range(n_layers))
        self.ln_scales = nn.ParameterList(nn.Parameter(torch.ones(n, units)) for _ in range(n_layers))
        self.ln_biases = nn.ParameterList(nn.Parameter(torch.zeros(n, units)) for _ in range(n_layers))
        self.head_kernel = nn.Parameter(torch.zeros(n, dims[-1], output_dim))
        self.head_bias = nn.Parameter(torch.zeros(n, output_dim))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Hafner truncated normal for every member's kernels (the head's
        too: the JAX ensemble gives its heads no init scale)."""
        for kernel in [*self.kernels, self.head_kernel]:
            for member in kernel:
                hafner_init_(member, "kernel", generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        dtype = self.dtype
        h = x.to(dtype).reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1)
        for kernel, scale, bias in zip(self.kernels, self.ln_scales, self.ln_biases):
            h = torch.bmm(h, cast(kernel, dtype))
            # Flax's LayerNorm: float32 statistics and affine map, one rounding
            normed = F.layer_norm(h.float(), (h.shape[-1],), eps=self.eps)
            h = self.act((normed * scale.unsqueeze(1) + bias.unsqueeze(1)).to(dtype))
        out = torch.bmm(h, cast(self.head_kernel, dtype)) + cast(self.head_bias, dtype).unsqueeze(1)
        return out.reshape(self.n, *lead, out.shape[-1])


def intrinsic_reward(ensemble_out: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The disagreement reward: the members' variance of the predicted next
    posterior [n, ..., S*D], averaged over its features, times
    ``multiplier``; [..., 1] in the ensemble's dtype. The reductions run in
    float32 and round once each, as ``jnp.var`` and ``jnp.mean`` do on bf16."""
    dtype = ensemble_out.dtype
    var = ensemble_out.float().var(dim=0, correction=0).to(dtype)
    return var.float().mean(dim=-1, keepdim=True).to(dtype) * multiplier


def build_agent(
    fabric,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
) -> DV3Agent:
    """The Dreamer-V3 agent (task heads as ``actor``/``critic``/``target_critic``)
    with ``actor_exploration``, ``critics_exploration`` (``{k: {"module",
    "target"}}``, one per ``algo.critics_exploration`` entry, in its order) and
    ``ensembles`` attached, on ``fabric.device``: initialized from ``seed``, or
    loaded from a checkpoint's P2E-layout ``agent_state``."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_p2e_params

    agent = build_dv3_agent(fabric, actions_dim, is_continuous, cfg, obs_space, seed)
    # the new heads are initialized on the CPU, from a CPU generator, as the
    # Dreamer-V3 build initializes its modules
    generator = torch.Generator().manual_seed(int(seed) + 1)
    actor_exploration = copy.deepcopy(agent.actor).cpu()
    actor_exploration.init_weights(generator)
    critics = nn.ModuleDict()
    for name in dict(cfg.algo.critics_exploration):
        critic = copy.deepcopy(agent.critic).cpu()
        critic.init_weights(generator)
        critics[name] = nn.ModuleDict({"module": critic, "target": copy.deepcopy(critic)})
    ens_cfg = cfg.algo.ensembles
    ensembles = EnsembleHeads(
        n=int(ens_cfg.n),
        in_dim=agent.latent_state_size + int(np.sum(actions_dim)),
        units=int(ens_cfg.dense_units),
        n_layers=int(ens_cfg.mlp_layers),
        output_dim=agent.stoch_state_size,
        activation=ens_cfg.dense_act,
        dtype=fabric.compute_dtype,
    )
    ensembles.init_weights(generator)
    agent.actor_exploration, agent.critics_exploration, agent.ensembles = actor_exploration, critics, ensembles
    agent = agent.to(fabric.device)
    if agent_state is not None:
        load_p2e_params(agent, agent_state)
    return agent


def player_actor(agent: DV3Agent, actor_type: str) -> nn.Module:
    """The actor a player acts with: the exploration one, or the task one."""
    if actor_type not in ("exploration", "task"):
        raise ValueError(f"algo.player.actor_type must be 'exploration' or 'task', got {actor_type!r}")
    return agent.actor_exploration if actor_type == "exploration" else agent.actor


def make_player(actor_type: str):
    """A ``player_cls`` for ``run_dreamer``: ``PlayerDV3`` acting with
    ``actor_type``'s actor (``player_params`` of the JAX package)."""

    def player_cls(agent: DV3Agent, num_envs: int, cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> PlayerDV3:
        return PlayerDV3(agent, num_envs, cnn_keys, mlp_keys, actor=player_actor(agent, actor_type))

    return player_cls
