"""Offline Dreamer agent (port of ``sheeprl_tpu/algos/offline_dreamer/agent.py``):
Dreamer-V3 with a concept-bottleneck world model.

The concept embedding module (:class:`CEM`) maps the RSSM latent ``concat(z,
h)`` to ``sum(concept_bins)`` concept probabilities, one embedding per
concept and one residual embedding; every head (decoder, reward, continue,
actor, critic) reads that concept latent instead of the raw one. The CEM is
the world model's ``cem`` module (``world_model/cem`` in the checkpoint).
With ``algo.world_model.cbm_model.use_cbm=False`` the agent is Dreamer-V3's.

:class:`ODV3Agent` applies the CEM in ``head_latent``, so the Dreamer-V3
imagination rollout and player apply it at every step as the JAX agent's own
``imagination_scan`` and ``PlayerODV3`` do: the port's ``PlayerDV3`` plays
an ``ODV3Agent`` as the JAX package's ``PlayerODV3`` plays its agent.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as build_dv3_agent
from sheeprl_tpu_torch.models.models import dense, lecun_init_
from sheeprl_tpu_torch.utils.distribution import softmax


class CEM(nn.Module):
    """Concept Embedding Module. For concept ``c`` a context layer
    (``context_c``) makes ``concept_bins[c]`` candidate embeddings of
    ``emb_size``, a prob layer (``prob_c``) scores the bins from them, and the
    concept's embedding is the prob-weighted sum of its candidates; one more
    context layer (``context_<n_concepts>``) makes the residual embedding.
    Returns ``(concat(all bin probs, all concept embeddings, residual), all
    bin logits, the concept embeddings, the residual)``."""

    def __init__(
        self,
        latent_dim: int,
        n_concepts: int,
        concept_bins: Sequence[int],
        emb_size: int,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_concepts = int(n_concepts)
        self.concept_bins = tuple(int(b) for b in concept_bins)
        self.emb_size = int(emb_size)
        self.dtype = dtype
        if len(self.concept_bins) != self.n_concepts:
            raise ValueError(f"cbm_model: {self.n_concepts} concepts but {len(self.concept_bins)} concept_bins")
        self.contexts = nn.ModuleList(nn.Linear(latent_dim, b * self.emb_size) for b in self.concept_bins)
        self.probs = nn.ModuleList(nn.Linear(b * self.emb_size, b) for b in self.concept_bins)
        self.residual = nn.Linear(latent_dim, self.emb_size)

    @property
    def out_dim(self) -> int:
        return sum(self.concept_bins) + (self.n_concepts + 1) * self.emb_size

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's ``Dense`` default (LeCun normal kernels, zero biases)."""
        for layer in [*self.contexts, *self.probs, self.residual]:
            lecun_init_(layer, generator)

    def forward(self, latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        probs_blocks, logits_blocks, emb_blocks = [], [], []
        for bins, context_layer, prob_layer in zip(self.concept_bins, self.contexts, self.probs):
            context = dense(context_layer, latent, self.dtype)
            logits = dense(prob_layer, context, self.dtype)
            probs = softmax(logits, dim=-1)
            candidates = context.reshape(*context.shape[:-1], bins, self.emb_size)
            emb_blocks.append(torch.sum(candidates * probs[..., None], dim=-2))
            probs_blocks.append(probs)
            logits_blocks.append(logits)
        residual = dense(self.residual, latent, self.dtype)
        concept_emb = torch.cat(emb_blocks, dim=-1)
        cem_latent = torch.cat([torch.cat(probs_blocks, dim=-1), concept_emb, residual], dim=-1)
        return cem_latent, torch.cat(logits_blocks, dim=-1), concept_emb, residual


def cem_latent_size(cfg) -> int:
    cbm = cfg.algo.world_model.cbm_model
    return int(sum(cbm.concept_bins) + (cbm.n_concepts + 1) * cbm.emb_size)


class ODV3Agent(DV3Agent):
    """``DV3Agent`` whose heads read the CEM latent when the world model holds a ``cem``."""

    @property
    def use_cbm(self) -> bool:
        return "cem" in self.world_model

    @property
    def cem(self) -> Optional[CEM]:
        return self.world_model["cem"] if self.use_cbm else None

    def apply_cem(self, latent: torch.Tensor):
        """(head latent, concept logits, concept embeddings, residual); the
        latent itself and ``None``s without the bottleneck."""
        if not self.use_cbm:
            return latent, None, None, None
        return self.world_model["cem"](latent)

    def head_latent(self, latent: torch.Tensor) -> torch.Tensor:
        return self.apply_cem(latent)[0]



def build_agent(
    fabric,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
) -> ODV3Agent:
    """The Dreamer-V3 build with every head reading the CEM latent
    (``use_cbm``) and the CEM in the world model; without the bottleneck, the
    Dreamer-V3 agent."""
    wm_cfg = cfg.algo.world_model
    if wm_cfg.get("decoupled_rssm", False):
        raise NotImplementedError("decoupled_rssm is not implemented yet; set algo.world_model.decoupled_rssm=False")
    cbm = wm_cfg.cbm_model
    extra, head = None, None
    if bool(cbm.use_cbm):
        latent = wm_cfg.stochastic_size * wm_cfg.discrete_size + wm_cfg.recurrent_model.recurrent_state_size
        cem = CEM(latent, cbm.n_concepts, cbm.concept_bins, cbm.emb_size, fabric.compute_dtype)
        extra, head = {"cem": cem}, cem.out_dim
    return build_dv3_agent(
        fabric,
        actions_dim,
        is_continuous,
        cfg,
        obs_space,
        seed,
        agent_state,
        head_latent_size=head,
        extra_world_model=extra,
        agent_cls=ODV3Agent,
    )
