"""Dreamer-V1 agent in PyTorch (port of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

A continuous-latent RSSM on the Dreamer-V2 blocks (``algos/dreamer_v2/agent.py``),
as the JAX agent reuses them: the representation and transition heads emit
(mean, raw std) chunks, the std is ``softplus + min_std``, and a state is a
reparameterized normal sample from standard normal noise. The recurrent cell
has no LayerNorm (``RecurrentModel(layer_norm=False)``): its step is
``torch.matmul`` and the GRU gating, so Dreamer-V1 launches no LN-GRU kernel.
The actor, its TruncatedNormal and exploration noise, and the player are
Dreamer-V2's. There is no target critic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    DV2Agent,
    actor_sample,
    actor_settings,
    build_modules,
    init_modules,
)
from sheeprl_tpu_torch.models.models import cast_once


def gaussian_state(mean_std: torch.Tensor, min_std: float, noise: Optional[torch.Tensor] = None):
    """((mean, std), state): the reparameterized sample ``mean + std * noise``,
    or the mean without noise."""
    mean, std_raw = torch.chunk(mean_std, 2, dim=-1)
    std = F.softplus(std_raw) + min_std
    return (mean, std), mean if noise is None else mean + std * noise


def normal_kl(mean_p, std_p, mean_q, std_q) -> torch.Tensor:
    """KL(N(p) || N(q)) summed over the last axis."""
    kl = torch.log(std_q / std_p) + (torch.square(std_p) + torch.square(mean_p - mean_q)) / (2 * torch.square(std_q)) - 0.5
    return kl.sum(dim=-1)


class DV1Agent(DV2Agent):
    """Dreamer-V2's agent with Gaussian stochastic states of
    ``stochastic_size`` variables and no target critic."""

    state_noise = "normal"

    def __init__(self, *args, min_std: float = 0.1, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.min_std = float(min_std)

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size

    def draw_state_noise(self, shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        return torch.randn((*shape, self.stochastic_size), device=device, generator=generator)

    def _representation(self, h, embedded, noise):
        return gaussian_state(
            self.world_model["representation_model"](torch.cat([h, embedded], dim=-1)), self.min_std, noise
        )

    def _transition(self, h, noise):
        return gaussian_state(self._prior(h), self.min_std, noise)

    @cast_once()
    def dynamic_scan(self, embedded, actions, noise):
        """Posterior/prior unroll from zero states, without ``is_first``
        masking (as Dreamer-V1's). ``noise`` [T, B, S] is the posterior
        samples' standard normal noise. Returns (hs, zs, post_mean, post_std,
        prior_mean, prior_std), time-major."""
        T, B = embedded.shape[:2]
        h, z = self.zero_state(B, embedded.device)
        outs = []
        for t in range(T):
            h = self._recurrent(z, actions[t], h)
            (prior_mean, prior_std), _ = self._transition(h, None)
            (post_mean, post_std), z = self._representation(h, embedded[t], noise[t])
            outs.append((h, z, post_mean, post_std, prior_mean, prior_std))
        return tuple(torch.stack(x) for x in zip(*outs))

    @cast_once()
    def imagination_scan(self, z0, h0, horizon: int, transition_noise, action_noise, actor=None):
        """DV1 imagination: per step the actor acts on the detached latent,
        then the recurrent step and the prior sample; gradients flow through
        the dynamics. Returns the ``horizon`` imagined (latents, actions)."""
        actor = self.actor if actor is None else actor
        z, h = z0, h0
        latent = torch.cat([z, h], dim=-1)
        latents, actions = [], []
        for t in range(horizon):
            a = actor_sample(self, actor(latent.detach()), action_noise[t])
            h = self._recurrent(z, a, h)
            _, z = self._transition(h, transition_noise[t])
            latent = torch.cat([z, h], dim=-1)
            latents.append(latent)
            actions.append(a)
        return torch.stack(latents), torch.stack(actions)


def build_agent(fabric, actions_dim, is_continuous: bool, cfg, obs_space, seed: int,
                agent_state: Optional[Dict[str, Any]] = None) -> DV1Agent:
    """The Dreamer-V1 agent on ``fabric.device``, from ``seed`` or a Flax-layout
    tree (``world_model``, ``actor``, ``critic``). Every block takes
    ``algo.layer_norm``; the recurrent cell has no LayerNorm."""
    if fabric.compute_dtype != torch.float32:
        raise NotImplementedError("Dreamer-V1 at bf16 is not yet ported to sheeprl_tpu_torch")
    wm_cfg = cfg.algo.world_model
    stochastic_size = int(wm_cfg.stochastic_size)
    layer_norm = bool(cfg.algo.get("layer_norm", False))
    modules = build_modules(
        cfg, obs_space, actions_dim, is_continuous, stoch_state_size=stochastic_size,
        posterior_dim=2 * stochastic_size, gru_layer_norm=False, layer_norm_of=lambda node: layer_norm,
    )
    agent = DV1Agent(
        modules["world_model"], modules["actor"], modules["critic"], None,
        actions_dim=actions_dim, is_continuous=is_continuous, stochastic_size=stochastic_size, discrete_size=1,
        recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size), actor_cfg=actor_settings(cfg),
        min_std=wm_cfg.min_std,
    )
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_to_torch import load_dv2_params

        load_dv2_params(agent, agent_state)
    else:
        init_modules(agent, torch.Generator().manual_seed(int(seed)))
    return agent.to(fabric.device)
