"""Offline Dreamer training (port of
``sheeprl_tpu/algos/offline_dreamer/offline_dreamer.py``): the Dreamer-V3 loop
with two injected pieces, the concept-bottleneck agent and a trainer whose
world-model loss passes the latent through the CEM and adds the concept and
orthogonality terms (:class:`ODV3Trainer`'s latent hook); the Dreamer-V3
player acts on the agent's head latent, which is the CEM latent.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers, run_dreamer
from sheeprl_tpu_torch.algos.offline_dreamer.agent import ODV3Agent, build_agent
from sheeprl_tpu_torch.algos.offline_dreamer.loss import cbm_loss


class ODV3Trainer(DV3Trainer):
    """The Dreamer-V3 step with the CEM world-latent hook when ``use_cbm``.
    The hook's noise, ``noise["hook"]``, is a standard normal latent of the
    scan's [T, B, L] (the random pass the orthogonality term also reads) and
    the concept targets, Bernoulli(0.5) draws of the concept logits'
    [T, B, sum(bins)], both in the compute dtype."""

    def __init__(self, agent: ODV3Agent, cfg, optimizers: Dict[str, torch.optim.Optimizer]):
        super().__init__(agent, cfg, optimizers, world_latent_hook=self.cbm_hook if agent.use_cbm else None)

    def draw_noise(self, T: int, B: int, generator: Optional[torch.Generator]) -> Dict[str, Any]:
        noise = super().draw_noise(T, B, generator)
        agent = self.agent
        if agent.use_cbm:
            bins = sum(agent.cem.concept_bins)
            noise["hook"] = {
                "random_latent": torch.randn(
                    (T, B, agent.latent_state_size), device=self.device, generator=generator
                ).to(agent.dtype),
                "concepts": (torch.rand((T, B, bins), device=self.device, generator=generator) < 0.5).to(agent.dtype),
            }
        return noise

    def cbm_hook(self, latents: torch.Tensor, noise: Dict[str, torch.Tensor]):
        agent = self.agent
        head_latents, concept_logits, concept_emb, residual = agent.apply_cem(latents)
        _, _, rand_emb, rand_residual = agent.apply_cem(noise["random_latent"])
        extra_loss, c_loss = cbm_loss(
            agent.cem, concept_logits, concept_emb, residual, rand_emb, rand_residual, noise["concepts"]
        )
        return head_latents, extra_loss, {"Loss/concept_loss": c_loss}


def make_trainer(agent: ODV3Agent, cfg) -> ODV3Trainer:
    return ODV3Trainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    # PlayerDV3 acts on the agent's head latent, the CEM latent here
    return run_dreamer(fabric, cfg, build_agent_fn=build_agent, make_trainer=make_trainer)
