"""Dreamer-V1 training (port of ``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``).

:class:`DV1Trainer` is the gradient step of ``make_train_phase``, eager: the
world-model loss over the Gaussian posterior scan (one KL with free nats),
the actor loss backpropagated through the imagined dynamics
(``-mean(discount * λ-returns)``, the critic's values, no target critic),
then the critic's unit-variance normal loss, each with its clipped Adam
step. The loop is Dreamer-V2's (``run_family``) on the sequential buffer
(the JAX Dreamer-V1 loop has no episode buffer).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer, build_optimizers, run_family
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normal1_logprob
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import Batch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _normal_entropy(std: torch.Tensor) -> torch.Tensor:
    return (0.5 + _HALF_LOG_2PI + torch.log(std)).sum(-1).mean()


class DV1Trainer(DV2Trainer):
    """The Dreamer-V1 gradient step (module docstring)."""

    def world_loss(self, batch: Batch, noise: torch.Tensor):
        agent, wm_cfg = self.agent, self.wm_cfg
        batch_obs, _, actions = self.observe(batch)
        embedded = agent.encoder(batch_obs)
        hs, zs, post_mean, post_std, prior_mean, prior_std = agent.dynamic_scan(embedded, actions, noise)
        obs_lps, reward_lp, cont_lp = self.reconstruction_log_probs(batch, batch_obs, torch.cat([zs, hs], dim=-1))
        loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            obs_lps,
            reward_lp,
            post_mean,
            post_std,
            prior_mean,
            prior_std,
            kl_free_nats=wm_cfg.kl_free_nats,
            kl_regularizer=wm_cfg.kl_regularizer,
            continue_log_prob=cont_lp,
            continue_scale_factor=wm_cfg.continue_scale_factor,
        )
        metrics = {
            "Loss/world_model_loss": loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl,
            "State/post_entropy": _normal_entropy(post_std.detach()),
            "State/prior_entropy": _normal_entropy(prior_std.detach()),
        }
        return loss, (zs, hs, embedded, metrics)

    def actor_loss(self, zs, hs, true_continue, transition_noise, action_noise, actor=None, critic=None,
                   reward_fn=None):
        """Returns (policy loss, (latents, λ-values, discount, rewards)); the
        gradient reaches the actor through the imagined dynamics. ``actor``,
        ``critic`` (whose values the λ-returns take) and ``reward_fn(latents,
        actions)`` default to the agent's actor, critic and reward head."""
        agent, wm = self.agent, self.agent.world_model
        critic = agent.critic if critic is None else critic
        z0 = zs.detach().reshape(-1, agent.stoch_state_size)
        h0 = hs.detach().reshape(-1, agent.recurrent_state_size)
        latents, actions = agent.imagination_scan(z0, h0, self.horizon, transition_noise, action_noise, actor=actor)
        values = critic(latents)
        rewards = wm["reward_model"](latents) if reward_fn is None else reward_fn(latents, actions)
        if self.use_continues:
            continues = torch.sigmoid(wm["continue_model"](latents))
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(rewards, values, continues, self.horizon, self.lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], dim=0), dim=0).detach()
        return -torch.mean(discount * lambda_values), (latents, lambda_values, discount, rewards)

    def critic_loss(self, latents, lambda_values, discount, critic=None):
        critic = self.agent.critic if critic is None else critic
        lp = normal1_logprob(critic(latents[:-1]), lambda_values.detach(), 1)
        return -torch.mean(discount[..., 0] * lp)

    def update_target_critic(self, cum: int) -> None:
        """Dreamer-V1 has no target critic."""


def make_trainer(agent, cfg) -> DV1Trainer:
    return DV1Trainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any], exploration_actor: Optional[Any] = None, **finetune: Any) -> Dict[str, Any]:
    """``exploration_actor`` and ``finetune`` as Dreamer-V2's ``main`` takes them
    (Plan2Explore's finetuning)."""
    return run_family(fabric, cfg, build_agent_fn=build_agent, make_trainer_fn=make_trainer,
                      exploration_actor=exploration_actor, **finetune)
