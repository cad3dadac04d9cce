"""Dreamer-V2 training (port of ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``).

:class:`DV2Trainer` is the gradient step of ``make_train_phase``, eager: the
hard copy of the critic into the target critic every
``per_rank_target_network_update_freq`` steps (before the step), the
world-model loss over the posterior scan (KL balancing), the actor loss over
the DV2 imagination (a zero first action, the actor before each step;
REINFORCE against the target critic mixed with the dynamics objective by
``objective_mix``), then the critic's unit-variance normal loss, each
followed by its own clipped optimizer step (AdamW with the exps' weight
decay). Every random draw is an argument: Gumbel noise for the categorical
samples, uniform noise for the TruncatedNormal actions.

The loop is ``run_dreamer``'s with the Dreamer-V2 pieces: the sequential or
the episode buffer (``buffer.type``), the exploration noise's anneal, no
Moments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    PlayerDV2,
    actor_logprob_entropy,
    build_agent,
    draw_actor_noise,
    expl_amount_at,
)
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import bernoulli_logprob, compute_lambda_values, normal1_logprob
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import Batch, DreamerTrainer, _cat_entropy, run_dreamer
from sheeprl_tpu_torch.config import instantiate


def param_groups(agent) -> Dict[str, List[torch.nn.Parameter]]:
    return {
        "world_model": list(agent.world_model.parameters()),
        "actor": list(agent.actor.parameters()),
        "critic": list(agent.critic.parameters()),
    }


def build_optimizers(cfg, agent) -> Dict[str, torch.optim.Optimizer]:
    groups = param_groups(agent)
    return {name: instantiate(cfg.algo[name].optimizer, groups[name]) for name in ("world_model", "actor", "critic")}


class DV2Trainer(DreamerTrainer):
    """The Dreamer-V2 gradient step (module docstring); Dreamer-V1's trainer
    builds on it."""

    def __init__(self, agent, cfg, optimizers: Dict[str, torch.optim.Optimizer]):
        self.agent = agent
        self.optimizers = optimizers
        self.groups = param_groups(agent)
        self.device = agent.device
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
        self.dec_keys = tuple(cfg.algo.cnn_keys.decoder) + tuple(cfg.algo.mlp_keys.decoder)
        self.wm_cfg = cfg.algo.world_model
        self.use_continues = bool(cfg.algo.world_model.use_continues)
        self.gamma = float(cfg.algo.gamma)
        self.lmbda = float(cfg.algo.lmbda)
        self.horizon = int(cfg.algo.horizon)
        self.ent_coef = float(cfg.algo.actor.get("ent_coef", 0.0))
        self.objective_mix = float(cfg.algo.actor.get("objective_mix", 1.0))
        self.target_freq = int(cfg.algo.critic.get("per_rank_target_network_update_freq", 1))
        self.clips = {name: float(cfg.algo[name].clip_gradients or 0) for name in ("world_model", "actor", "critic")}

    # -- noise ---------------------------------------------------------------------
    def draw_noise(self, T: int, B: int, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Every random draw of one gradient step: the posterior samples' noise
        [T, B, S*D], the imagined prior samples' [horizon, T*B, S*D] and the
        imagined actions' [horizon, T*B, A]."""
        agent, N = self.agent, T * B
        return {
            "posterior": agent.draw_state_noise((T, B), generator, self.device),
            "transition": agent.draw_state_noise((self.horizon, N), generator, self.device),
            "action": draw_actor_noise(agent, (self.horizon, N), generator, self.device),
        }

    # -- losses --------------------------------------------------------------------
    def observe(self, batch: Batch):
        """The batch's normalized observations, ``is_first`` with its first
        row set, and the actions that led to each observation."""
        batch_obs = {k: batch[k] / 255.0 - 0.5 for k in self.cnn_keys}
        batch_obs.update({k: batch[k] for k in self.mlp_keys})
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0)
        return batch_obs, is_first, actions

    def reconstruction_log_probs(self, batch: Batch, batch_obs, latents):
        """(observation log-probs per decoded key, reward log-prob, continue
        log-prob or None) of the world model's heads on ``latents``."""
        wm = self.agent.world_model
        recon = wm["observation_model"](latents)
        obs_lps = {k: normal1_logprob(recon[k], batch_obs[k], len(recon[k].shape[2:])) for k in self.dec_keys}
        reward_lp = normal1_logprob(wm["reward_model"](latents), batch["rewards"], 1)
        cont_lp = None
        if self.use_continues:
            cont_lp = bernoulli_logprob(wm["continue_model"](latents), (1.0 - batch["terminated"]) * self.gamma, 1)
        return obs_lps, reward_lp, cont_lp

    def world_loss(self, batch: Batch, noise: torch.Tensor):
        """Returns (loss, (posteriors, recurrent states, embeddings, metrics))."""
        agent, wm_cfg = self.agent, self.wm_cfg
        batch_obs, is_first, actions = self.observe(batch)
        embedded = agent.encoder(batch_obs)
        hs, zs, post_logits, prior_logits = agent.dynamic_scan(embedded, actions, is_first, noise)
        obs_lps, reward_lp, cont_lp = self.reconstruction_log_probs(batch, batch_obs, torch.cat([zs, hs], dim=-1))
        loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            obs_lps,
            reward_lp,
            prior_logits,
            post_logits,
            agent.discrete_size,
            kl_balancing_alpha=wm_cfg.kl_balancing_alpha,
            kl_free_nats=wm_cfg.kl_free_nats,
            kl_free_avg=wm_cfg.kl_free_avg,
            kl_regularizer=wm_cfg.kl_regularizer,
            continue_log_prob=cont_lp,
            discount_scale_factor=wm_cfg.discount_scale_factor,
        )
        metrics = {
            "Loss/world_model_loss": loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl,
            "State/post_entropy": _cat_entropy(post_logits.detach(), agent.discrete_size),
            "State/prior_entropy": _cat_entropy(prior_logits.detach(), agent.discrete_size),
        }
        return loss, (zs, hs, embedded, metrics)

    def actor_loss(self, zs, hs, true_continue, transition_noise, action_noise, actor=None, critic=None,
                   reward_fn: Optional[Callable] = None):
        """Returns (policy loss, (latents, λ-values, discount, rewards)).
        ``actor`` imagines and is scored (the agent's by default), ``critic``
        bootstraps the λ-returns (the target critic), ``reward_fn(latents,
        actions)`` rewards the rollout (the world model's reward head);
        Plan2Explore's exploration behaviour passes its own three."""
        agent, wm = self.agent, self.agent.world_model
        actor = agent.actor if actor is None else actor
        critic = agent.target_critic if critic is None else critic
        z0 = zs.detach().reshape(-1, agent.stoch_state_size)
        h0 = hs.detach().reshape(-1, agent.recurrent_state_size)
        # with objective_mix 1 the objective is REINFORCE on a detached
        # advantage: nothing of the rollout is differentiated
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.objective_mix != 1.0):
            latents, actions = agent.imagination_scan(z0, h0, self.horizon, transition_noise, action_noise, actor=actor)
        target_values = critic(latents)
        rewards = wm["reward_model"](latents) if reward_fn is None else reward_fn(latents, actions)
        if self.use_continues:
            continues = torch.sigmoid(wm["continue_model"](latents))
            continues = torch.cat([true_continue[None] * self.gamma, continues[1:]], dim=0)
        else:
            continues = torch.ones_like(rewards.detach()) * self.gamma
        lambda_values = compute_lambda_values(
            rewards[:-1], target_values[:-1], continues[:-1], bootstrap=target_values[-1:], lmbda=self.lmbda
        )
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0), dim=0).detach()
        lp, ent = actor_logprob_entropy(agent, actor(latents[:-2].detach()), actions[1:-1].detach())
        dynamics = lambda_values[1:]
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        objective = self.objective_mix * lp * advantage + (1 - self.objective_mix) * dynamics
        policy_loss = -torch.mean(discount[:-2] * (objective + self.ent_coef * ent[..., None]))
        return policy_loss, (latents, lambda_values, discount, rewards)

    def critic_loss(self, latents, lambda_values, discount, critic=None):
        critic = self.agent.critic if critic is None else critic
        lp = normal1_logprob(critic(latents[:-1]), lambda_values.detach(), 1)
        return -torch.mean(discount[:-1, ..., 0] * lp)

    # -- the step ------------------------------------------------------------------
    @torch.no_grad()
    def update_target_critic(self, cum: int) -> None:
        """The hard copy of the critic into the target critic, before the step,
        every ``per_rank_target_network_update_freq`` steps."""
        if cum % self.target_freq == 0:
            self.agent.target_critic.load_state_dict(self.agent.critic.state_dict())

    def train_step(self, batch: Batch, cum: int, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One gradient step on a [T, B, ...] batch: the target copy, the world
        model, the actor, the critic. Returns the metrics as 0-d tensors."""
        self.update_target_critic(cum)
        w_loss, (zs, hs, _, metrics) = self.world_loss(batch, noise["posterior"])
        metrics["Grads/world_model"] = self._apply("world_model", w_loss)
        true_continue = (1 - batch["terminated"]).reshape(-1, 1)
        a_loss, (latents, lambda_values, discount, _) = self.actor_loss(
            zs, hs, true_continue, noise["transition"], noise["action"]
        )
        metrics["Grads/actor"] = self._apply("actor", a_loss)
        c_loss = self.critic_loss(latents.detach(), lambda_values.detach(), discount)
        metrics["Grads/critic"] = self._apply("critic", c_loss)
        metrics["Loss/policy_loss"] = a_loss.detach()
        metrics["Loss/value_loss"] = c_loss.detach()
        return {k: v.detach() for k, v in metrics.items()}

    # -- checkpoint state ----------------------------------------------------------
    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import dv2_to_flax

        return dv2_to_flax(self.agent)

    def group_to_torch(self, name: str):
        from sheeprl_tpu_torch.interop.flax_to_torch import dv2_group_to_torch

        return dv2_group_to_torch(self.agent, name)


def make_trainer(agent, cfg) -> DV2Trainer:
    return DV2Trainer(agent, cfg, build_optimizers(cfg, agent))


def make_buffer(cfg, buffer_size: int, num_envs: int, obs_keys, memmap_dir: str):
    """``buffer.type``: ``sequential`` (one ring per env, as Dreamer-V3's) or
    ``episode`` (whole episodes, ``buffer.prioritize_ends``)."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, SequentialReplayBuffer

    buffer_type = str(cfg.buffer.get("type", "sequential")).lower()
    if buffer_type == "sequential":
        return EnvIndependentReplayBuffer(buffer_size, n_envs=num_envs, obs_keys=obs_keys, memmap=cfg.buffer.memmap,
                                          memmap_dir=memmap_dir, buffer_cls=SequentialReplayBuffer)
    if buffer_type == "episode":
        return EpisodeBuffer(
            buffer_size,
            minimum_episode_length=1 if cfg.dry_run else cfg.algo.per_rank_sequence_length,
            n_envs=num_envs,
            obs_keys=obs_keys,
            prioritize_ends=cfg.buffer.prioritize_ends,
            memmap=cfg.buffer.memmap,
            memmap_dir=memmap_dir,
        )
    raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}")


def run_family(fabric, cfg, *, build_agent_fn: Callable, make_trainer_fn: Callable,
               buffer_fn: Optional[Callable] = None, exploration_actor: Optional[Any] = None,
               player_cls: Optional[Callable] = None, finetuning: bool = False,
               exploration_state: Optional[Dict[str, Any]] = None):
    """The Dreamer-V1/V2 loop: ``run_dreamer`` without its Dreamer-V3 checks,
    with the family's agent, trainer and buffer (``run_dreamer``'s sequential
    one by default), the player (``PlayerDV2`` unless ``player_cls``) adding
    the exploration noise ``algo.actor.expl_*`` anneals. ``finetuning`` and
    ``exploration_state`` are ``run_dreamer``'s (Plan2Explore's finetuning)."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import actor_settings

    settings = actor_settings(cfg)
    return run_dreamer(
        fabric,
        cfg,
        build_agent_fn=build_agent_fn,
        player_cls=player_cls or PlayerDV2,
        make_trainer=make_trainer_fn,
        dv3_loop=False,
        make_buffer=buffer_fn,
        expl_amount=lambda step: expl_amount_at(settings, step),
        prefill_actor=exploration_actor,
        finetuning=finetuning,
        exploration_state=exploration_state,
    )


def main(fabric, cfg: Dict[str, Any], exploration_actor: Optional[Any] = None, **finetune: Any) -> Dict[str, Any]:
    """``exploration_actor`` acts while learning has not started (the JAX
    loop's ``exploration_actor_params``, for Plan2Explore's finetuning): a
    module, or a function of the built agent that returns one; ``finetune``
    passes ``finetuning`` and ``exploration_state`` on to ``run_dreamer``."""
    return run_family(fabric, cfg, build_agent_fn=build_agent, make_trainer_fn=make_trainer, buffer_fn=make_buffer,
                      exploration_actor=exploration_actor, **finetune)
