"""SAC-AE, coupled training (port of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``):
pixel SAC with an autoencoder's reconstruction loss on the shared encoder.

:class:`SACAETrainer` is ``make_train_phase``: over a ``[G, B, ...]`` replay
block each gradient step runs, in order and each on the parameters the stage
before it left,

- the critic update over the trunk, the vector encoder, the critic's fc and
  the Q critics (the next actions sampled by the actor on the next frames,
  valued by the target);
- the target EMA when ``cum % critic.per_rank_target_network_update_freq``
  is 0: ``tau`` for the Q critics, ``encoder.tau`` for the trunk, the vector
  encoder and the critic's fc;
- the actor and temperature updates when ``cum % actor.per_rank_update_freq``
  is 0 (the actor on features whose trunks are detached);
- the encoder and decoder updates when ``cum % decoder.per_rank_update_freq``
  is 0: the MSE to the 5-bit dequantized frames (``preprocess_obs``) and to
  the vector keys, plus ``l2_lambda`` times half the features' squared norm.

``cum`` counts the run's gradient steps from 0. A shut gate skips its
optimizers' steps, so parameters and optimizer states stay as they were (the
JAX ``_masked_update``); its loss is still computed, without gradients, for
the metrics. Five optimizers: the critic's, the actor's, the temperature's,
the encoder's (Adam) and the decoder's (AdamW, ``weight_decay`` 1e-7). Every
random draw is an argument (:meth:`SACAETrainer.draw_noise`).

The loop is SAC's (``sac.run_off_policy``), frames stacked by
``env.frame_stack``; acting runs on the agent's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import squash_and_logprob
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import Batch, SACTrainer, run_off_policy
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import prepare_obs, preprocess_obs, test
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.data.prefetch import sample_to_device
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault


def param_groups(agent: SACAEAgent) -> Dict[str, list]:
    """The five optimizer groups, each in the order of its params tree
    (``interop/flax_to_torch.py``'s ``SAC_AE_GROUPS``)."""
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_group_modules

    groups = {g: [p for m in sac_ae_group_modules(agent, g).values() for p in m.parameters()]
              for g in ("critic", "actor", "encoder", "decoder")}
    groups["alpha"] = [agent.log_alpha]
    return groups


def build_optimizers(cfg, agent: SACAEAgent) -> Dict[str, torch.optim.Optimizer]:
    """The five SAC-AE optimizers from ``algo.<group>.optimizer``."""
    groups = param_groups(agent)
    return {name: instantiate(cfg.algo[name].optimizer, groups[name])
            for name in ("actor", "critic", "alpha", "encoder", "decoder")}


def _step(optimizer: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


class SACAETrainer(SACTrainer):
    """Owns the five optimizers and the run's gradient-step count, and takes
    SAC-AE train phases (module docstring) on the agent's device."""

    loss_names = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss")
    build_optimizers = staticmethod(build_optimizers)
    buffer_obs_keys = ()

    def __init__(self, agent: SACAEAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, target_entropy: float,
                 policy_steps_per_iter: int = 1):
        self.agent = agent
        self.optimizers = optimizers
        self.groups = param_groups(agent)
        self.device = agent.device
        self.dtype = agent.log_alpha.dtype  # float32; a float64 agent steps in float64
        algo = cfg.algo
        self.gamma = float(algo.gamma)
        self.tau = float(algo.tau)
        self.encoder_tau = float(algo.encoder.tau)
        self.num_critics = int(algo.critic.n)
        self.target_entropy = float(target_entropy)
        self.target_freq = int(algo.critic.per_rank_target_network_update_freq)
        self.actor_freq = int(algo.actor.per_rank_update_freq)
        self.decoder_freq = int(algo.decoder.per_rank_update_freq)
        self.l2_lambda = float(algo.decoder.l2_lambda)
        self.cnn_keys = tuple(algo.cnn_keys.encoder)
        self.mlp_keys = tuple(algo.mlp_keys.encoder)
        self.cnn_dec_keys = tuple(algo.cnn_keys.decoder)
        self.mlp_dec_keys = tuple(algo.mlp_keys.decoder)
        self.uint8_keys = self.cnn_keys
        self.act_dim = int(agent.actor.fc_mean.out_features)
        # the EMA pairs: (target, online, tau)
        self.ema = [(list(agent.target[k].parameters()), list(getattr(agent, k).parameters()),
                     self.tau if k == "qfs" else self.encoder_tau) for k in agent.target]
        self.cum = 0  # the run's gradient steps, the gates' counter

    # -- noise ---------------------------------------------------------------------
    def draw_noise(self, G: int, batch: Batch, generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """Per step: the next actions' standard normal noise ``critic`` and the
        actions' ``actor`` [G, B, act_dim], and per decoded frame key the
        dequantization noise ``rec`` [G, B, C, H, W], uniform in [0, 1)."""
        B = batch["rewards"].shape[1]
        size = (G, B, self.act_dim)
        return {
            "critic": torch.randn(size, generator=generator, device=self.device),
            "actor": torch.randn(size, generator=generator, device=self.device),
            "rec": {k: torch.rand((G, *self.frames(batch[k][0]).shape), generator=generator, device=self.device)
                    for k in self.cnn_dec_keys},
        }

    # -- the step ------------------------------------------------------------------
    @staticmethod
    def frames(x: torch.Tensor) -> torch.Tensor:
        """[..., S, C, H, W] frame stacks folded into [..., S*C, H, W]."""
        return x.reshape(*x.shape[:-4], -1, *x.shape[-2:]) if x.ndim >= 5 else x

    def observations(self, batch: Batch, prefix: str = "") -> Dict[str, torch.Tensor]:
        """The encoders' inputs: frames in [0, 1], the vector keys as they are."""
        out = {k: self.frames(batch[prefix + k]).to(self.dtype) / 255.0 for k in self.cnn_keys}
        out.update({k: batch[prefix + k].to(self.dtype) for k in self.mlp_keys})
        return out

    def critic_step(self, batch: Batch, eps: torch.Tensor) -> torch.Tensor:
        agent = self.agent
        actor = agent.actor
        obs, next_obs = self.observations(batch), self.observations(batch, "next_")
        with torch.no_grad():
            mean, std = actor(agent.features(next_obs, side="actor"))
            next_actions, next_logprobs = squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)
            target_q = agent.target["qfs"](agent.features(next_obs, target=True), next_actions)
            min_target = torch.min(target_q, dim=-1, keepdim=True).values - torch.exp(agent.log_alpha) * next_logprobs
            next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * self.gamma * min_target
        qf_values = agent.qfs(agent.features(obs), batch["actions"])
        loss = critic_loss(qf_values, next_qf_value, self.num_critics)
        params = self.groups["critic"]
        _step(self.optimizers["critic"], params, torch.autograd.grad(loss, params))
        return loss.detach()

    @torch.no_grad()
    def update_targets(self) -> None:
        """target = (1 - tau) target + tau online, per EMA pair."""
        for target, online, tau in self.ema:
            torch._foreach_mul_(target, 1 - tau)
            torch._foreach_add_(target, torch._foreach_mul(online, tau))

    def actor_step(self, batch: Batch, eps: torch.Tensor, apply: bool):
        """The actor's loss on trunk features detached (``apply``: and its
        update), then the temperature's; returns both losses."""
        agent = self.agent
        actor = agent.actor
        with torch.no_grad():
            trunk = agent.trunk(self.observations(batch))
            feat_c = agent.heads(trunk)
        with torch.set_grad_enabled(apply):
            mean, std = actor(agent.heads(trunk, side="actor"))
            actions, logprobs = squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)
            min_qf = torch.min(agent.qfs(feat_c, actions), dim=-1, keepdim=True).values
            loss = policy_loss(torch.exp(agent.log_alpha.detach()), logprobs, min_qf)
        if apply:
            params = self.groups["actor"]
            _step(self.optimizers["actor"], params, torch.autograd.grad(loss, params))
        logprobs = logprobs.detach()
        with torch.set_grad_enabled(apply):
            al_loss = entropy_loss(agent.log_alpha, logprobs, self.target_entropy)
        if apply:
            _step(self.optimizers["alpha"], [agent.log_alpha], torch.autograd.grad(al_loss, [agent.log_alpha]))
        return loss.detach(), al_loss.detach()

    def reconstruction_step(self, batch: Batch, rec_noise: Dict[str, torch.Tensor], apply: bool) -> torch.Tensor:
        """The encoder's and decoder's loss (``apply``: and their updates)."""
        agent = self.agent
        with torch.set_grad_enabled(apply):
            hidden = agent.features(self.observations(batch))
            recon = agent.reconstruct(hidden)
            loss = self.l2_lambda * (0.5 * torch.sum(torch.square(hidden), dim=-1).mean())
            for k in self.cnn_dec_keys:
                target = preprocess_obs(self.frames(batch[k]).to(self.dtype), rec_noise[k], bits=5)
                loss = loss + torch.mean(torch.square(target - recon[k]))
            for k in self.mlp_dec_keys:
                loss = loss + torch.mean(torch.square(batch[k] - recon[k]))
        if apply:
            enc, dec = self.groups["encoder"], self.groups["decoder"]
            grads = torch.autograd.grad(loss, enc + dec)
            _step(self.optimizers["encoder"], enc, grads[: len(enc)])
            _step(self.optimizers["decoder"], dec, grads[len(enc):])
        return loss.detach()

    def train_phase(self, data: Batch, cum: int, noise: Dict[str, Any]) -> torch.Tensor:
        """``G = data["rewards"].shape[0]`` gradient steps over a ``[G, B, ...]``
        block from the run's gradient step ``cum`` (module docstring). Returns
        the mean value, policy, alpha and reconstruction losses, [4], on the
        device."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        losses = []
        for g in range(data["rewards"].shape[0]):
            batch = {k: v[g] for k, v in data.items()}
            step = cum + g
            qf_loss = self.critic_step(batch, noise["critic"][g])
            if step % self.target_freq == 0:
                self.update_targets()
            a_loss, al_loss = self.actor_step(batch, noise["actor"][g], step % self.actor_freq == 0)
            rec_loss = self.reconstruction_step(batch, {k: v[g] for k, v in noise["rec"].items()},
                                                step % self.decoder_freq == 0)
            losses.append(torch.stack([qf_loss, a_loss, al_loss, rec_loss]))
        return torch.stack(losses).mean(dim=0)

    def run_phase(self, rb, G: int, sample: Dict[str, Any], generator: torch.Generator, iter_num: int) -> torch.Tensor:
        """Sample a ``[G, B, ...]`` block of ``rb`` to the device, draw its
        noise and take a train phase at the run's step count."""
        data = sample_to_device(rb, G, **sample)
        losses = self.train_phase(data, self.cum, self.draw_noise(G, data, generator))
        self.cum += G
        return losses

    # -- what the loop asks of the algorithm ------------------------------------------
    @staticmethod
    def check_spaces(cfg, observation_space, name: str) -> None:
        if len(cfg.algo.cnn_keys.encoder) + len(cfg.algo.mlp_keys.encoder) == 0:
            raise RuntimeError("You should specify at least one CNN or MLP key for the encoder")

    @staticmethod
    def ratio_steps(policy_step: int, prefill_steps: int, policy_steps_per_iter: int) -> int:
        return policy_step - prefill_steps * policy_steps_per_iter

    def replay_rows(self, obs, real_next_obs, keys, num_envs: int, sample_next_obs: bool) -> Dict[str, np.ndarray]:
        """Each key's observation and real next observation, as they are
        (frames stay uint8)."""
        rows = {}
        for k in keys:
            rows[k] = np.asarray(obs[k])[np.newaxis]
            rows[f"next_{k}"] = real_next_obs[k][np.newaxis]
        return rows

    def start_acting(self, seed: int) -> None:
        """Acting runs on the agent's device, from a generator of its own."""
        self.act_generator = torch.Generator(self.device).manual_seed(int(seed))

    @torch.no_grad()
    def act(self, obs, keys, num_envs: int) -> np.ndarray:
        agent = self.agent
        jobs = prepare_obs(obs, cnn_keys=self.cnn_keys, mlp_keys=self.mlp_keys, num_envs=num_envs, device=self.device)
        mean, std = agent.actor(agent.features(jobs, side="actor"))
        eps = torch.randn(mean.shape, generator=self.act_generator, device=self.device)
        actor = agent.actor
        return squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)[0].cpu().numpy()

    def sync_acting(self) -> None:
        """The actor acts with the trained weights themselves."""

    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_to_flax

        return sac_ae_to_flax(self.agent)

    def test(self, cfg, log_dir: str, logger) -> float:
        return test(self.agent, cfg, log_dir, logger)

    def load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        """A checkpoint's five optimizer states: the port's state dicts, or the
        JAX package's optax states."""
        from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_group_to_torch
        from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

        if sorted(opt_state) != sorted(self.optimizers):
            raise ValueError(f"the checkpoint's optimizer state should hold the groups {sorted(self.optimizers)}")
        for name, opt in self.optimizers.items():
            load_optimizer_state(opt, opt_state[name], sac_ae_group_to_torch(self.agent, name))


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_off_policy(fabric, cfg, "SAC-AE", build_agent, SACAETrainer)
