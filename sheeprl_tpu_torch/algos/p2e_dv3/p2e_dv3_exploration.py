"""Plan2Explore on the Dreamer-V3 backbone, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``).

:class:`P2ETrainer` is the JAX ``train_step``, eager, in its order: the target
EMAs of the task critic and of each exploration critic; the world model (its
continue head on detached latents); the disagreement ensembles (each member
predicts the next posterior from ``(z, h, a)``, an MSE log-prob summed over
the members); the exploration actor, over an imagination rollout of its own,
against the weighted advantages of one critic per reward stream (the
intrinsic stream's reward is the ensemble's variance times
``intrinsic_reward_multiplier``, the task stream's the learned reward), each
stream with its own λ-values and Moments; one critic update per stream; then
the task actor and critic, as Dreamer-V3 learns them, over a second rollout.
Each group has its own optimizer and gradient clip (seven with the two
default critics). Every random draw is an argument (:meth:`P2ETrainer.draw_noise`).

The loop is Dreamer-V3's (``run_dreamer``), the player acting with the actor
``algo.player.actor_type`` names (the exploration one by default).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent, actor_logprob_entropy, draw_actor_noise, draw_gumbel
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, run_dreamer
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, intrinsic_reward, make_player
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.utils.distribution import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.utils.utils import compute_lambda_values, weak_scalar


def param_groups(agent: DV3Agent) -> Dict[str, List[torch.nn.Parameter]]:
    """The P2E optimizer groups, each in the order its optimizer holds them."""
    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_group_modules

    groups = {"world_model": [*agent.world_model.parameters(), agent.initial_recurrent_state]}
    groups.update({name: list(module.parameters()) for name, module in p2e_group_modules(agent).items()})
    return groups


def _group_settings(cfg) -> Dict[str, Any]:
    """Each group's config node (its ``optimizer`` and ``clip_gradients``):
    the exploration actor and critics take the task actor's and critic's."""
    algo = cfg.algo
    out = {"world_model": algo.world_model, "actor_task": algo.actor, "critic_task": algo.critic,
           "actor_exploration": algo.actor, "ensembles": algo.ensembles}
    out.update({f"critic_exploration_{name}": algo.critic for name in dict(algo.critics_exploration)})
    return out


def build_optimizers(cfg, agent: DV3Agent) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per group (``build_txs`` of the JAX package)."""
    groups = param_groups(agent)
    return {name: instantiate(node.optimizer, groups[name]) for name, node in _group_settings(cfg).items()}


class P2ETrainer(DV3Trainer):
    """Owns the seven (or more) optimizers and the Moments of the task actor
    and of each exploration critic (``moments = {"task", "exploration": {k}}``),
    and takes P2E gradient steps."""

    continue_on_detached_latents = True

    def __init__(self, agent: DV3Agent, cfg, optimizers: Dict[str, torch.optim.Optimizer]):
        super().__init__(agent, cfg, optimizers)
        self.groups = param_groups(agent)
        self.clips = {name: float(node.clip_gradients or 0) for name, node in _group_settings(cfg).items()}
        self.intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
        self.critic_cfgs = {k: dict(v) for k, v in dict(cfg.algo.critics_exploration).items()}
        self.weights_sum = sum(c["weight"] for c in self.critic_cfgs.values())
        self.moments = {
            "task": init_moments(self.device),
            "exploration": {k: init_moments(self.device) for k in self.critic_cfgs},
        }

    def target_pairs(self) -> List[tuple]:
        pairs = [(self.agent.target_critic, self.agent.critic)]
        pairs += [(pair["target"], pair["module"]) for pair in self.agent.critics_exploration.values()]
        return pairs

    # -- noise ---------------------------------------------------------------------
    def draw_noise(self, T: int, B: int, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """The posterior samples' Gumbel noise, then each rollout's (the
        exploration actor's, then the task actor's) prior and action noise."""
        agent, N, dev = self.agent, T * B, self.device
        noise = {"posterior": draw_gumbel((T, B, agent.stoch_state_size), generator, dev, agent.dtype)}
        for role in ("exploration", "task"):
            noise[f"transition_{role}"] = draw_gumbel((self.horizon, N, agent.stoch_state_size), generator, dev,
                                                      agent.dtype)
            noise[f"action_{role}"] = draw_actor_noise(agent, (self.horizon + 1, N), generator, dev)
        return noise

    # -- losses --------------------------------------------------------------------
    def ensemble_loss(self, zs: torch.Tensor, hs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """Each member predicts z[t+1] from (z[t], h[t], a[t]) (the stored
        action at row t leaves o[t]); minus the MSE log-prob, averaged over the
        rows and summed over the members."""
        inp = torch.cat([zs, hs, actions], dim=-1).detach()
        out = self.agent.ensembles(inp)[:, :-1]
        target = zs.detach()[1:][None].expand_as(out)
        lp = MSEDistribution(out, dims=1).log_prob(target)
        return -lp.mean(dim=tuple(range(1, lp.ndim))).sum()

    def _continues(self, latents: torch.Tensor, true_continue: torch.Tensor) -> torch.Tensor:
        cont = Independent(BernoulliSafeMode(logits=self.agent.world_model["continue_model"](latents)), 1).mode
        return torch.cat([true_continue[None], cont[1:]], dim=0)

    def exploration_actor_loss(
        self,
        zs: torch.Tensor,
        hs: torch.Tensor,
        true_continue: torch.Tensor,
        transition_noise: torch.Tensor,
        action_noise: torch.Tensor,
    ):
        """Returns (policy loss, (latents, {critic: λ-values}, discount, new
        exploration Moments, metrics))."""
        agent, wm = self.agent, self.agent.world_model
        z0 = zs.detach().reshape(-1, agent.stoch_state_size)
        h0 = hs.detach().reshape(-1, agent.recurrent_state_size)
        with torch.set_grad_enabled(torch.is_grad_enabled() and agent.is_continuous):
            latents, actions = agent.imagination_scan(
                z0, h0, self.horizon, transition_noise, action_noise, actor=agent.actor_exploration
            )
        continues = self._continues(latents, true_continue)
        discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
        # the disagreement reward reads detached latents and actions
        with torch.no_grad():
            intrinsic = intrinsic_reward(agent.ensembles(torch.cat([latents, actions], dim=-1)), self.intrinsic_mult)

        advantage = None
        new_moments: Dict[str, Any] = {}
        lambdas: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        for k, ccfg in self.critic_cfgs.items():
            predicted_values = TwoHotEncodingDistribution(
                agent.critics_exploration[k]["module"](latents), dims=1
            ).mean
            if ccfg["reward_type"] == "intrinsic":
                reward = intrinsic
                metrics[f"Rewards/intrinsic_{k}"] = reward.mean()
            else:
                reward = TwoHotEncodingDistribution(wm["reward_model"](latents), dims=1).mean
            lambda_values = compute_lambda_values(
                reward[1:], predicted_values[1:], continues[1:] * self.gamma, self.lmbda
            )
            lambdas[k] = lambda_values
            offset, invscale, new_moments[k] = update_moments(
                self.moments["exploration"][k], lambda_values, **self.moments_kw
            )
            # the 0-d float32 Moments promote a bf16 baseline in JAX (see actor_loss)
            baseline = predicted_values[:-1].float()
            term = ((lambda_values - offset) / invscale - (baseline - offset) / invscale) * (
                ccfg["weight"] / self.weights_sum
            )
            advantage = term if advantage is None else advantage + term
            metrics[f"Values_exploration/predicted_values_{k}"] = predicted_values.mean()
            metrics[f"Values_exploration/lambda_values_{k}"] = lambda_values.mean()

        pre = agent.actor_exploration(latents.detach())
        lp, ent = actor_logprob_entropy(agent, pre, actions.detach())
        objective = advantage if agent.is_continuous else lp[:-1] * advantage.detach()
        entropy = weak_scalar(self.ent_coef, ent.dtype) * ent[..., None]
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[:-1]))
        return policy_loss, (latents, lambdas, discount, new_moments, metrics)

    # -- the step ------------------------------------------------------------------
    def train_step(self, batch, cum: int, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One P2E gradient step on a [T, B, ...] batch (module docstring).
        Returns the step's metrics as 0-d tensors."""
        agent = self.agent
        self.update_target_critic(cum)
        w_loss, (zs, hs, metrics) = self.world_loss(batch, noise["posterior"])
        metrics["Grads/world_model"] = self._apply("world_model", w_loss)

        e_loss = self.ensemble_loss(zs, hs, batch["actions"])
        metrics["Grads/ensemble"] = self._apply("ensembles", e_loss)

        true_continue = (1 - batch["terminated"]).reshape(-1, 1)
        pe_loss, (latents_e, lambdas, discount_e, new_me, e_metrics) = self.exploration_actor_loss(
            zs, hs, true_continue, noise["transition_exploration"], noise["action_exploration"]
        )
        metrics["Grads/actor_exploration"] = self._apply("actor_exploration", pe_loss)
        self.moments = {**self.moments, "exploration": new_me}
        metrics.update(e_metrics)

        latents_e = latents_e.detach()
        for k in self.critic_cfgs:
            pair = agent.critics_exploration[k]
            c_loss = self.critic_loss(latents_e, lambdas[k].detach(), discount_e, pair["module"], pair["target"])
            metrics[f"Grads/critic_exploration_{k}"] = self._apply(f"critic_exploration_{k}", c_loss)
            metrics[f"Loss/value_loss_exploration_{k}"] = c_loss.detach()

        pt_loss, (latents_t, lambda_t, discount_t, new_mt) = self.actor_loss(
            zs, hs, true_continue, noise["transition_task"], noise["action_task"], moments=self.moments["task"]
        )
        metrics["Grads/actor_task"] = self._apply("actor_task", pt_loss)
        self.moments = {**self.moments, "task": new_mt}

        ct_loss = self.critic_loss(latents_t.detach(), lambda_t.detach(), discount_t)
        metrics["Grads/critic_task"] = self._apply("critic_task", ct_loss)
        metrics["Loss/ensemble_loss"] = e_loss.detach()
        metrics["Loss/policy_loss_exploration"] = pe_loss.detach()
        metrics["Loss/policy_loss_task"] = pt_loss.detach()
        metrics["Loss/value_loss_task"] = ct_loss.detach()
        return {k: v.detach() for k, v in metrics.items()}

    # -- checkpoint state ----------------------------------------------------------
    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_to_flax

        return p2e_to_flax(self.agent)

    def group_to_torch(self, name: str):
        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_group_to_torch

        return p2e_group_to_torch(self.agent, name)


def make_trainer(agent: DV3Agent, cfg) -> P2ETrainer:
    return P2ETrainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_dreamer(
        fabric,
        cfg,
        build_agent_fn=build_agent,
        player_cls=make_player(str(cfg.algo.player.actor_type)),
        make_trainer=make_trainer,
    )
