"""Plan2Explore on the Dreamer-V1 backbone, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``).

:class:`P2EDV1Trainer` is the JAX ``train_step``, eager, in its order: the
world model (Dreamer-V1's loss); the disagreement ensemble (each member
predicts the next observation embedding from ``(z, h, a)``, a unit-variance
normal log-prob summed over the members); the exploration actor, whose
objective is Dreamer-V1's dynamics backpropagation on the intrinsic reward
(the members' variance times ``intrinsic_reward_multiplier``) against the
exploration critic's values; the exploration critic; then the task actor
and critic as Dreamer-V1 learns them, over a second rollout. There is no
target critic. Each of the six groups has its own optimizer and gradient
clip (:func:`build_optimizers`, ``build_txs`` of the JAX package, which the
Dreamer-V2 backbone shares). Every random draw is an argument
(:meth:`P2EDreamerSteps.draw_noise`).

The loop is Dreamer-V1's (``run_family``), the player acting with the actor
``algo.player.actor_type`` names (the exploration one by default).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v2.agent import draw_actor_noise
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import run_family
from sheeprl_tpu_torch.algos.dreamer_v2.utils import normal1_logprob
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent, make_player
from sheeprl_tpu_torch.algos.p2e_dv3.agent import intrinsic_reward
from sheeprl_tpu_torch.config import instantiate


def param_groups(agent) -> Dict[str, List[torch.nn.Parameter]]:
    """The six P2E-DV1/DV2 optimizer groups, each in its module's order."""
    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_modules

    groups = {"world_model": list(agent.world_model.parameters())}
    groups.update({name: list(module.parameters()) for name, module in p2e_dv_modules(agent).items()
                   if not name.startswith("target_")})
    return groups


def _group_settings(cfg) -> Dict[str, Any]:
    """Each group's config node (its ``optimizer`` and ``clip_gradients``):
    both actors take ``algo.actor``'s, both critics ``algo.critic``'s."""
    algo = cfg.algo
    return {"world_model": algo.world_model, "actor_task": algo.actor, "critic_task": algo.critic,
            "actor_exploration": algo.actor, "critic_exploration": algo.critic, "ensembles": algo.ensembles}


def build_optimizers(cfg, agent) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per group (``build_txs`` of the JAX package)."""
    groups = param_groups(agent)
    return {name: instantiate(node.optimizer, groups[name]) for name, node in _group_settings(cfg).items()}


class P2EDreamerSteps:
    """The Plan2Explore gradient step on a Dreamer-V1/V2 trainer (mixed in
    before it): the backbone's world, actor and critic losses, taken once for
    the exploration heads and once for the task heads. A subclass sets
    ``bootstrap`` (the agent attribute whose ``*_exploration`` critic the
    exploration λ-returns take) and defines :meth:`ensemble_loss`."""

    bootstrap = "critic"

    def __init__(self, agent, cfg, optimizers: Dict[str, torch.optim.Optimizer]):
        super().__init__(agent, cfg, optimizers)
        self.groups = param_groups(agent)
        self.clips = {name: float(node.clip_gradients or 0) for name, node in _group_settings(cfg).items()}
        self.intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)

    def draw_noise(self, T: int, B: int, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """The posterior samples' noise, then each rollout's (the exploration
        actor's, then the task actor's) prior and action noise."""
        agent, N = self.agent, T * B
        noise = {"posterior": agent.draw_state_noise((T, B), generator, self.device)}
        for role in ("exploration", "task"):
            noise[f"transition_{role}"] = agent.draw_state_noise((self.horizon, N), generator, self.device)
            noise[f"action_{role}"] = draw_actor_noise(agent, (self.horizon, N), generator, self.device)
        return noise

    def ensemble_loss(self, zs, hs, embedded, actions) -> torch.Tensor:
        raise NotImplementedError

    def ensemble_outputs(self, zs, hs, actions) -> torch.Tensor:
        """The members' predictions from (z[t], h[t], a[t]) for t < T-1: the
        stored action at row t leaves o[t]. [n, T-1, B, out]."""
        return self.agent.ensembles(torch.cat([zs, hs, actions], dim=-1).detach())[:, :-1]

    @torch.no_grad()
    def intrinsic_reward(self, latents: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """The disagreement reward of an imagined rollout, read on detached
        latents and actions."""
        return intrinsic_reward(self.agent.ensembles(torch.cat([latents, actions], dim=-1)), self.intrinsic_mult)

    def train_step(self, batch, cum: int, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One P2E gradient step on a [T, B, ...] batch (module docstring).
        Returns the step's metrics as 0-d tensors."""
        agent = self.agent
        self.update_target_critic(cum)
        w_loss, (zs, hs, embedded, metrics) = self.world_loss(batch, noise["posterior"])
        metrics["Grads/world_model"] = self._apply("world_model", w_loss)
        e_loss = self.ensemble_loss(zs, hs, embedded, batch["actions"])
        metrics["Grads/ensemble"] = self._apply("ensembles", e_loss)

        true_continue = (1 - batch["terminated"]).reshape(-1, 1)
        pe_loss, (latents_e, lambda_e, discount_e, intrinsic) = self.actor_loss(
            zs, hs, true_continue, noise["transition_exploration"], noise["action_exploration"],
            actor=agent.actor_exploration, critic=getattr(agent, f"{self.bootstrap}_exploration"),
            reward_fn=self.intrinsic_reward,
        )
        metrics["Grads/actor_exploration"] = self._apply("actor_exploration", pe_loss)
        ce_loss = self.critic_loss(latents_e.detach(), lambda_e.detach(), discount_e, critic=agent.critic_exploration)
        metrics["Grads/critic_exploration"] = self._apply("critic_exploration", ce_loss)

        pt_loss, (latents_t, lambda_t, discount_t, _) = self.actor_loss(
            zs, hs, true_continue, noise["transition_task"], noise["action_task"]
        )
        metrics["Grads/actor_task"] = self._apply("actor_task", pt_loss)
        ct_loss = self.critic_loss(latents_t.detach(), lambda_t.detach(), discount_t)
        metrics["Grads/critic_task"] = self._apply("critic_task", ct_loss)
        metrics["Loss/ensemble_loss"] = e_loss.detach()
        metrics["Loss/policy_loss_exploration"] = pe_loss.detach()
        metrics["Loss/value_loss_exploration"] = ce_loss.detach()
        metrics["Loss/policy_loss_task"] = pt_loss.detach()
        metrics["Loss/value_loss_task"] = ct_loss.detach()
        metrics["Rewards/intrinsic"] = intrinsic.mean()
        metrics["Values_exploration/lambda_values"] = lambda_e.detach().mean()
        return {k: v.detach() for k, v in metrics.items()}

    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_to_flax

        return p2e_dv_to_flax(self.agent)

    def group_to_torch(self, name: str):
        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_group_to_torch

        return p2e_dv_group_to_torch(self.agent, name)


class P2EDV1Trainer(P2EDreamerSteps, DV1Trainer):
    """The P2E-DV1 gradient step (module docstring)."""

    def ensemble_loss(self, zs, hs, embedded, actions) -> torch.Tensor:
        """Minus the unit-variance normal log-prob of the next observation
        embedding, averaged over the rows and summed over the members."""
        out = self.ensemble_outputs(zs, hs, actions)
        lp = normal1_logprob(out, embedded.detach()[1:][None].expand_as(out), 1)
        return -lp.mean(dim=tuple(range(1, lp.ndim))).sum()


def make_trainer(agent, cfg) -> P2EDV1Trainer:
    return P2EDV1Trainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_family(fabric, cfg, build_agent_fn=build_agent, make_trainer_fn=make_trainer,
                      player_cls=make_player(str(cfg.algo.player.actor_type)))
