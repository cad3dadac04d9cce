"""Plan2Explore on the Dreamer-V2 backbone, the exploration phase (port of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``).

:class:`P2EDV2Trainer` is the JAX ``train_step``, eager, in its order: every
``per_rank_target_network_update_freq`` steps, before anything else, the
hard copy of both critics into their targets; the world model (Dreamer-V2's
loss, KL balancing); the disagreement ensemble (each member predicts the
next stochastic state from ``(z, h, a)``, an MSE log-prob summed over the
members); the exploration actor with Dreamer-V2's behaviour (REINFORCE
against the exploration target critic mixed with the dynamics objective by
``objective_mix``, the entropy term, the continues' first row from the true
continue flags) on the intrinsic reward, the members' variance times
``intrinsic_reward_multiplier``; the exploration critic; then the task actor
and critic as Dreamer-V2 learns them, over a second rollout. The six
optimizers are Plan2Explore-DV1's (:func:`build_optimizers`).

The loop is Dreamer-V2's (``run_family``) on the sequential or the episode
buffer, the player acting with the actor ``algo.player.actor_type`` names.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer, make_buffer, run_family
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import P2EDreamerSteps, build_optimizers
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent, make_player
from sheeprl_tpu_torch.utils.distribution import MSEDistribution


class P2EDV2Trainer(P2EDreamerSteps, DV2Trainer):
    """The P2E-DV2 gradient step (module docstring)."""

    bootstrap = "target_critic"

    def ensemble_loss(self, zs, hs, embedded, actions) -> torch.Tensor:
        """Minus the MSE log-prob of the next stochastic state, averaged over
        the rows and summed over the members."""
        out = self.ensemble_outputs(zs, hs, actions)
        lp = MSEDistribution(out, dims=1).log_prob(zs.detach()[1:][None].expand_as(out))
        return -lp.mean(dim=tuple(range(1, lp.ndim))).sum()

    @torch.no_grad()
    def update_target_critic(self, cum: int) -> None:
        """Both hard copies, task and exploration, before the step."""
        if cum % self.target_freq == 0:
            agent = self.agent
            agent.target_critic.load_state_dict(agent.critic.state_dict())
            agent.target_critic_exploration.load_state_dict(agent.critic_exploration.state_dict())


def make_trainer(agent, cfg) -> P2EDV2Trainer:
    return P2EDV2Trainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_family(fabric, cfg, build_agent_fn=build_agent, make_trainer_fn=make_trainer, buffer_fn=make_buffer,
                      player_cls=make_player(str(cfg.algo.player.actor_type)))
