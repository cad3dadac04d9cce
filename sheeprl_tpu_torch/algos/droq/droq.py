"""DroQ, coupled training (port of ``sheeprl_tpu/algos/droq/droq.py``).

DroQ is SAC with Dropout + LayerNorm critics at a high replay ratio
(arXiv:2110.02034, ``replay_ratio: 20``). A train phase runs G critic
updates over a ``[G, B, ...]`` block, each followed by the target EMA, then
one actor update and one temperature update on a separate batch; the policy
loss takes the ensemble's mean Q, not its min. Dropout stays on for the
online critics, the target critics and the actor's Q, as the reference's
modules stay in train mode. The noise and the keep-masks of every dropout
layer are arguments (:meth:`DroQTrainer.draw_noise`).

The loop is SAC's (``sac.run_off_policy``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.droq.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import Batch, SACTrainer, run_off_policy
from sheeprl_tpu_torch.data.prefetch import sample_to_device
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault


class DroQTrainer(SACTrainer):
    def draw_noise(self, G: int, batch_size: int, generator: Optional[torch.Generator]) -> Batch:
        """The critic updates' next-action noise ``critic`` [G, B, act_dim] and
        keep-masks ``target_keep``/``online_keep`` [G, layers, n, B, hidden];
        the actor update's noise ``actor`` [B, act_dim] and keep-masks
        ``actor_keep`` [layers, n, B, hidden]. A unit is kept with
        probability ``1 - dropout``."""
        mlp = self.agent.critic.mlp
        masks = (len(mlp.hidden_sizes), mlp.n, batch_size, mlp.hidden_sizes[0])
        keep_prob = 1.0 - mlp.dropout

        def keep(*lead):
            return torch.rand((*lead, *masks), generator=generator, device=self.device) < keep_prob

        return {
            "critic": torch.randn((G, batch_size, self.act_dim), generator=generator, device=self.device),
            "target_keep": keep(G),
            "online_keep": keep(G),
            "actor": torch.randn((batch_size, self.act_dim), generator=generator, device=self.device),
            "actor_keep": keep(),
        }

    def train_phase(self, critic_data: Batch, actor_data: Batch, noise: Batch) -> torch.Tensor:
        """G critic updates with the EMA after each, then the actor and alpha
        updates on ``actor_data`` ([B, ...]). Returns the mean per-critic value
        loss, the policy loss and the alpha loss, [3], on the device."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        qf_losses = []
        for g in range(critic_data["rewards"].shape[0]):
            batch = {k: v[g] for k, v in critic_data.items()}
            qf_losses.append(
                self.critic_step(batch, noise["critic"][g], noise["target_keep"][g], noise["online_keep"][g])
            )
            self.update_target()
        a_loss, logprobs = self.actor_step(actor_data, noise["actor"], noise["actor_keep"], ensemble_mean=True)
        al_loss = self.alpha_step(logprobs)
        return torch.stack([torch.stack(qf_losses).mean() / self.num_critics, a_loss, al_loss])

    def run_phase(self, rb, G: int, sample: Dict[str, Any], generator: torch.Generator, iter_num: int) -> torch.Tensor:
        """SAC's, with the actor's batch: one more sample of the same stream.
        The EMA runs after every critic update, whatever ``iter_num``."""
        data = sample_to_device(rb, G, **sample)
        noise = self.draw_noise(G, sample["batch_size"], generator)
        actor_data = {k: v[0] for k, v in sample_to_device(rb, 1, **sample).items()}
        return self.train_phase(data, actor_data, noise)


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_off_policy(fabric, cfg, "DroQ", build_agent, DroQTrainer)
