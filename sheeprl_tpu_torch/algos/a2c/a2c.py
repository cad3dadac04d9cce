"""A2C, coupled training (port of ``sheeprl_tpu/algos/a2c/a2c.py``).

One train phase per rollout: GAE, then one clipped optimizer step on the
whole rollout (with the A2C default ``loss_reduction: sum`` this is the
reference's gradient accumulation over minibatches). The loop is PPO's
(``algos/ppo/ppo.py::run_on_policy``): acting on the host, the train phase on
the fabric's device, the PPO agent over the mlp keys only.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, policy_output
from sheeprl_tpu_torch.optim import clip_grad_global_norm_
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault
from sheeprl_tpu_torch.utils.utils import gae

Batch = Dict[str, torch.Tensor]


class A2CTrainer:
    """Owns the agent's optimizer and takes train phases."""

    def __init__(self, agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg):
        self.agent = agent
        self.optimizer = optimizer
        self.params = list(agent.parameters())
        self.obs_keys = tuple(cfg.algo.mlp_keys.encoder)
        self.rollout_steps = int(cfg.algo.rollout_steps)
        self.gamma = float(cfg.algo.gamma)
        self.gae_lambda = float(cfg.algo.gae_lambda)
        self.loss_reduction = str(cfg.algo.loss_reduction)
        self.max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)

    def train_phase(self, data: Batch, next_values: torch.Tensor) -> torch.Tensor:
        """One update on a [T, E, ...] rollout; returns the policy and value
        losses, [2], on the device."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        returns, advantages = gae(
            data["rewards"], data["values"], data["dones"], next_values,
            self.rollout_steps, self.gamma, self.gae_lambda,
        )
        batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
        actor_outs, values = self.agent({k: batch[k] for k in self.obs_keys})
        out = policy_output(
            actor_outs, values, self.agent.actions_dim, self.agent.is_continuous, actions=batch["actions"]
        )
        pg = policy_loss(out["logprob"], advantages.reshape(-1, 1), self.loss_reduction)
        vl = value_loss(out["values"], returns.reshape(-1, 1), self.loss_reduction)
        self.apply(torch.autograd.grad(pg + vl, self.params))
        return torch.stack([pg.detach(), vl.detach()])

    def optimizer_state(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update from ``grads`` (in parameter order): the global
        norm clip, then the step."""
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.max_grad_norm > 0:
            clip_grad_global_norm_(self.params, self.max_grad_norm)
        self.optimizer.step()
        for p in self.params:
            p.grad = None


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    from sheeprl_tpu_torch.algos.ppo.ppo import run_on_policy

    return run_on_policy(fabric, cfg, "a2c")
