"""The SAC agent (port of ``sheeprl_tpu/algos/sac/agent.py``).

A tanh-squashed Gaussian actor rescaled to the action bounds, an ensemble of
``n`` Q critics with stacked parameters (one batched product per layer, the
layout of the JAX package's vmapped ensemble), EMA target critics and a
learned ``log_alpha``. Children carry the Flax modules' names for
``interop/flax_to_torch.py``; weights start as Flax initialises them, from a
``torch.Generator``.

:func:`squash_and_logprob` takes its standard normal noise as an argument, so
that both packages can be fed the same draws.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.models.models import MLP, EnsembleMLP, lecun_init_

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0


class SACActor(nn.Module):
    """MLP -> (mean, std) heads (``Dense_0`` the mean, ``Dense_1`` the log-std,
    clipped to [-5, 2] before the exp); ``action_scale``/``action_bias`` map
    tanh's range onto the action bounds."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int, action_low, action_high) -> None:
        super().__init__()
        self.model = MLP(obs_dim, (hidden_size, hidden_size), None, "relu")
        self.fc_mean = nn.Linear(hidden_size, action_dim)
        self.fc_logstd = nn.Linear(hidden_size, action_dim)
        low = np.asarray(action_low, dtype=np.float64).reshape(-1)
        high = np.asarray(action_high, dtype=np.float64).reshape(-1)
        self.register_buffer("action_scale", torch.tensor((high - low) / 2.0, dtype=torch.float32), persistent=False)
        self.register_buffer("action_bias", torch.tensor((high + low) / 2.0, dtype=torch.float32), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.model.init_weights(generator)
        lecun_init_(self.fc_mean, generator)
        lecun_init_(self.fc_logstd, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.model(obs)
        log_std = self.fc_logstd(x)
        return self.fc_mean(x), torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))


def squash_and_logprob(
    mean: torch.Tensor, std: torch.Tensor, eps: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized sample ``mean + std * eps`` -> tanh -> rescale; its
    log-prob [..., 1] with the change-of-variable correction
    ``log(action_scale (1 - y^2) + 1e-6)`` (the scale inside the log)."""
    x_t = mean + std * eps
    y_t = torch.tanh(x_t)
    action = y_t * action_scale + action_bias
    log_prob = -0.5 * (((x_t - mean) / std) ** 2 + 2 * torch.log(std) + math.log(2 * math.pi))
    log_prob = log_prob - torch.log(action_scale * (1 - y_t**2) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


def greedy_action(mean: torch.Tensor, action_scale: torch.Tensor, action_bias: torch.Tensor) -> torch.Tensor:
    return torch.tanh(mean) * action_scale + action_bias


class CriticEnsemble(nn.Module):
    """``n`` Q(s, a) critics (two hidden layers, ReLU) evaluated as one
    :class:`EnsembleMLP`: ``forward(obs, action)`` -> ``[..., n]``.
    ``flax_name`` is the vmapped module's name in the Flax tree."""

    flax_name = "VmapSACCritic_0"

    def __init__(self, input_dim: int, n: int, hidden_size: int, layer_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.n = int(n)
        self.mlp = EnsembleMLP(n, input_dim, (hidden_size, hidden_size), 1, "relu", layer_norm, dropout)

    def init_weights(self, generator: torch.Generator) -> None:
        self.mlp.init_weights(generator)

    def forward(
        self, obs: torch.Tensor, action: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
    ) -> torch.Tensor:
        """``keep``: dropout keep-masks per hidden layer, ``[n, rows, hidden]``."""
        out = self.mlp(torch.cat([obs, action], dim=-1), keep)
        return out[..., 0].movedim(0, -1)


class SACAgent(nn.Module):
    """``actor``, ``critic``, ``target_critic`` (a copy of the critic that only
    the EMA moves) and ``log_alpha`` [1]."""

    def __init__(self, actor: SACActor, critic: CriticEnsemble, alpha: float) -> None:
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = copy.deepcopy(critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([alpha], dtype=torch.float32)))

    def init_weights(self, generator: torch.Generator) -> None:
        self.actor.init_weights(generator)
        self.critic.init_weights(generator)
        self.target_critic.load_state_dict(self.critic.state_dict())


def build_agent(
    fabric,
    cfg,
    observation_space,
    action_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
    critic_cls: type = CriticEnsemble,
    **critic_kwargs: Any,
) -> SACAgent:
    """The agent on the fabric's device: Flax's initialisation from ``seed``,
    or the Flax-layout parameters ``agent_state`` of a checkpoint.
    ``critic_cls``/``critic_kwargs`` choose the ensemble (DroQ's)."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_sac_params

    obs_dim = int(sum(np.prod(observation_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
    act_dim = int(np.prod(action_space.shape))
    actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), action_space.low, action_space.high)
    critic = critic_cls(obs_dim + act_dim, int(cfg.algo.critic.n), int(cfg.algo.critic.hidden_size), **critic_kwargs)
    agent = SACAgent(actor, critic, float(cfg.algo.alpha.alpha))
    agent.init_weights(torch.Generator().manual_seed(int(seed)))
    if agent_state is not None:
        load_sac_params(agent, agent_state)
    return agent.to(fabric.device)
