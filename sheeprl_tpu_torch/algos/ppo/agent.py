"""The PPO agent (port of ``sheeprl_tpu/algos/ppo/agent.py``).

A multi-key feature extractor (``NatureCNN`` over the concatenated cnn keys,
an ``MLP`` over the concatenated mlp keys, their features concatenated), an
actor backbone with one head per discrete action dimension (or one head
emitting ``concat(mean, log_std)`` for continuous control) and a critic MLP.
Children carry the Flax module's names for ``interop/flax_to_torch.py``;
weights start as Flax initialises them, from a ``torch.Generator``.

:func:`policy_output` samples with noise given as an argument: standard
Gumbel noise per logit for the categorical heads (Gumbel-max), standard
normal noise per action for the continuous head (:func:`draw_policy_noise`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.models.models import MLP, NatureCNN, lecun_init_
from sheeprl_tpu_torch.utils.distribution import Independent, Normal, OneHotCategorical, draw_gumbel


class CNNEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_channels: int, features_dim: int, screen_size: int) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.cnn = NatureCNN(in_channels, features_dim, screen_size)
        self.out_dim = features_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)  # channel-first
        if x.ndim > 4 and x.shape[-4] > 1:  # a frame-stack dim goes into the channels
            x = x.reshape(*x.shape[:-4], -1, *x.shape[-2:])
        return self.cnn(x)


class MLPEncoder(nn.Module):
    def __init__(
        self,
        keys: Sequence[str],
        input_dim: int,
        features_dim: Optional[int],
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: Any = "relu",
        layer_norm: bool = False,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = MLP(input_dim, (dense_units,) * mlp_layers, features_dim, dense_act, layer_norm)
        self.out_dim = self.mlp.out_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], dim=-1))


class PPOAgent(nn.Module):
    """``forward(obs)`` returns (actor outputs, one per head; values [..., 1])."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        obs_space: Any,
        screen_size: int,
        encoder_cfg: Dict[str, Any],
        actor_cfg: Dict[str, Any],
        critic_cfg: Dict[str, Any],
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.cnn_encoder = (
            CNNEncoder(
                cnn_keys,
                int(sum(np.prod(obs_space[k].shape[:-2]) for k in cnn_keys)),
                encoder_cfg["cnn_features_dim"],
                screen_size,
            )
            if len(cnn_keys) > 0
            else None
        )
        self.mlp_encoder = (
            MLPEncoder(
                mlp_keys,
                int(sum(np.prod(obs_space[k].shape) for k in mlp_keys)),
                encoder_cfg["mlp_features_dim"],
                encoder_cfg["dense_units"],
                encoder_cfg["mlp_layers"],
                encoder_cfg["dense_act"],
                encoder_cfg["layer_norm"],
            )
            if len(mlp_keys) > 0
            else None
        )
        if self.cnn_encoder is None and self.mlp_encoder is None:
            raise ValueError("there must be at least one encoder (cnn or mlp)")
        features = sum(e.out_dim for e in (self.cnn_encoder, self.mlp_encoder) if e is not None)
        self.critic = MLP(
            features, (critic_cfg["dense_units"],) * critic_cfg["mlp_layers"], 1,
            critic_cfg["dense_act"], critic_cfg["layer_norm"],
        )
        self.actor_backbone = MLP(
            features, (actor_cfg["dense_units"],) * actor_cfg["mlp_layers"], None,
            actor_cfg["dense_act"], actor_cfg["layer_norm"],
        )
        head_sizes = [sum(self.actions_dim) * 2] if self.is_continuous else list(self.actions_dim)
        self.actor_heads = nn.ModuleList(nn.Linear(self.actor_backbone.out_dim, n) for n in head_sizes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initialisation, in the order Flax's init visits the modules."""
        for enc in (self.cnn_encoder, self.mlp_encoder):
            if enc is not None:
                (enc.cnn if isinstance(enc, CNNEncoder) else enc.mlp).init_weights(generator)
        self.actor_backbone.init_weights(generator)
        for head in self.actor_heads:
            lecun_init_(head, generator)
        self.critic.init_weights(generator)

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = [enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None]
        return torch.cat(outs, dim=-1)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.features(obs)
        pre = self.actor_backbone(feat)
        return [head(pre) for head in self.actor_heads], self.critic(feat)

    def get_values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.critic(self.features(obs))


def make_dists(actor_outs: List[torch.Tensor], is_continuous: bool) -> list:
    """The per-head action distributions of the raw actor outputs."""
    if is_continuous:
        mean, log_std = torch.chunk(actor_outs[0], 2, dim=-1)
        return [Independent(Normal(mean, torch.exp(log_std)), 1)]
    return [OneHotCategorical(logits=logits) for logits in actor_outs]


def draw_policy_noise(
    actions_dim: Sequence[int], is_continuous: bool, batch: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """[batch, sum(actions_dim)] noise for :func:`policy_output`: standard normal
    for a continuous action, standard Gumbel for each logit of a discrete one."""
    size = (batch, int(sum(actions_dim)))
    if is_continuous:
        return torch.randn(size, generator=generator, device=device)
    return draw_gumbel(size, generator, device)


def policy_output(
    actor_outs: List[torch.Tensor],
    values: torch.Tensor,
    actions_dim: Sequence[int],
    is_continuous: bool,
    actions: Optional[torch.Tensor] = None,
    greedy: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Sample (with ``noise``), take the mode (``greedy``) or re-evaluate the
    given concatenated ``actions`` (continuous values, or one one-hot block per
    discrete dimension); returns actions, logprob [..., 1], entropy [..., 1]
    and values."""
    if actions is None and not greedy and noise is None:
        raise ValueError("sampling an action needs its noise (draw_policy_noise)")
    dists = make_dists(actor_outs, is_continuous)
    if is_continuous:
        dist = dists[0]
        if actions is None:
            actions = dist.mode if greedy else dist.sample(noise)
        return {
            "actions": actions,
            "logprob": dist.log_prob(actions)[..., None],
            "entropy": dist.entropy()[..., None],
            "values": values,
        }
    split_actions = None if actions is None else torch.split(actions, list(actions_dim), dim=-1)
    split_noise = None if noise is None else torch.split(noise, list(actions_dim), dim=-1)
    sampled, logprobs, entropies = [], [], []
    for i, dist in enumerate(dists):
        if split_actions is not None:
            a = split_actions[i]
        else:
            a = dist.mode if greedy else dist.sample(split_noise[i])
        sampled.append(a)
        logprobs.append(dist.log_prob(a))
        entropies.append(dist.entropy())
    return {
        "actions": torch.cat(sampled, dim=-1),
        "logprob": torch.stack(logprobs, dim=-1).sum(dim=-1, keepdim=True),
        "entropy": torch.stack(entropies, dim=-1).sum(dim=-1, keepdim=True),
        "values": values,
    }


def build_agent(
    fabric,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
) -> PPOAgent:
    """The agent on the fabric's device: Flax's initialisation from ``seed``,
    or the Flax-layout parameters ``agent_state`` of a checkpoint."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_ppo_params

    agent = PPOAgent(
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
        mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        obs_space=obs_space,
        screen_size=cfg.env.screen_size,
        encoder_cfg=dict(cfg.algo.encoder),
        actor_cfg=dict(cfg.algo.actor),
        critic_cfg=dict(cfg.algo.critic),
    )
    agent.init_weights(torch.Generator().manual_seed(int(seed)))
    if agent_state is not None:
        load_ppo_params(agent, agent_state)
    return agent.to(fabric.device)
