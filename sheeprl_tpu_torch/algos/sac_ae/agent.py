"""The SAC-AE agent (port of ``sheeprl_tpu/algos/sac_ae/agent.py``): pixel
SAC with an autoencoder (arXiv:1910.01741).

- :class:`ConvTrunk`: four k3 convolutions (strides 2, 1, 1, 1, VALID, ReLU)
  over the channel-first frames of every image key (frame stacks folded into
  the channels), flattened in H, W, C order as the Flax trunk does in NHWC;
- :class:`EncoderFC`: Dense -> LayerNorm (eps 1e-6) -> tanh, one per side
  (``critic_cnn_fc``, ``actor_cnn_fc``) on the shared trunk;
- :class:`VectorEncoder`: the vector keys' MLP, shared by both sides;
- :class:`CNNDecoderAE`: Dense to the trunk's output map, three stride-1 k3
  transposed convolutions (ReLU), then a k4 stride-2 one, all VALID, back
  to the frames; :class:`MLPDecoderAE` for the vector keys;
- the twin Q critics are SAC's :class:`CriticEnsemble` on ``[features,
  action]``; the actor (:class:`SACAEActor`) maps its log-std through tanh
  into [-10, 2];
- ``target`` holds the EMA copies of the trunk, the vector encoder, the
  critic's fc and the Q critics.

Children carry the Flax modules' names for ``interop/flax_to_torch.py``
(:func:`sac_ae_to_flax`, :func:`load_sac_ae_params`); weights start as Flax
initialises them, from a ``torch.Generator``. On the card the convolutions
are cuDNN's: the JAX package runs no Pallas kernel here.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import lecun_kernel_
from sheeprl_tpu_torch.algos.sac.agent import CriticEnsemble, SACActor
from sheeprl_tpu_torch.models.models import MLP, lecun_init_

LOG_STD_MAX = 2.0
LOG_STD_MIN = -10.0


class ConvTrunk(nn.Module):
    """The shared conv stack: 4 k3 convolutions (stride 2, 1, 1, 1), ReLU,
    flattened H, W, C."""

    def __init__(self, keys: Sequence[str], in_channels: int, channels_multiplier: int, screen_size: int):
        super().__init__()
        self.keys = tuple(keys)
        channels = 32 * int(channels_multiplier)
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3, stride=2 if i == 0 else 1) for i in range(4)
        )
        side = (int(screen_size) - 3) // 2 + 1 - 2 * 3
        self.conv_shape = (side, side, channels)  # the output map, H, W, C
        self.out_dim = side * side * channels

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            lecun_init_(conv, generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for conv in self.convs:
            x = torch.relu(conv(x))
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)


class EncoderFC(nn.Module):
    """Dense -> LayerNorm -> tanh: a side's projection of the trunk's output."""

    def __init__(self, in_dim: int, features_dim: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, features_dim)
        self.norm = nn.LayerNorm(features_dim, eps=1e-6)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init_(self.linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.norm(self.linear(x)))


class VectorEncoder(nn.Module):
    """The vector keys, concatenated, through an MLP."""

    def __init__(self, keys: Sequence[str], in_dim: int, dense_units: int, mlp_layers: int, activation: Any = "relu",
                 layer_norm: bool = False):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = MLP(in_dim, (int(dense_units),) * int(mlp_layers), None, activation, layer_norm)
        self.out_dim = self.mlp.out_dim

    def init_weights(self, generator: torch.Generator) -> None:
        self.mlp.init_weights(generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.mlp(torch.cat([obs[k] for k in self.keys], dim=-1))


class CNNDecoderAE(nn.Module):
    """features -> Dense -> the trunk's output map -> three k3 stride-1
    transposed convolutions (ReLU) -> a k4 stride-2 one, all VALID, ->
    channel-first frames per key."""

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], conv_shape: Tuple[int, int, int],
                 feat_dim: int):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.conv_shape = tuple(int(d) for d in conv_shape)
        channels = self.conv_shape[-1]
        self.linear = nn.Linear(feat_dim, int(np.prod(self.conv_shape)))
        self.deconvs = nn.ModuleList(nn.ConvTranspose2d(channels, channels, 3, stride=1) for _ in range(3))
        self.deconvs.append(nn.ConvTranspose2d(channels, sum(self.output_channels), 4, stride=2))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init_(self.linear, generator)
        for deconv in self.deconvs:
            # torch's (in, out, kH, kW): Flax's HWIO kernel has in x k x k inputs per output
            lecun_kernel_(deconv.weight, deconv.weight.shape[0] * deconv.weight[0, 0].numel(), generator)
            nn.init.zeros_(deconv.bias)

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = feat.shape[:-1]
        x = self.linear(feat).reshape(-1, *self.conv_shape).permute(0, 3, 1, 2)
        for deconv in self.deconvs[:-1]:
            x = torch.relu(deconv(x))
        x = self.deconvs[-1](x)
        x = x.reshape(*lead, *x.shape[-3:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), dim=-3)))


class MLPDecoderAE(nn.Module):
    """features -> an MLP -> one linear head per vector key."""

    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], feat_dim: int, dense_units: int,
                 mlp_layers: int, activation: Any = "relu", layer_norm: bool = False):
        super().__init__()
        self.keys = tuple(keys)
        self.mlp = MLP(feat_dim, (int(dense_units),) * int(mlp_layers), None, activation, layer_norm)
        self.heads = nn.ModuleList(nn.Linear(self.mlp.out_dim, int(d)) for d in output_dims)

    def init_weights(self, generator: torch.Generator) -> None:
        self.mlp.init_weights(generator)
        for head in self.heads:
            lecun_init_(head, generator)

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(feat)
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class SACAEActor(SACActor):
    """SAC's actor on the features, its log-std squashed by tanh into
    [LOG_STD_MIN, LOG_STD_MAX] before the exp."""

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.model(feat)
        log_std = torch.tanh(self.fc_logstd(x))
        log_std = LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (log_std + 1)
        return self.fc_mean(x), torch.exp(log_std)


# the modules the target holds, by their params tree key
TARGET_KEYS = ("conv", "mlp_enc", "critic_cnn_fc", "qfs")


class SACAEAgent(nn.Module):
    """Every SAC-AE module (module docstring) and ``log_alpha`` [1]; modules
    of a side without keys are None."""

    def __init__(self, conv: Optional[ConvTrunk], mlp_enc: Optional[VectorEncoder], features_dim: int,
                 qfs: CriticEnsemble, actor: SACAEActor, cnn_decoder: Optional[CNNDecoderAE],
                 mlp_decoder: Optional[MLPDecoderAE], alpha: float):
        super().__init__()
        self.conv = conv
        self.mlp_enc = mlp_enc
        self.critic_cnn_fc = EncoderFC(conv.out_dim, features_dim) if conv is not None else None
        self.actor_cnn_fc = EncoderFC(conv.out_dim, features_dim) if conv is not None else None
        self.qfs = qfs
        self.actor = actor
        self.decoder = nn.ModuleDict({k: m for k, m in (("cnn", cnn_decoder), ("mlp", mlp_decoder)) if m is not None})
        self.log_alpha = nn.Parameter(torch.log(torch.tensor([alpha], dtype=torch.float32)))
        self.target = nn.ModuleDict(
            {k: copy.deepcopy(getattr(self, k)).requires_grad_(False) for k in TARGET_KEYS if getattr(self, k) is not None}
        )

    @property
    def device(self) -> torch.device:
        return self.log_alpha.device

    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initialisation in the JAX build's order of modules; the
        targets start as copies."""
        for name in ("conv", "critic_cnn_fc", "actor_cnn_fc", "mlp_enc", "qfs", "actor"):
            module = getattr(self, name)
            if module is not None:
                module.init_weights(generator)
        for module in self.decoder.values():
            module.init_weights(generator)
        for k, module in self.target.items():
            module.load_state_dict(getattr(self, k).state_dict())

    def trunk(self, obs: Dict[str, torch.Tensor], target: bool = False) -> Tuple[Optional[torch.Tensor], ...]:
        """(the conv trunk's output, the vector encoder's), None for a side
        without keys; ``target`` reads the target's copies."""
        parts = [(self.target[k] if k in self.target else None) if target else getattr(self, k)
                 for k in ("conv", "mlp_enc")]
        return tuple(part(obs) if part is not None else None for part in parts)

    def heads(self, trunk_out: Tuple[Optional[torch.Tensor], ...], side: str = "critic", target: bool = False,
              detach: bool = False) -> torch.Tensor:
        """The concatenated features of ``trunk``'s outputs: the conv output
        through ``side``'s fc (the target's critic fc with ``target``), then
        the vector encoding. ``detach`` stops the gradients at the shared
        trunks, not at the fc."""
        conv_out, mlp_out = trunk_out
        outs = []
        if conv_out is not None:
            fc = self.target["critic_cnn_fc"] if target else (self.critic_cnn_fc if side == "critic" else self.actor_cnn_fc)
            outs.append(fc(conv_out.detach() if detach else conv_out))
        if mlp_out is not None:
            outs.append(mlp_out.detach() if detach else mlp_out)
        return torch.cat(outs, dim=-1)

    def features(self, obs: Dict[str, torch.Tensor], side: str = "critic", detach_encoder_features: bool = False,
                 target: bool = False) -> torch.Tensor:
        """``features`` of the JAX agent: ``heads(trunk(obs))``."""
        return self.heads(self.trunk(obs, target), side, target, detach_encoder_features)

    def reconstruct(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for module in self.decoder.values():
            out.update(module(feat))
        return out


def build_agent(fabric, cfg, observation_space, action_space, seed: int,
                agent_state: Optional[Dict[str, Any]] = None) -> SACAEAgent:
    """The agent on the fabric's device: Flax's initialisation from ``seed``,
    or the Flax-layout parameters ``agent_state`` of a checkpoint. An odd
    ``env.screen_size`` is refused: the decoder's k4 stride-2 stage inverts
    the trunk's k3 stride-2 one only for even sizes."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_sac_ae_params

    if fabric.compute_dtype != torch.float32:
        raise NotImplementedError("SAC-AE at bf16 is not yet ported to sheeprl_tpu_torch")
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    cnn_dec_keys = tuple(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = tuple(cfg.algo.mlp_keys.decoder)
    screen = int(cfg.env.screen_size)
    if screen % 2 != 0:
        raise ValueError(f"SAC-AE requires an even env.screen_size, got {screen}")
    act_dim = int(np.prod(action_space.shape))
    cm = int(cfg.algo.cnn_channels_multiplier)
    enc = cfg.algo.encoder
    conv = (
        ConvTrunk(cnn_keys, sum(int(np.prod(observation_space[k].shape[:-2])) for k in cnn_keys), cm, screen)
        if cnn_keys else None
    )
    mlp_enc = (
        VectorEncoder(mlp_keys, sum(int(np.prod(observation_space[k].shape)) for k in mlp_keys), enc.dense_units,
                      enc.mlp_layers, enc.dense_act, enc.layer_norm)
        if mlp_keys else None
    )
    feat_dim = (int(enc.features_dim) if conv is not None else 0) + (mlp_enc.out_dim if mlp_enc is not None else 0)
    hidden = int(cfg.algo.hidden_size)
    dec = cfg.algo.decoder
    cnn_decoder = (
        CNNDecoderAE(cnn_dec_keys, [int(np.prod(observation_space[k].shape[:-2])) for k in cnn_dec_keys],
                     conv.conv_shape, feat_dim)
        if cnn_dec_keys else None
    )
    mlp_decoder = (
        MLPDecoderAE(mlp_dec_keys, [observation_space[k].shape[0] for k in mlp_dec_keys], feat_dim, dec.dense_units,
                     dec.mlp_layers, dec.dense_act, dec.layer_norm)
        if mlp_dec_keys else None
    )
    agent = SACAEAgent(
        conv, mlp_enc, int(enc.features_dim), CriticEnsemble(feat_dim + act_dim, int(cfg.algo.critic.n), hidden),
        SACAEActor(feat_dim, act_dim, hidden, action_space.low, action_space.high), cnn_decoder, mlp_decoder,
        float(cfg.algo.alpha.alpha),
    )
    agent.init_weights(torch.Generator().manual_seed(int(seed)))
    if agent_state is not None:
        load_sac_ae_params(agent, agent_state)
    return agent.to(fabric.device)
