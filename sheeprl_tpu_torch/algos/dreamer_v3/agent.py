"""Dreamer-V3 agent in PyTorch (port of ``sheeprl_tpu/algos/dreamer_v3/agent.py``).

The module tree mirrors the Flax one so that ``interop/flax_to_torch.py`` maps
parameters one to one, and checkpoints hold the Flax layout as numpy trees:

- images arrive channel-first; the convolutions run NCHW, but every LayerNorm
  of the CNN encoder normalizes over the channels of one pixel and the final
  flatten is in H, W, C order, exactly as the Flax encoder does in NHWC;
- sampling takes its noise as an argument (Gumbel noise for categoricals,
  standard normal noise for the continuous head): ``argmax(logits + gumbel)``
  is the same draw as ``jax.random.categorical``, so a test can feed both
  packages the same noise, and the serving path draws it from each session's
  own ``torch.Generator``;
- initializers are the Hafner ones of the JAX package (truncated normal with
  variance 1/fan_avg, and scaled uniform heads), drawn from an explicit
  ``torch.Generator``.

This slice holds the player half (encoder, recurrent model, posterior and prior,
actor) to parity with the JAX package. ``build_agent`` builds every module —
decoder, reward, continue, critic and target critic too — so that parameter
trees and checkpoints are whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.models.models import LayerNormGRUCell, resolve_activation
from sheeprl_tpu_torch.utils.utils import symlog

# truncated normal on [-2, 2] standard deviations has this standard deviation
_TRUNC_NORMAL_STD = 0.87962566103423978


# ---------------------------------------------------------------------------------
# Hafner initializers (JAX agent.py:36-45: variance_scaling over fan_avg)
# ---------------------------------------------------------------------------------
def _fans(weight: torch.Tensor, kind: str) -> Tuple[int, int]:
    """(fan_in, fan_out) of a torch weight as Flax counts them for its kernel."""
    if kind == "linear":  # [out, in]
        return weight.shape[1], weight.shape[0]
    if kind == "conv":  # [out, in, kh, kw]
        rf = weight.shape[2] * weight.shape[3]
        return weight.shape[1] * rf, weight.shape[0] * rf
    if kind == "deconv":  # [in, out, kh, kw]
        rf = weight.shape[2] * weight.shape[3]
        return weight.shape[0] * rf, weight.shape[1] * rf
    if kind == "kernel":  # Flax-layout [in, out]
        return weight.shape[0], weight.shape[1]
    raise ValueError(kind)


@torch.no_grad()
def hafner_init_(weight: torch.Tensor, kind: str, generator: torch.Generator) -> None:
    """variance_scaling(1.0, "fan_avg", "truncated_normal")."""
    fan_in, fan_out = _fans(weight, kind)
    std = math.sqrt(1.0 / ((fan_in + fan_out) / 2.0)) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def uniform_init_(weight: torch.Tensor, kind: str, scale: float, generator: torch.Generator) -> None:
    """variance_scaling(scale, "fan_avg", "uniform"); scale 0 gives zeros."""
    if scale == 0.0:
        weight.zero_()
        return
    fan_in, fan_out = _fans(weight, kind)
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    weight.uniform_(-limit, limit, generator=generator)


def _head_init_(weight: torch.Tensor, scale: Optional[float], generator: torch.Generator) -> None:
    if scale is None:
        hafner_init_(weight, "linear", generator)
    else:
        uniform_init_(weight, "linear", scale, generator)


# ---------------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------------
class DenseStack(nn.Module):
    """[Linear(no bias) -> LayerNorm -> act] x n — the Dreamer-V3 MLP block."""

    def __init__(
        self, in_dim: int, units: int, n_layers: int, activation: Any = "silu", eps: float = 1e-3
    ) -> None:
        super().__init__()
        self.act = resolve_activation(activation)
        dims = [in_dim] + [units] * n_layers
        self.linears = nn.ModuleList(
            nn.Linear(dims[i], units, bias=False) for i in range(n_layers)
        )
        self.norms = nn.ModuleList(nn.LayerNorm(units, eps=eps) for _ in range(n_layers))
        self.out_dim = units if n_layers > 0 else in_dim

    def init_weights(self, generator: torch.Generator) -> None:
        for linear in self.linears:
            hafner_init_(linear.weight, "linear", generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for linear, norm in zip(self.linears, self.norms):
            x = self.act(norm(linear(x)))
        return x


class MLPHead(nn.Module):
    """DenseStack + linear head — representation/transition/reward/continue/critic."""

    def __init__(
        self,
        in_dim: int,
        units: int,
        n_layers: int,
        output_dim: int,
        activation: Any = "silu",
        eps: float = 1e-3,
        head_init_scale: Optional[float] = None,
    ) -> None:
        super().__init__()
        self.stack = DenseStack(in_dim, units, n_layers, activation, eps)
        self.head = nn.Linear(self.stack.out_dim, output_dim)
        self.head_init_scale = head_init_scale

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        _head_init_(self.head.weight, self.head_init_scale, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.stack(x))


class CNNEncoder(nn.Module):
    """Stride-2 conv encoder, 64x64 -> 4x4 (JAX agent.py:86). Inputs are
    channel-first [..., C, H, W]; output features are flattened H, W, C."""

    def __init__(
        self,
        keys: Sequence[str],
        in_channels: int,
        channels_multiplier: int,
        stages: int = 4,
        activation: Any = "silu",
        eps: float = 1e-3,
        image_size: int = 64,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.act = resolve_activation(activation)
        chans = [in_channels] + [(2**i) * channels_multiplier for i in range(stages)]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, padding=1, bias=False)
            for i in range(stages)
        )
        self.norms = nn.ModuleList(nn.LayerNorm(chans[i + 1], eps=eps) for i in range(stages))
        side = image_size // (2**stages)
        self.out_dim = chans[-1] * side * side

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            hafner_init_(conv.weight, "conv", generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            # LayerNorm over the channels of each pixel (the Flax NHWC LayerNorm)
            x = self.act(norm(conv(x).permute(0, 2, 3, 1)))
            if i + 1 < len(self.convs):
                x = x.permute(0, 3, 1, 2)
        return x.reshape(*lead, -1)  # NHWC flatten order


class MLPEncoder(nn.Module):
    """Vector encoder with symlog input squashing (JAX agent.py:122)."""

    def __init__(
        self,
        keys: Sequence[str],
        in_dim: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        activation: Any = "silu",
        eps: float = 1e-3,
        symlog_inputs: bool = True,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.stack = DenseStack(in_dim, dense_units, mlp_layers, activation, eps)
        self.out_dim = self.stack.out_dim

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat(
            [symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1
        )
        return self.stack(x)


class Encoder(nn.Module):
    """cnn + mlp encoder over the observation dict."""

    def __init__(self, cnn_encoder: Optional[CNNEncoder], mlp_encoder: Optional[MLPEncoder]) -> None:
        super().__init__()
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder
        self.out_dim = sum(m.out_dim for m in (cnn_encoder, mlp_encoder) if m is not None)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.cnn_encoder, self.mlp_encoder):
            if m is not None:
                m.init_weights(generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        outs = []
        if self.cnn_encoder is not None:
            outs.append(self.cnn_encoder(obs))
        if self.mlp_encoder is not None:
            outs.append(self.mlp_encoder(obs))
        return torch.cat(outs, dim=-1)


class CNNDecoder(nn.Module):
    """latent -> 4x4 -> stride-2 transposed-conv stages -> channel-first images
    per key (JAX agent.py CNNDecoder). Built so the checkpoint tree is whole;
    its parity is held in a later slice."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        latent_dim: int,
        channels_multiplier: int,
        image_size: Tuple[int, int],
        stages: int = 4,
        activation: Any = "silu",
        eps: float = 1e-3,
        hafner_heads: bool = True,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.act = resolve_activation(activation)
        self.hafner_heads = hafner_heads
        self.spatial = image_size[0] // (2**stages)
        self.top_channels = (2 ** (stages - 1)) * channels_multiplier
        self.linear = nn.Linear(latent_dim, self.top_channels * self.spatial * self.spatial)
        chans = [self.top_channels] + [
            (2 ** (stages - 2 - i)) * channels_multiplier for i in range(stages - 1)
        ]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], chans[i + 1], 4, stride=2, padding=1, bias=False)
            for i in range(stages - 1)
        )
        self.deconvs.append(
            nn.ConvTranspose2d(chans[-1], sum(self.output_channels), 4, stride=2, padding=1)
        )
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=eps) for c in chans[1:])

    def init_weights(self, generator: torch.Generator) -> None:
        hafner_init_(self.linear.weight, "linear", generator)
        nn.init.zeros_(self.linear.bias)
        for deconv in self.deconvs[:-1]:
            hafner_init_(deconv.weight, "deconv", generator)
        last = self.deconvs[-1]
        if self.hafner_heads:
            uniform_init_(last.weight, "deconv", 1.0, generator)
        else:
            hafner_init_(last.weight, "deconv", generator)
        nn.init.zeros_(last.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.linear(latent)
        lead = x.shape[:-1]
        x = x.reshape(-1, self.spatial, self.spatial, self.top_channels).permute(0, 3, 1, 2)
        for deconv, norm in zip(self.deconvs[:-1], self.norms):
            x = self.act(norm(deconv(x).permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        x = self.deconvs[-1](x)
        x = x.reshape(*lead, *x.shape[-3:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), dim=-3)))


class MLPDecoder(nn.Module):
    """Shared stack + one linear head per key."""

    def __init__(
        self,
        keys: Sequence[str],
        output_dims: Sequence[int],
        latent_dim: int,
        mlp_layers: int = 4,
        dense_units: int = 512,
        activation: Any = "silu",
        eps: float = 1e-3,
        hafner_heads: bool = True,
    ) -> None:
        super().__init__()
        self.keys = tuple(keys)
        self.hafner_heads = hafner_heads
        self.stack = DenseStack(latent_dim, dense_units, mlp_layers, activation, eps)
        self.heads = nn.ModuleList(nn.Linear(self.stack.out_dim, int(d)) for d in output_dims)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        for head in self.heads:
            _head_init_(head.weight, 1.0 if self.hafner_heads else None, generator)
            nn.init.zeros_(head.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stack(latent)
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class Decoder(nn.Module):
    def __init__(self, cnn_decoder: Optional[CNNDecoder], mlp_decoder: Optional[MLPDecoder]) -> None:
        super().__init__()
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.cnn_decoder, self.mlp_decoder):
            if m is not None:
                m.init_weights(generator)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_decoder is not None:
            out.update(self.cnn_decoder(latent))
        if self.mlp_decoder is not None:
            out.update(self.mlp_decoder(latent))
        return out


class RecurrentModel(nn.Module):
    """Dense input projection + LayerNorm-GRU cell (JAX agent.py:242-262)."""

    def __init__(
        self,
        in_dim: int,
        recurrent_state_size: int,
        dense_units: int,
        activation: Any = "silu",
        eps: float = 1e-3,
    ) -> None:
        super().__init__()
        self.stack = DenseStack(in_dim, dense_units, 1, activation, eps)
        self.cell = LayerNormGRUCell(
            dense_units, recurrent_state_size, bias=False, layer_norm_eps=eps
        )

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        hafner_init_(self.cell.kernel, "kernel", generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.cell(h, self.stack(x))


class Actor(nn.Module):
    """Dreamer-V3 policy head (JAX agent.py:264): DenseStack backbone, one
    logits head per discrete action dim, or one mean/std head for continuous
    control. Returns the raw head outputs; sampling is :func:`actor_sample`."""

    def __init__(
        self,
        latent_dim: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        dense_units: int = 1024,
        mlp_layers: int = 5,
        activation: Any = "silu",
        eps: float = 1e-3,
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.stack = DenseStack(latent_dim, dense_units, mlp_layers, activation, eps)
        if is_continuous:
            dims = [int(np.sum(self.actions_dim)) * 2]
        else:
            dims = list(self.actions_dim)
        self.heads = nn.ModuleList(nn.Linear(self.stack.out_dim, d) for d in dims)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        for head in self.heads:
            uniform_init_(head.weight, "linear", 1.0, generator)
            nn.init.zeros_(head.bias)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.stack(state)
        return [head(x) for head in self.heads]


# ---------------------------------------------------------------------------------
# stochastic-state and actor math (noise as an argument)
# ---------------------------------------------------------------------------------
def unimix_logits(logits: torch.Tensor, discrete: int, unimix: float) -> torch.Tensor:
    """1% uniform mixing of categorical probs over flat [..., S*D] logits."""
    shaped = logits.reshape(*logits.shape[:-1], -1, discrete)
    if unimix > 0.0:
        probs = torch.softmax(shaped, dim=-1)
        probs = (1 - unimix) * probs + unimix * (torch.ones_like(probs) / discrete)
        shaped = torch.log(probs)
    return shaped.reshape(*shaped.shape[:-2], -1)


def stochastic_state(
    logits: torch.Tensor, discrete: int, gumbel: Optional[torch.Tensor] = None, sample: bool = True
) -> torch.Tensor:
    """Straight-through sample (``gumbel`` noise, flat like ``logits``) or mode of
    the [..., S, D] categorical stack. Returns flat [..., S*D]."""
    shaped = logits.reshape(*logits.shape[:-1], -1, discrete)
    if sample:
        if gumbel is None:
            raise ValueError("stochastic_state(sample=True) needs its Gumbel noise")
        idx = torch.argmax(shaped + gumbel.reshape(shaped.shape), dim=-1)
        onehot = F.one_hot(idx, discrete).to(shaped.dtype)
        probs = torch.softmax(shaped, dim=-1)
        out = onehot + probs - probs.detach()
    else:
        out = F.one_hot(torch.argmax(shaped, dim=-1), discrete).to(shaped.dtype)
    return out.reshape(*out.shape[:-2], -1)


def actor_sample(
    agent: "DV3Agent",
    pre_dist: List[torch.Tensor],
    noise: Optional[torch.Tensor] = None,
    greedy: bool = False,
) -> torch.Tensor:
    """Concatenated actions from the raw actor outputs (one-hot blocks for
    discrete dims, clipped tanh-mean scaled normal for continuous control).

    ``noise`` is standard normal noise of the action's shape (continuous) or
    Gumbel noise of the concatenated logits' shape (discrete); greedy sampling
    takes none."""
    cfg = agent.actor_cfg
    if agent.is_continuous:
        mean, std_raw = torch.chunk(pre_dist[0], 2, dim=-1)
        mean = torch.tanh(mean)
        std = (cfg["max_std"] - cfg["min_std"]) * torch.sigmoid(std_raw + cfg["init_std"]) + cfg[
            "min_std"
        ]
        actions = mean if greedy else mean + std * noise
        clip = cfg.get("action_clip", 1.0)
        if clip and clip > 0:
            limit = torch.full_like(actions, clip)
            scale = limit / torch.maximum(limit, torch.abs(actions))
            actions = actions * scale.detach()
        return actions
    if not greedy and noise is None:
        raise ValueError("actor_sample: sampled discrete actions need their Gumbel noise")
    gumbels = None if greedy else torch.split(noise, [p.shape[-1] for p in pre_dist], dim=-1)
    outs = []
    for i, logits in enumerate(pre_dist):
        logits = unimix_logits(logits, logits.shape[-1], cfg.get("unimix", 0.01))
        if greedy:
            outs.append(F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype))
        else:
            idx = torch.argmax(logits + gumbels[i], dim=-1)
            onehot = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
            probs = torch.softmax(logits, dim=-1)
            outs.append(onehot + probs - probs.detach())
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------------
# agent container
# ---------------------------------------------------------------------------------
class DV3Agent(nn.Module):
    """Every Dreamer-V3 module, plus the RSSM primitives the player uses.
    ``world_model`` holds encoder, recurrent/representation/transition models,
    decoder, reward and continue heads and the learnable initial state."""

    def __init__(
        self,
        world_model: nn.ModuleDict,
        initial_recurrent_state: torch.Tensor,
        actor: Actor,
        critic: MLPHead,
        target_critic: MLPHead,
        *,
        actions_dim: Sequence[int],
        is_continuous: bool,
        stochastic_size: int,
        discrete_size: int,
        recurrent_state_size: int,
        unimix: float,
        actor_cfg: Dict[str, Any],
        learnable_initial_recurrent_state: bool = True,
        decoupled_rssm: bool = False,
    ) -> None:
        super().__init__()
        self.world_model = world_model
        self.initial_recurrent_state = nn.Parameter(initial_recurrent_state)
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.unimix = unimix
        self.actor_cfg = dict(actor_cfg)
        self.learnable_initial_recurrent_state = learnable_initial_recurrent_state
        self.decoupled_rssm = decoupled_rssm

    @property
    def encoder(self) -> Encoder:
        return self.world_model["encoder"]

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size

    @property
    def latent_state_size(self) -> int:
        return self.stoch_state_size + self.recurrent_state_size

    def initial_state(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """tanh(learnable w) expanded + transition-mode posterior."""
        w = self.initial_recurrent_state
        if not self.learnable_initial_recurrent_state:
            w = w.detach()
        h0 = torch.tanh(w).expand(*batch_shape, self.recurrent_state_size)
        prior_logits = self.world_model["transition_model"](h0)
        prior_logits = unimix_logits(prior_logits, self.discrete_size, self.unimix)
        z0 = stochastic_state(prior_logits, self.discrete_size, sample=False)
        return h0, z0

    def _representation(
        self, h: torch.Tensor, embedded: torch.Tensor, gumbel: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        rep_in = embedded if self.decoupled_rssm else torch.cat([h, embedded], dim=-1)
        logits = self.world_model["representation_model"](rep_in)
        logits = unimix_logits(logits, self.discrete_size, self.unimix)
        return logits, stochastic_state(logits, self.discrete_size, gumbel)

    def _transition(self, h: torch.Tensor, gumbel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.world_model["transition_model"](h)
        logits = unimix_logits(logits, self.discrete_size, self.unimix)
        return logits, stochastic_state(logits, self.discrete_size, gumbel)

    def _recurrent(self, z: torch.Tensor, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.world_model["recurrent_model"](torch.cat([z, a], dim=-1), h)


def build_agent(
    fabric,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
) -> DV3Agent:
    """Build the agent on ``fabric.device``: initialized from ``seed`` through a
    CPU ``torch.Generator`` (the same weights on every device), or loaded from a
    Flax-layout numpy tree ``agent_state`` (a checkpoint's ``state["agent"]``)."""
    from sheeprl_tpu_torch.config.instantiate import locate

    wm_cfg = cfg.algo.world_model
    actor_cfg = cfg.algo.actor
    critic_cfg = cfg.algo.critic
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    cnn_dec_keys = tuple(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = tuple(cfg.algo.mlp_keys.decoder)
    screen = int(cfg.env.screen_size)
    cnn_stages = int(np.log2(screen) - np.log2(4))
    eps = 1e-3

    cnn_encoder = (
        CNNEncoder(
            keys=cnn_keys,
            in_channels=sum(int(np.prod(obs_space[k].shape[:-2])) for k in cnn_keys),
            channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
            stages=cnn_stages,
            activation=cfg.algo.cnn_act,
            eps=eps,
            image_size=screen,
        )
        if cnn_keys
        else None
    )
    mlp_encoder = (
        MLPEncoder(
            keys=mlp_keys,
            in_dim=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
            mlp_layers=wm_cfg.encoder.mlp_layers,
            dense_units=wm_cfg.encoder.dense_units,
            activation=cfg.algo.dense_act,
            eps=eps,
        )
        if mlp_keys
        else None
    )
    encoder = Encoder(cnn_encoder, mlp_encoder)

    stochastic_size = wm_cfg.stochastic_size
    discrete_size = wm_cfg.discrete_size
    stoch_state_size = stochastic_size * discrete_size
    recurrent_state_size = wm_cfg.recurrent_model.recurrent_state_size
    latent_state_size = stoch_state_size + recurrent_state_size
    act_dim = int(np.sum(actions_dim))
    decoupled_rssm = bool(wm_cfg.get("decoupled_rssm", False))
    posterior_scale = 1.0 if cfg.algo.hafner_initialization else None
    zero_head = 0.0 if cfg.algo.hafner_initialization else None

    cnn_decoder = (
        CNNDecoder(
            keys=cnn_dec_keys,
            output_channels=[int(np.prod(obs_space[k].shape[:-2])) for k in cnn_dec_keys],
            latent_dim=latent_state_size,
            channels_multiplier=wm_cfg.observation_model.cnn_channels_multiplier,
            image_size=tuple(obs_space[cnn_dec_keys[0]].shape[-2:]),
            stages=cnn_stages,
            activation=cfg.algo.cnn_act,
            eps=eps,
            hafner_heads=cfg.algo.hafner_initialization,
        )
        if cnn_dec_keys
        else None
    )
    mlp_decoder = (
        MLPDecoder(
            keys=mlp_dec_keys,
            output_dims=[obs_space[k].shape[0] for k in mlp_dec_keys],
            latent_dim=latent_state_size,
            mlp_layers=wm_cfg.observation_model.mlp_layers,
            dense_units=wm_cfg.observation_model.dense_units,
            activation=cfg.algo.dense_act,
            eps=eps,
            hafner_heads=cfg.algo.hafner_initialization,
        )
        if mlp_dec_keys
        else None
    )
    world_model = nn.ModuleDict(
        {
            "encoder": encoder,
            "recurrent_model": RecurrentModel(
                stoch_state_size + act_dim,
                recurrent_state_size,
                wm_cfg.recurrent_model.dense_units,
                cfg.algo.dense_act,
                eps,
            ),
            "representation_model": MLPHead(
                encoder.out_dim if decoupled_rssm else recurrent_state_size + encoder.out_dim,
                wm_cfg.representation_model.hidden_size,
                1,
                stoch_state_size,
                wm_cfg.representation_model.dense_act,
                eps,
                posterior_scale,
            ),
            "transition_model": MLPHead(
                recurrent_state_size,
                wm_cfg.transition_model.hidden_size,
                1,
                stoch_state_size,
                wm_cfg.transition_model.dense_act,
                eps,
                posterior_scale,
            ),
            "observation_model": Decoder(cnn_decoder, mlp_decoder),
            "reward_model": MLPHead(
                latent_state_size,
                wm_cfg.reward_model.dense_units,
                wm_cfg.reward_model.mlp_layers,
                wm_cfg.reward_model.bins,
                cfg.algo.dense_act,
                eps,
                zero_head,
            ),
            "continue_model": MLPHead(
                latent_state_size,
                wm_cfg.discount_model.dense_units,
                wm_cfg.discount_model.mlp_layers,
                1,
                cfg.algo.dense_act,
                eps,
                posterior_scale,
            ),
        }
    )

    actor_cls = Actor
    cls_path = str(actor_cfg.get("cls") or "")
    if cls_path:
        actor_cls = locate(cls_path)
        if actor_cls is not Actor:
            raise NotImplementedError(
                f"algo.actor.cls={cls_path}: only the plain Dreamer-V3 Actor is ported "
                "(MineDojo action masking is not yet ported)"
            )

    def make_critic() -> MLPHead:
        return MLPHead(
            latent_state_size,
            critic_cfg.dense_units,
            critic_cfg.mlp_layers,
            critic_cfg.bins,
            critic_cfg.dense_act,
            eps,
            zero_head,
        )

    agent = DV3Agent(
        world_model,
        torch.zeros(recurrent_state_size),
        actor_cls(
            latent_state_size,
            actions_dim,
            is_continuous,
            actor_cfg.dense_units,
            actor_cfg.mlp_layers,
            actor_cfg.dense_act,
            eps,
        ),
        make_critic(),
        make_critic(),
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        stochastic_size=stochastic_size,
        discrete_size=discrete_size,
        recurrent_state_size=recurrent_state_size,
        unimix=cfg.algo.unimix,
        actor_cfg={
            "init_std": actor_cfg.init_std,
            "min_std": actor_cfg.min_std,
            "max_std": actor_cfg.get("max_std", 1.0),
            "unimix": actor_cfg.get("unimix", cfg.algo.unimix),
            "action_clip": actor_cfg.get("action_clip", 1.0),
        },
        learnable_initial_recurrent_state=wm_cfg.learnable_initial_recurrent_state,
        decoupled_rssm=decoupled_rssm,
    )

    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_to_torch import load_flax_params

        load_flax_params(agent, agent_state)
    else:
        generator = torch.Generator().manual_seed(int(seed))
        for name in (
            "encoder",
            "recurrent_model",
            "representation_model",
            "transition_model",
            "observation_model",
            "reward_model",
            "continue_model",
        ):
            world_model[name].init_weights(generator)
        agent.actor.init_weights(generator)
        agent.critic.init_weights(generator)
        agent.target_critic.load_state_dict(agent.critic.state_dict())
    return agent.to(fabric.device)
