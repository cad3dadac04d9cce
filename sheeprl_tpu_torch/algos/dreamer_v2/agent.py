"""Dreamer-V2 agent in PyTorch (port of ``sheeprl_tpu/algos/dreamer_v2/agent.py``).

The module tree mirrors the Flax one, so ``interop/flax_to_torch.py`` maps the
parameters one to one (``dv2_to_flax``, ``load_dv2_params``):

- ``DenseStack`` is ``[Linear -> LayerNorm? -> act] x n`` with a bias only
  when there is no LayerNorm (eps 1e-3), ELU by default; Flax's default
  initializers (``lecun_normal`` kernels, zero biases), drawn from an explicit
  ``torch.Generator``;
- the CNN encoder's four convolutions are k4, s2, VALID (64 -> 31 -> 14 -> 6
  -> 2), channels ``[1, 2, 4, 8] x multiplier``, run NCHW; a LayerNorm
  normalizes the channels of each pixel and the final flatten is in H, W, C
  order, as the Flax encoder does in NHWC;
- the CNN decoder maps the latent to a 1 x 1 map and grows it with
  transposed convolutions k5, k5, k6, k6, s2, VALID (1 -> 5 -> 13 -> 30 ->
  64);
- the RSSM has zero initial states; its recurrent cell is the LayerNorm-GRU
  with a bias (``recurrent_model.layer_norm``, True in the algo config: the
  cell runs the hand-written kernel on a CUDA tensor);
- samplers take their noise as arguments: Gumbel noise for the categorical
  latents and discrete actions, uniform noise in [1e-6, 1 - 1e-6] for the
  ``TruncatedNormal`` continuous actions, and the exploration noise's draws
  (``add_exploration_noise``).

The Dreamer-V1 agent (``algos/dreamer_v1/agent.py``) builds on these blocks.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Decoder, Encoder, stochastic_state
from sheeprl_tpu_torch.models.models import LayerNormGRUCell, cast_once, lecun_init_, resolve_activation
from sheeprl_tpu_torch.utils.distribution import (
    TruncatedNormal,
    draw_gumbel,
    draw_truncated_uniform,
    log_softmax,
)

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def lecun_kernel_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` for a kernel of ``fan_in`` inputs per output
    (the GRU's ``[K, 3H]`` kernel, a transposed convolution's ``in x k x k``)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _nhwc_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of each pixel of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------------
class DenseStack(nn.Module):
    """[Linear (bias unless layer_norm) -> LayerNorm? -> act] x n: the
    Dreamer-V1/V2 MLP block."""

    def __init__(self, in_dim: int, units: int, n_layers: int, activation: Any = "elu", layer_norm: bool = False):
        super().__init__()
        self.act = resolve_activation(activation)
        dims = [in_dim] + [units] * n_layers
        self.linears = nn.ModuleList(nn.Linear(dims[i], units, bias=not layer_norm) for i in range(n_layers))
        self.norms = nn.ModuleList(nn.LayerNorm(units, eps=1e-3) for _ in range(n_layers)) if layer_norm else nn.ModuleList()
        self.out_dim = units if n_layers > 0 else in_dim

    def init_weights(self, generator: torch.Generator) -> None:
        for linear in self.linears:
            lecun_init_(linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, linear in enumerate(self.linears):
            x = linear(x)
            if len(self.norms):
                x = self.norms[i](x)
            x = self.act(x)
        return x


class MLPHead(nn.Module):
    """DenseStack + a linear head."""

    def __init__(
        self, in_dim: int, units: int, n_layers: int, output_dim: int, activation: Any = "elu", layer_norm: bool = False
    ):
        super().__init__()
        self.stack = DenseStack(in_dim, units, n_layers, activation, layer_norm)
        self.head = nn.Linear(self.stack.out_dim, output_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        lecun_init_(self.head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.stack(x))


class CNNEncoder(nn.Module):
    """Four k4-s2 VALID convolutions, channels [1, 2, 4, 8] x multiplier, over
    channel-first frames; features flattened H, W, C."""

    def __init__(
        self,
        keys: Sequence[str],
        in_channels: int,
        channels_multiplier: int,
        activation: Any = "elu",
        layer_norm: bool = False,
        image_size: int = 64,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.act = resolve_activation(activation)
        chans = [in_channels] + [m * channels_multiplier for m in (1, 2, 4, 8)]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, bias=not layer_norm) for i in range(4)
        )
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=1e-3) for c in chans[1:]) if layer_norm else nn.ModuleList()
        side = image_size
        for _ in range(4):
            side = (side - 4) // 2 + 1
        self.out_dim = chans[-1] * side * side

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            lecun_init_(conv, generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-3)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if len(self.norms):
                x = _nhwc_norm(self.norms[i], x)
            x = self.act(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC flatten order


class MLPEncoder(nn.Module):
    """A DenseStack over the concatenated vector observations."""

    def __init__(
        self,
        keys: Sequence[str],
        in_dim: int,
        mlp_layers: int = 4,
        dense_units: int = 400,
        activation: Any = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.stack = DenseStack(in_dim, dense_units, mlp_layers, activation, layer_norm)
        self.out_dim = self.stack.out_dim

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.stack(torch.cat([obs[k] for k in self.keys], dim=-1))


class CNNDecoder(nn.Module):
    """latent -> Linear(encoder output) -> 1 x 1 map -> transposed convolutions
    k5, k5, k6, k6, s2, VALID -> channel-first 64 x 64 images per key."""

    def __init__(
        self,
        keys: Sequence[str],
        output_channels: Sequence[int],
        latent_dim: int,
        channels_multiplier: int,
        cnn_encoder_output_dim: int,
        activation: Any = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.act = resolve_activation(activation)
        self.linear = nn.Linear(latent_dim, cnn_encoder_output_dim)
        specs = [(4 * channels_multiplier, 5), (2 * channels_multiplier, 5), (channels_multiplier, 6)]
        chans = [cnn_encoder_output_dim] + [c for c, _ in specs]
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(chans[i], c, k, stride=2, bias=not layer_norm) for i, (c, k) in enumerate(specs)
        )
        self.deconvs.append(nn.ConvTranspose2d(chans[-1], sum(self.output_channels), 6, stride=2))
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=1e-3) for c, _ in specs) if layer_norm else nn.ModuleList()

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init_(self.linear, generator)
        for deconv in self.deconvs:
            # torch's (in, out, kH, kW): Flax's HWIO kernel has in x k x k inputs per output
            lecun_kernel_(deconv.weight, deconv.weight.shape[0] * deconv.weight[0, 0].numel(), generator)
            if deconv.bias is not None:
                nn.init.zeros_(deconv.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.linear(latent)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1], 1, 1)
        for i, deconv in enumerate(self.deconvs[:-1]):
            x = deconv(x)
            if len(self.norms):
                x = _nhwc_norm(self.norms[i], x)
            x = self.act(x)
        x = self.deconvs[-1](x)
        x = x.reshape(*lead, *x.shape[-3:])
        return dict(zip(self.keys, torch.split(x, list(self.output_channels), dim=-3)))


class MLPDecoder(nn.Module):
    """A shared DenseStack and one linear head per key."""

    def __init__(
        self,
        keys: Sequence[str],
        output_dims: Sequence[int],
        latent_dim: int,
        mlp_layers: int = 4,
        dense_units: int = 400,
        activation: Any = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.keys = tuple(keys)
        self.stack = DenseStack(latent_dim, dense_units, mlp_layers, activation, layer_norm)
        self.heads = nn.ModuleList(nn.Linear(self.stack.out_dim, int(d)) for d in output_dims)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        for head in self.heads:
            lecun_init_(head, generator)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stack(latent)
        return {k: head(x) for k, head in zip(self.keys, self.heads)}


class RecurrentModel(nn.Module):
    """A one-layer DenseStack projection, then the GRU cell with a bias and,
    with ``layer_norm``, the LayerNorm over its gates (the LN-GRU kernel on a
    CUDA tensor)."""

    def __init__(
        self, in_dim: int, recurrent_state_size: int, dense_units: int, activation: Any = "elu", layer_norm: bool = True
    ):
        super().__init__()
        self.stack = DenseStack(in_dim, dense_units, 1, activation, False)
        self.cell = LayerNormGRUCell(dense_units, recurrent_state_size, bias=True, layer_norm=layer_norm)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        lecun_kernel_(self.cell.kernel, self.cell.kernel.shape[0], generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.cell(h, self.stack(x))


class Actor(nn.Module):
    """DenseStack backbone, then one logits head per discrete action dim, or
    one (mean, std) head for continuous control. Returns the raw head
    outputs; sampling is :func:`actor_sample`."""

    def __init__(
        self,
        latent_dim: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        dense_units: int = 400,
        mlp_layers: int = 4,
        activation: Any = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.stack = DenseStack(latent_dim, dense_units, mlp_layers, activation, layer_norm)
        dims = [int(np.sum(self.actions_dim)) * 2] if is_continuous else list(self.actions_dim)
        self.heads = nn.ModuleList(nn.Linear(self.stack.out_dim, d) for d in dims)

    def init_weights(self, generator: torch.Generator) -> None:
        self.stack.init_weights(generator)
        for head in self.heads:
            lecun_init_(head, generator)

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.stack(state)
        return [head(x) for head in self.heads]


# ---------------------------------------------------------------------------------
# actor math (noise as an argument)
# ---------------------------------------------------------------------------------
def _truncated_normal(agent, pre: torch.Tensor) -> TruncatedNormal:
    cfg = agent.actor_cfg
    mean, std_raw = torch.chunk(pre, 2, dim=-1)
    std = 2 * torch.sigmoid((std_raw + cfg["init_std"]) / 2) + cfg["min_std"]
    return TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0)


def actor_sample(agent, pre_dist: List[torch.Tensor], noise: Optional[torch.Tensor] = None, greedy: bool = False):
    """Concatenated actions from the raw actor outputs: the TruncatedNormal's
    mode or its sample from uniform ``noise`` (continuous), or one one-hot
    block per discrete head, its argmax or its straight-through sample from
    Gumbel ``noise`` over the concatenated logits."""
    if agent.is_continuous:
        dist = _truncated_normal(agent, pre_dist[0])
        return dist.mode if greedy else dist.rsample(noise)
    if greedy:
        return torch.cat([F.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype) for logits in pre_dist], -1)
    if noise is None:
        raise ValueError("actor_sample: sampled discrete actions need their Gumbel noise")
    gumbels = torch.split(noise, [p.shape[-1] for p in pre_dist], dim=-1)
    return torch.cat([stochastic_state(logits, logits.shape[-1], g) for logits, g in zip(pre_dist, gumbels)], -1)


def draw_actor_noise(agent, shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Noise for :func:`actor_sample` over ``shape`` leading dims: uniform per
    continuous action, Gumbel per logit of the discrete heads."""
    size = (*shape, int(np.sum(agent.actions_dim)))
    if agent.is_continuous:
        return draw_truncated_uniform(size, generator, device)
    return draw_gumbel(size, generator, device)


def actor_logprob_entropy(agent, pre_dist: List[torch.Tensor], actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-prob [..., 1], entropy [...]) of the concatenated ``actions``; the
    continuous TruncatedNormal reports zero entropy, as the JAX agent does."""
    if agent.is_continuous:
        lp = _truncated_normal(agent, pre_dist[0]).log_prob(actions).sum(dim=-1, keepdim=True)
        return lp, torch.zeros_like(lp[..., 0])
    lps, ents = [], []
    for logits, act in zip(pre_dist, torch.split(actions, list(agent.actions_dim), dim=-1)):
        lp_all = log_softmax(logits, dim=-1)
        lps.append(torch.sum(lp_all * act, dim=-1))
        ents.append(-torch.sum(torch.exp(lp_all) * lp_all, dim=-1))
    return torch.stack(lps, -1).sum(-1, keepdim=True), torch.stack(ents, -1).sum(-1)


def draw_exploration_noise(agent, n: int, generator: Optional[torch.Generator], device) -> Dict[str, torch.Tensor]:
    """The draws of :func:`add_exploration_noise` for ``n`` rows: standard
    normal noise per continuous action; per discrete head a uniform index
    and a uniform in [0, 1) that decides whether it replaces the action."""
    if agent.is_continuous:
        return {"normal": torch.randn((n, int(np.sum(agent.actions_dim))), device=device, generator=generator)}
    index = torch.stack(
        [torch.randint(0, d, (n,), device=device, generator=generator) for d in agent.actions_dim], dim=-1
    )
    return {"index": index, "mask": torch.rand((n, len(agent.actions_dim)), device=device, generator=generator)}


def add_exploration_noise(agent, actions: torch.Tensor, noise: Dict[str, torch.Tensor], expl_amount: float):
    """Gaussian noise of scale ``expl_amount``, clipped to [-1, 1], for
    continuous actions; for discrete ones each head's action is replaced by a
    uniform one-hot where its mask draw is below ``expl_amount``."""
    if agent.is_continuous:
        return torch.clamp(actions + noise["normal"] * expl_amount, -1.0, 1.0)
    outs = []
    for i, act in enumerate(torch.split(actions, list(agent.actions_dim), dim=-1)):
        sample = F.one_hot(noise["index"][..., i], act.shape[-1]).to(act.dtype)
        outs.append(torch.where((noise["mask"][..., i] < expl_amount)[..., None], sample, act))
    return torch.cat(outs, dim=-1)


def expl_amount_at(actor_cfg: Dict[str, Any], step: int) -> float:
    """The exploration amount at policy step ``step``: ``expl_amount``,
    halved every ``expl_decay`` steps when that is set, never below
    ``expl_min`` (the JAX loop's anneal)."""
    amount = actor_cfg["expl_amount"]
    if actor_cfg["expl_decay"]:
        amount = amount * (0.5 ** (step / actor_cfg["expl_decay"]))
    return max(amount, actor_cfg["expl_min"])


# ---------------------------------------------------------------------------------
# agent container
# ---------------------------------------------------------------------------------
class DV2Agent(nn.Module):
    """Every Dreamer-V2 module and the RSSM primitives. ``world_model`` holds
    the encoder, the recurrent, representation and transition models, the
    decoder, the reward head and, with ``use_continues``, the continue head.
    The stochastic state is a stack of categoricals, sampled straight-through
    from Gumbel noise; the initial states are zeros. Float32 only."""

    dtype = torch.float32
    # the stochastic state's noise: Gumbel per logit (Dreamer-V1: normal per variable)
    state_noise = "gumbel"

    def __init__(
        self,
        world_model: nn.ModuleDict,
        actor: Actor,
        critic: MLPHead,
        target_critic: Optional[MLPHead],
        *,
        actions_dim: Sequence[int],
        is_continuous: bool,
        stochastic_size: int,
        discrete_size: int,
        recurrent_state_size: int,
        actor_cfg: Dict[str, Any],
    ) -> None:
        super().__init__()
        self.world_model = world_model
        self.actor = actor
        self.critic = critic
        self.target_critic = target_critic
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.actor_cfg = dict(actor_cfg)

    @property
    def encoder(self) -> Encoder:
        return self.world_model["encoder"]

    @property
    def device(self) -> torch.device:
        return self.actor.heads[0].weight.device

    @property
    def stoch_state_size(self) -> int:
        return self.stochastic_size * self.discrete_size

    @property
    def latent_state_size(self) -> int:
        return self.stoch_state_size + self.recurrent_state_size

    def draw_state_noise(self, shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        """Noise for ``shape`` rows of stochastic-state samples: Gumbel noise per logit."""
        return draw_gumbel((*shape, self.stoch_state_size), generator, device)

    def _representation(self, h: torch.Tensor, embedded: torch.Tensor, noise: torch.Tensor):
        logits = self.world_model["representation_model"](torch.cat([h, embedded], dim=-1))
        return logits, stochastic_state(logits, self.discrete_size, noise)

    def _prior(self, h: torch.Tensor) -> torch.Tensor:
        return self.world_model["transition_model"](h)

    def _transition(self, h: torch.Tensor, noise: torch.Tensor):
        logits = self._prior(h)
        return logits, stochastic_state(logits, self.discrete_size, noise)

    def _recurrent(self, z: torch.Tensor, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.world_model["recurrent_model"](torch.cat([z, a], dim=-1), h)

    def zero_state(self, n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero recurrent and stochastic states for ``n`` rows."""
        device = self.device if device is None else device
        return (
            torch.zeros((n, self.recurrent_state_size), device=device),
            torch.zeros((n, self.stoch_state_size), device=device),
        )

    @cast_once()
    def dynamic_scan(self, embedded, actions, is_first, noise):
        """Posterior/prior unroll over the sequence from zero states, ``is_first``
        masking the action and both states: a Python loop over T whose
        recurrent step is the LN-GRU kernel on a CUDA tensor. ``noise`` [T, B,
        S*D] is the posterior samples' Gumbel noise. Returns (recurrent
        states, posteriors, posterior logits, prior logits), time-major."""
        T, B = embedded.shape[:2]
        h, z = self.zero_state(B, embedded.device)
        hs, zs, posts, priors = [], [], [], []
        for t in range(T):
            keep = 1 - is_first[t]
            # masked arithmetic gives fresh contiguous rows for the kernel
            a, h, z = keep * actions[t], keep * h, keep * z
            h = self._recurrent(z, a, h)
            priors.append(self._prior(h))
            post, z = self._representation(h, embedded[t], noise[t])
            hs.append(h)
            zs.append(z)
            posts.append(post)
        return torch.stack(hs), torch.stack(zs), torch.stack(posts), torch.stack(priors)

    @cast_once()
    def imagination_scan(self, z0, h0, horizon: int, transition_noise, action_noise, actor: Optional[nn.Module] = None):
        """DV2 imagination from ``z0`` [N, S*D] and ``h0`` [N, H]: per step the
        actor acts on the detached latent, then the recurrent step and the
        prior sample. ``action_noise`` [horizon, N, A], ``transition_noise``
        [horizon, N, S*D]. Returns (latents [horizon+1, N, L], actions
        [horizon+1, N, A]) with a zero first action."""
        actor = self.actor if actor is None else actor
        z, h = z0, h0.contiguous()
        latent = torch.cat([z, h], dim=-1)
        latents, actions = [latent], [torch.zeros_like(action_noise[0])]
        for t in range(horizon):
            a = actor_sample(self, actor(latent.detach()), action_noise[t])
            h = self._recurrent(z, a, h)
            _, z = self._transition(h, transition_noise[t])
            latent = torch.cat([z, h], dim=-1)
            latents.append(latent)
            actions.append(a)
        return torch.stack(latents), torch.stack(actions)


def player_step(agent, obs, action, h, z, repr_noise, action_noise, greedy: bool, actor: Optional[nn.Module] = None):
    """One acting step of a Dreamer-V1/V2 agent over a batch of normalized
    observations: encoder, recurrent step, posterior sample, actor. Returns
    (actions, h, z)."""
    embedded = agent.encoder(obs)
    h = agent._recurrent(z, action, h)
    _, z = agent._representation(h, embedded, repr_noise)
    pre = (agent.actor if actor is None else actor)(torch.cat([z, h], dim=-1))
    return actor_sample(agent, pre, action_noise, greedy=greedy), h, z


class PlayerDV2:
    """The env-interaction wrapper of Dreamer-V1 and V2: each env's previous
    action, recurrent and stochastic state, zeros at a reset. ``get_actions``
    takes its noise as an argument or draws it from ``generator``; with
    ``expl_amount > 0`` the actions get the exploration noise."""

    def __init__(self, agent, num_envs: int, cnn_keys: Sequence[str], mlp_keys: Sequence[str], actor=None):
        self.agent = agent
        self.actor = agent.actor if actor is None else actor
        self.calls = 0  # batched acting steps taken
        self.num_envs = num_envs
        self.cnn_keys = tuple(cnn_keys)
        self.mlp_keys = tuple(mlp_keys)
        self.actions: Optional[torch.Tensor] = None
        self.recurrent_state: Optional[torch.Tensor] = None
        self.stochastic_state: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.agent.device

    @torch.no_grad()
    def init_states(self, reset_envs: Optional[Sequence[int]] = None) -> None:
        if reset_envs is None or len(reset_envs) == 0 or self.actions is None:
            act_dim = int(np.sum(self.agent.actions_dim))
            self.actions = torch.zeros((self.num_envs, act_dim), device=self.device)
            self.recurrent_state, self.stochastic_state = self.agent.zero_state(self.num_envs)
            return
        keep = torch.ones((self.num_envs, 1))
        keep[torch.as_tensor(list(reset_envs), dtype=torch.long)] = 0.0
        keep = keep.to(self.device)
        self.actions = self.actions * keep
        self.recurrent_state = self.recurrent_state * keep
        self.stochastic_state = self.stochastic_state * keep

    @torch.no_grad()
    def get_actions(
        self,
        obs: Dict[str, torch.Tensor],
        noise: Optional[Dict[str, Any]] = None,
        greedy: bool = False,
        generator: Optional[torch.Generator] = None,
        expl_amount: float = 0.0,
    ) -> torch.Tensor:
        n = self.num_envs
        if noise is None:
            noise = {"repr": self.agent.draw_state_noise((n,), generator, self.device)}
            if not greedy:
                noise["act"] = draw_actor_noise(self.agent, (n,), generator, self.device)
            if expl_amount > 0:
                noise["expl"] = draw_exploration_noise(self.agent, n, generator, self.device)
        actions, self.recurrent_state, self.stochastic_state = player_step(
            self.agent, obs, self.actions, self.recurrent_state, self.stochastic_state,
            noise["repr"], None if greedy else noise["act"], greedy, self.actor,
        )
        if expl_amount > 0:
            actions = add_exploration_noise(self.agent, actions, noise["expl"], expl_amount)
        self.calls += 1
        self.actions = actions
        return actions


# ---------------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------------
def build_modules(cfg, obs_space, actions_dim: Sequence[int], is_continuous: bool, *, stoch_state_size: int,
                  posterior_dim: int, gru_layer_norm: bool, layer_norm_of) -> Dict[str, nn.Module]:
    """The Dreamer-V1/V2 modules: the world model's (``use_continues`` adds the
    continue head), the actor and the critic. ``posterior_dim`` is the width
    of the representation and transition heads (the logits of DV2, DV1's
    mean and std), ``layer_norm_of(node)`` a block's LayerNorm setting."""
    wm_cfg = cfg.algo.world_model
    actor_cfg = cfg.algo.actor
    critic_cfg = cfg.algo.critic
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    cnn_dec_keys = tuple(cfg.algo.cnn_keys.decoder)
    mlp_dec_keys = tuple(cfg.algo.mlp_keys.decoder)
    recurrent_state_size = int(wm_cfg.recurrent_model.recurrent_state_size)
    latent = stoch_state_size + recurrent_state_size
    act_dim = int(np.sum(actions_dim))

    cnn_encoder = (
        CNNEncoder(
            cnn_keys,
            sum(int(np.prod(obs_space[k].shape[:-2])) for k in cnn_keys),
            wm_cfg.encoder.cnn_channels_multiplier,
            cfg.algo.cnn_act,
            layer_norm_of(wm_cfg.encoder),
            image_size=int(obs_space[cnn_keys[0]].shape[-1]),
        )
        if cnn_keys
        else None
    )
    mlp_encoder = (
        MLPEncoder(
            mlp_keys,
            sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
            wm_cfg.encoder.mlp_layers,
            wm_cfg.encoder.dense_units,
            cfg.algo.dense_act,
            layer_norm_of(wm_cfg.encoder),
        )
        if mlp_keys
        else None
    )
    encoder = Encoder(cnn_encoder, mlp_encoder)
    cnn_decoder = (
        CNNDecoder(
            cnn_dec_keys,
            [int(np.prod(obs_space[k].shape[:-2])) for k in cnn_dec_keys],
            latent,
            wm_cfg.observation_model.cnn_channels_multiplier,
            cnn_encoder.out_dim if cnn_encoder is not None else 0,
            cfg.algo.cnn_act,
            layer_norm_of(wm_cfg.observation_model),
        )
        if cnn_dec_keys
        else None
    )
    mlp_decoder = (
        MLPDecoder(
            mlp_dec_keys,
            [obs_space[k].shape[0] for k in mlp_dec_keys],
            latent,
            wm_cfg.observation_model.mlp_layers,
            wm_cfg.observation_model.dense_units,
            cfg.algo.dense_act,
            layer_norm_of(wm_cfg.observation_model),
        )
        if mlp_dec_keys
        else None
    )

    def head(node, in_dim, out_dim, n_layers=None, units=None, act=None):
        return MLPHead(in_dim, units if units is not None else node.dense_units,
                       n_layers if n_layers is not None else node.mlp_layers, out_dim,
                       act or cfg.algo.dense_act, layer_norm_of(node))

    world_model = {
        "encoder": encoder,
        "recurrent_model": RecurrentModel(
            stoch_state_size + act_dim, recurrent_state_size, wm_cfg.recurrent_model.dense_units,
            cfg.algo.dense_act, gru_layer_norm,
        ),
        "representation_model": head(wm_cfg.representation_model, recurrent_state_size + encoder.out_dim,
                                     posterior_dim, 1, wm_cfg.representation_model.hidden_size,
                                     wm_cfg.representation_model.dense_act),
        "transition_model": head(wm_cfg.transition_model, recurrent_state_size, posterior_dim, 1,
                                 wm_cfg.transition_model.hidden_size, wm_cfg.transition_model.dense_act),
        "observation_model": Decoder(cnn_decoder, mlp_decoder),
        "reward_model": head(wm_cfg.reward_model, latent, 1),
    }
    if wm_cfg.use_continues:
        world_model["continue_model"] = head(wm_cfg.discount_model, latent, 1)
    return {
        "world_model": nn.ModuleDict(world_model),
        "actor": Actor(latent, actions_dim, is_continuous, actor_cfg.dense_units, actor_cfg.mlp_layers,
                       actor_cfg.dense_act, layer_norm_of(actor_cfg)),
        "critic": head(critic_cfg, latent, 1, act=critic_cfg.dense_act),
    }


def actor_settings(cfg) -> Dict[str, Any]:
    actor_cfg = cfg.algo.actor
    return {
        "init_std": actor_cfg.init_std,
        "min_std": actor_cfg.min_std,
        "expl_amount": actor_cfg.get("expl_amount", 0.0),
        "expl_decay": actor_cfg.get("expl_decay", 0.0),
        "expl_min": actor_cfg.get("expl_min", 0.0),
    }


def init_modules(agent, generator: torch.Generator) -> None:
    """Flax's default initialization of every module, in the JAX build's
    order of modules."""
    for module in agent.world_model.values():
        module.init_weights(generator)
    agent.actor.init_weights(generator)
    agent.critic.init_weights(generator)
    if agent.target_critic is not None:
        agent.target_critic.load_state_dict(agent.critic.state_dict())


def build_agent(fabric, actions_dim, is_continuous: bool, cfg, obs_space, seed: int,
                agent_state: Optional[Dict[str, Any]] = None) -> DV2Agent:
    """The Dreamer-V2 agent on ``fabric.device``: initialized from ``seed``
    through a CPU ``torch.Generator``, or loaded from a Flax-layout numpy tree
    ``agent_state`` (a checkpoint's ``state["agent"]``)."""
    if fabric.compute_dtype != torch.float32:
        raise NotImplementedError("Dreamer-V2 at bf16 is not yet ported to sheeprl_tpu_torch")
    wm_cfg = cfg.algo.world_model
    discrete_size = int(wm_cfg.get("discrete_size", 1))
    stoch_state_size = int(wm_cfg.stochastic_size) * discrete_size
    modules = build_modules(
        cfg, obs_space, actions_dim, is_continuous, stoch_state_size=stoch_state_size,
        posterior_dim=stoch_state_size, gru_layer_norm=bool(wm_cfg.recurrent_model.get("layer_norm", True)),
        layer_norm_of=lambda node: bool(node.get("layer_norm", cfg.algo.layer_norm)),
    )
    agent = DV2Agent(
        modules["world_model"], modules["actor"], modules["critic"], copy.deepcopy(modules["critic"]),
        actions_dim=actions_dim, is_continuous=is_continuous, stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=discrete_size, recurrent_state_size=int(wm_cfg.recurrent_model.recurrent_state_size),
        actor_cfg=actor_settings(cfg),
    )
    if agent_state is not None:
        from sheeprl_tpu_torch.interop.flax_to_torch import load_dv2_params

        load_dv2_params(agent, agent_state)
    else:
        init_modules(agent, torch.Generator().manual_seed(int(seed)))
    return agent.to(fabric.device)
