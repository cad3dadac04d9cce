"""Model building blocks shared across algorithms (port of the parts of
``sheeprl_tpu/models/models.py`` the port's algorithms use: ``MLP``,
``NatureCNN`` and the LayerNorm-GRU cell), and :class:`EnsembleMLP`, the
``MLP`` under Flax's ``nn.vmap`` with stacked parameters.

``MLP`` and ``NatureCNN`` keep the Flax modules' child names (``Dense_i``,
``LayerNorm_i``, ``CNN_0/Conv_i``) for ``interop/flax_to_torch.py`` and are
initialised as Flax initialises them (:func:`lecun_init_`), from a
``torch.Generator``.

Under a bf16 compute dtype (``Fabric.compute_dtype``) parameters stay
float32 and are cast where they are used, as Flax casts them: :func:`dense`,
:func:`layer_norm` and :func:`conv` compute what ``nn.Dense``, ``nn.LayerNorm``
and ``nn.Conv`` compute with ``dtype=bf16``, rounding where Flax rounds. Inside
:func:`cast_once` (the RSSM scans) each parameter is cast once for the whole
block instead of once per step; its gradient still reaches the float32
parameter, accumulated in float32 over the steps as the JAX scan accumulates
it. In float32 every helper is the plain torch module call.

``EnsembleMLP``'s dropout takes its keep-masks as an argument (one boolean
tensor per hidden layer, shaped like that layer's output), as every sampler
of the port takes its noise: kept units are scaled by ``1 / (1 - rate)``,
dropped ones are 0, as ``flax.linen.Dropout`` computes them. Without masks
the layers are deterministic (Flax's ``deterministic=True``).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.gru import ln_gru_step
from sheeprl_tpu_torch.utils.distribution import sigmoid


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)``: in float32 torch's fused op;
    otherwise the JAX composition, rounded after each op."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,
    "leakyrelu": F.leaky_relu,
    "elu": F.elu,
    "gelu": F.gelu,
    "silu": _silu,
    "swish": _silu,
    "sigmoid": sigmoid,
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def resolve_activation(act: Union[None, str, Callable]) -> Callable:
    """Accept plain names ("tanh"), torch-style names ("torch.nn.Tanh") and
    callables, as the JAX package does. SiLU (Dreamer-V3's activation) and
    the sigmoid compose JAX's ops in bf16; the others are torch's ops in every
    dtype."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    name = str(act).split(".")[-1].lower()
    if name in _ACTIVATIONS:
        return _ACTIVATIONS[name]
    raise ValueError(f"unknown activation {act!r}")


# ---------------------------------------------------------------------------------
# the compute dtype: parameters cast where they are used (Flax's dtype=)
# ---------------------------------------------------------------------------------
class _CastCache(threading.local):
    cache: Optional[Dict[int, tuple]] = None


_CAST = _CastCache()


class _CastUse(torch.autograd.Function):
    """One use of a parameter's cached cast: the forward hands out the cast
    value (a view, no kernel); the backward returns this use's gradient in the
    parameter's dtype, so autograd sums the uses in float32."""

    @staticmethod
    def forward(ctx, param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        ctx.dtype = param.dtype
        return value.view_as(value)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.dtype), None


@contextmanager
def cast_once() -> Iterator[None]:
    """Inside the block (or the call of a function it decorates), :func:`cast`
    converts each tensor once; its uses share that value. The RSSM scans run
    inside one, so a gradient step casts the recurrent kernel once per scan,
    not once per step."""
    outer = _CAST.cache
    _CAST.cache = {} if outer is None else outer
    try:
        yield
    finally:
        _CAST.cache = outer


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` (``t`` itself when it already is), differentiable."""
    if t.dtype == dtype:
        return t
    cache = _CAST.cache
    if cache is None:
        return t.to(dtype)
    hit = cache.get(id(t))
    if hit is None or hit[0] is not t:
        hit = (t, t.detach().to(dtype))
        cache[id(t)] = hit
    if torch.is_grad_enabled() and t.requires_grad:
        return _CastUse.apply(t, hit[1])
    return hit[1]


def dense(linear: nn.Linear, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``flax.linen.Dense(dtype=dtype)`` with ``linear``'s parameters. In
    float32 one fused ``F.linear``; in bf16 the product of bf16 operands
    (float32 sums, rounded once), then the bf16 bias added and rounded again,
    the two steps Flax takes."""
    if dtype == torch.float32:
        return linear(x)
    y = F.linear(x.to(dtype), cast(linear.weight, dtype))
    return y if linear.bias is None else y + cast(linear.bias, dtype)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``flax.linen.LayerNorm(dtype=dtype)`` with ``norm``'s parameters: Flax
    takes the statistics and the affine map in float32 whatever the input, and
    rounds the output to ``dtype`` once."""
    if dtype == torch.float32:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def conv(module: Union[nn.Conv2d, nn.ConvTranspose2d], x: torch.Tensor, dtype: torch.dtype = torch.float32):
    """A Flax convolution (or transposed convolution) of ``dtype`` with the
    torch module's parameters: in bf16 the convolution of bf16 operands, then
    the bf16 bias added, as :func:`dense`."""
    if dtype == torch.float32:
        return module(x)
    fn = F.conv_transpose2d if isinstance(module, nn.ConvTranspose2d) else F.conv2d
    y = fn(x.to(dtype), cast(module.weight, dtype), None, module.stride, module.padding)
    return y if module.bias is None else y + cast(module.bias, dtype).reshape(-1, 1, 1)


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def lecun_init_(module: Union[nn.Linear, nn.Conv2d], generator: torch.Generator) -> None:
    """Flax's default for ``Dense`` and ``Conv``: a kernel from
    ``variance_scaling(1.0, "fan_in", "truncated_normal")``, a zero bias."""
    fan_in = module.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    if module.bias is not None:
        module.bias.zero_()


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``flax.linen.Dropout`` with its mask given: ``x / (1 - rate)`` where
    ``keep``, else 0; ``x`` itself without a mask or at rate 0."""
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MLP(nn.Module):
    """Per layer ``Dense -> LayerNorm? -> activation``, then an optional output
    ``Dense`` without activation (the JAX ``MLP``; DroQ's dropout is in
    :class:`EnsembleMLP`)."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        output_dim: Optional[int] = None,
        activation: Union[None, str, Callable] = "relu",
        layer_norm: bool = False,
    ) -> None:
        super().__init__()
        self.act = resolve_activation(activation)
        sizes = [input_dim, *hidden_sizes] + ([output_dim] if output_dim is not None else [])
        self.linears = nn.ModuleList(nn.Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:]))
        self.norms = nn.ModuleList(nn.LayerNorm(h, eps=1e-5) for h in hidden_sizes) if layer_norm else nn.ModuleList()
        self.n_hidden = len(hidden_sizes)
        self.out_dim = sizes[-1]

    def init_weights(self, generator: torch.Generator) -> None:
        for linear in self.linears:
            lecun_init_(linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, linear in enumerate(self.linears):
            x = linear(x)
            if i < self.n_hidden:
                if len(self.norms):
                    x = self.norms[i](x)
                x = self.act(x)
        return x


class EnsembleMLP(nn.Module):
    """``n`` MLPs of one layout on a shared input, their parameters stacked
    over a leading member axis: per layer ``kernel [n, in, out]`` and ``bias
    [n, out]`` (LayerNorm ``scale``/``bias`` ``[n, h]``), Flax's layout for
    ``nn.vmap(MLP, variable_axes={"params": 0})``, so a checkpoint's leaves
    load as they are. Each layer is one batched product over the members.
    ``forward`` maps ``[..., in]`` to ``[n, ..., out]``; dropout keep-masks are
    ``[n, rows, h]`` per hidden layer, ``rows`` the flattened leading dims."""

    def __init__(
        self,
        n: int,
        input_dim: int,
        hidden_sizes: Sequence[int],
        output_dim: int,
        activation: Union[None, str, Callable] = "relu",
        layer_norm: bool = False,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.n = int(n)
        self.act = resolve_activation(activation)
        sizes = [input_dim, *hidden_sizes, output_dim]
        self.kernels = nn.ParameterList(nn.Parameter(torch.empty(n, i, o)) for i, o in zip(sizes[:-1], sizes[1:]))
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros(n, o)) for o in sizes[1:])
        self.layer_norm = bool(layer_norm)
        if self.layer_norm:
            self.ln_scales = nn.ParameterList(nn.Parameter(torch.ones(n, h)) for h in hidden_sizes)
            self.ln_biases = nn.ParameterList(nn.Parameter(torch.zeros(n, h)) for h in hidden_sizes)
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.dropout = float(dropout)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's ``Dense`` init for every member (fan-in ``in``), zero biases."""
        for kernel, bias in zip(self.kernels, self.biases):
            std = math.sqrt(1.0 / kernel.shape[1]) / _TRUNC_NORMAL_STD
            nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            bias.zero_()

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(1, -1, x.shape[-1]).expand(self.n, -1, -1)
        for i, (kernel, bias) in enumerate(zip(self.kernels, self.biases)):
            h = torch.baddbmm(bias.unsqueeze(1), h, kernel)
            if i < len(self.hidden_sizes):
                h = dropout(h, None if keep is None else keep[i], self.dropout)
                if self.layer_norm:
                    scale, shift = self.ln_scales[i].unsqueeze(1), self.ln_biases[i].unsqueeze(1)
                    h = F.layer_norm(h, (h.shape[-1],), eps=1e-5) * scale + shift
                h = self.act(h)
        return h.reshape(self.n, *lead, h.shape[-1])


class NatureCNN(nn.Module):
    """The DQN encoder: 32/64/64 valid convolutions (8/4/3, strides 4/2/1) with
    ReLU, a flatten in channel-last order (as the Flax module flattens its NHWC
    maps, so its Dense kernel loads unchanged) and a ReLU Dense. Takes
    channel-first frames."""

    def __init__(self, in_channels: int, features_dim: int, screen_size: int = 64) -> None:
        super().__init__()
        self.convs = nn.ModuleList(
            [
                nn.Conv2d(in_channels, 32, 8, stride=4),
                nn.Conv2d(32, 64, 4, stride=2),
                nn.Conv2d(64, 64, 3, stride=1),
            ]
        )
        side = screen_size
        for conv in self.convs:
            side = (side - conv.kernel_size[0]) // conv.stride[0] + 1
        self.linear = nn.Linear(64 * side * side, features_dim)
        self.out_dim = features_dim

    def init_weights(self, generator: torch.Generator) -> None:
        for m in [*self.convs, self.linear]:
            lecun_init_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        return F.relu(self.linear(x))


class LayerNormGRUCell(nn.Module):
    """GRU cell with a LayerNorm over the stacked 3H projection, stepped through
    the fused op (``ops/gru.py``). Parameters keep the Flax cell's names and
    layout: ``kernel`` [input+hidden, 3H] with rows ordered ``concat(x, h)`` and
    columns (reset, candidate, update); ``bias``, ``ln_scale``, ``ln_bias`` [3H].

    ``layer_norm=False`` (Dreamer-V1's cell) has no LayerNorm parameters and
    computes ``concat(x, h) @ kernel + bias`` and the gating in plain PyTorch,
    as the JAX cell computes that form outside its Pallas kernel.

    ``dtype`` is the compute dtype, with the JAX cell's mix: ``concat(x, h)``,
    ``h``, the kernel and the bias in ``dtype`` (the kernel and the bias cast
    from their float32 parameters), the LayerNorm's scale and shift float32,
    the new state in ``dtype``."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        bias: bool = True,
        layer_norm_eps: float = 1e-3,
        dtype: torch.dtype = torch.float32,
        layer_norm: bool = True,
    ) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype
        n = 3 * hidden_size
        self.kernel = nn.Parameter(torch.empty(input_size + hidden_size, n))
        if bias:
            self.bias = nn.Parameter(torch.zeros(n))
        else:
            self.register_buffer("bias", torch.zeros(n), persistent=False)
        self.has_bias = bias
        self.layer_norm = layer_norm
        if layer_norm:
            self.ln_scale = nn.Parameter(torch.ones(n))
            self.ln_bias = nn.Parameter(torch.zeros(n))

    def forward(self, hx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        inp = torch.cat([x, hx], dim=-1).to(dtype)
        w, b = cast(self.kernel, dtype), cast(self.bias, dtype)
        if not self.layer_norm:
            reset, cand, update = torch.chunk(torch.matmul(inp, w) + b, 3, dim=-1)
            cand = torch.tanh(sigmoid(reset) * cand)
            update = sigmoid(update - 1)
            return update * cand + (1 - update) * hx
        return ln_gru_step(inp, hx.to(dtype), w, b, self.ln_scale, self.ln_bias, self.layer_norm_eps)
