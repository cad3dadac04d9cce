"""Model building blocks shared across algorithms (port of the parts of
``sheeprl_tpu/models/models.py`` the port's algorithms use: ``MLP``,
``NatureCNN`` and the LayerNorm-GRU cell).

``MLP`` and ``NatureCNN`` keep the Flax modules' child names (``Dense_i``,
``LayerNorm_i``, ``CNN_0/Conv_i``) for ``interop/flax_to_torch.py`` and are
initialised as Flax initialises them (:func:`lecun_init_`), from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.gru import ln_gru_step

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,
    "leakyrelu": F.leaky_relu,
    "elu": F.elu,
    "gelu": F.gelu,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def resolve_activation(act: Union[None, str, Callable]) -> Callable:
    """Accept plain names ("tanh"), torch-style names ("torch.nn.Tanh") and
    callables, as the JAX package does."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    name = str(act).split(".")[-1].lower()
    if name in _ACTIVATIONS:
        return _ACTIVATIONS[name]
    raise ValueError(f"unknown activation {act!r}")


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


class MLP(nn.Module):
    """Per layer ``Dense -> LayerNorm? -> activation``, then an optional output
    ``Dense`` without activation (the JAX ``MLP``; its dropout is not used by
    the port's algorithms)."""

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
    (The Flax cell's ``layer_norm=False`` form has no user in the port.)"""

    def __init__(
        self, input_size: int, hidden_size: int, bias: bool = True, layer_norm_eps: float = 1e-3
    ) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.layer_norm_eps = layer_norm_eps
        n = 3 * hidden_size
        self.kernel = nn.Parameter(torch.empty(input_size + hidden_size, n))
        if bias:
            self.bias = nn.Parameter(torch.zeros(n))
        else:
            self.register_buffer("bias", torch.zeros(n), persistent=False)
        self.has_bias = bias
        self.ln_scale = nn.Parameter(torch.ones(n))
        self.ln_bias = nn.Parameter(torch.zeros(n))

    def forward(self, hx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        inp = torch.cat([x, hx], dim=-1)
        return ln_gru_step(inp, hx, self.kernel, self.bias, self.ln_scale, self.ln_bias, self.layer_norm_eps)
