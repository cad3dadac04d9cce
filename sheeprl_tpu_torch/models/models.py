"""Model building blocks shared across algorithms (port of the parts of
``sheeprl_tpu/models/models.py`` the Dreamer-V3 serving path uses)."""

from __future__ import annotations

from typing import Callable, Dict, Union

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
