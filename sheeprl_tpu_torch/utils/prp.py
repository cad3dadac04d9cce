"""The Feistel pseudorandom permutation over index ranges (port of
``sheeprl_tpu/utils/prp.py``): O(n) elementwise integer ops, no sort.

The JAX function mixes in uint32. Torch has no uint32 arithmetic on every
device, so the port computes in int64 and masks to 32 bits after each
multiply; each product is split into 16-bit halves so that no intermediate
passes 2^49. The 8 round keys are an argument (the JAX function draws them
as ``jax.random.randint(key, (8,), 0, int32 max)``), so the same keys give
the same permutation, index for index.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["draw_round_keys", "prp_map", "prp_permutation"]

_MASK32 = 0xFFFFFFFF
ROUNDS = 8


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit splitmix-style finalizer: the Feistel round function."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def draw_round_keys(count: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``[count, 8]`` round keys, each uniform in [0, int32 max) as the JAX
    function draws them."""
    return torch.randint(0, 2**31 - 1, (count, ROUNDS), generator=generator, device=device)


def prp_map(n: int, indices: torch.Tensor, round_keys: torch.Tensor) -> torch.Tensor:
    """``prp_permutation(n, round_keys)[indices]`` for int64 ``indices`` in
    ``[0, n)``, computed for those indices alone: the network maps each index
    on its own, so a draw of fewer than ``n`` entries costs only its own."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"prp_permutation needs a power-of-two size >= 2, got {n}")
    bits = int(n).bit_length() - 1
    half_b = bits // 2
    left, right = indices >> half_b, indices & ((1 << half_b) - 1)
    width_l, width_r = bits - half_b, half_b
    keys = round_keys.to(torch.int64)
    for i in range(keys.shape[0]):
        f = _mix32(right ^ keys[i])
        left, right, width_l, width_r = right, left ^ (f & ((1 << width_l) - 1)), width_r, width_l
    return (left << width_r) | right


def prp_permutation(n: int, round_keys: torch.Tensor) -> torch.Tensor:
    """A pseudorandom permutation of ``[0, n)`` for a power-of-two ``n`` >= 2,
    on ``round_keys``' device: an unbalanced Feistel network over the index
    bits, one round per key (a bijection by construction)."""
    return prp_map(n, torch.arange(n, dtype=torch.int64, device=round_keys.device), round_keys)
