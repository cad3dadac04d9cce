"""Fused LayerNorm-GRU step: the RSSM's recurrent cell, as a Hopper kernel.

Port of ``sheeprl_tpu/ops/gru.py``. One step is

    gates = LN(concat(x, h) @ W + b)         # [B, 3H], LN over all 3H
    r, c, u = split(gates)
    h' = sigmoid(u - 1) * tanh(sigmoid(r) * c) + (1 - sigmoid(u - 1)) * h

This module holds four things:

- :func:`ln_gru_step_plain` — the plain PyTorch math, with the JAX op's dtype
  policy (operands in their storage dtype, products accumulated in float32).
  The CPU path and the kernel's oracle.
- the CUDA kernel ``csrc/ln_gru.cu`` (built by ``ops/_build.py``), launched by
  :func:`_launch`, the only place that bumps ``LN_GRU.launches``.
- :class:`_LnGruStep`, the ``torch.autograd.Function`` counterpart of the JAX
  custom VJP: the forward is the kernel, the backward recomputes through the
  plain math (as ``_fused_bwd`` does through ``ln_gru_step_reference``).
- :func:`ln_gru_step`, the dispatch: a CPU tensor takes the plain math, a CUDA
  tensor takes the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sheeprl_tpu_torch.ops._build import KernelSpec, load

LN_GRU = KernelSpec(
    name="ln_gru_step",
    source="ln_gru.cu",
    replaces="sheeprl_tpu/ops/gru.py:77",
)

# blocks the split-K GEMM aims to keep in flight: two per SM of an H100
_TARGET_BLOCKS = 264


def ln_gru_step_plain(
    inp: torch.Tensor,
    hx: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """The plain math of one step. ``inp`` [..., K] (already ``concat(x, h)``),
    ``hx`` [..., H], ``w`` [K, 3H], ``b``/``scale``/``bias`` [3H]. Returns the
    new hidden state in ``hx``'s dtype."""
    # float32 operands hold bf16 values exactly, so this is the reference's
    # native-dtype product with float32 accumulation
    gates = torch.matmul(inp.float(), w.float()) + b.float()
    mean = gates.mean(dim=-1, keepdim=True)
    centered = gates - mean
    var = centered.square().mean(dim=-1, keepdim=True)
    normed = centered * torch.rsqrt(var + eps)
    normed = normed * scale.float() + bias.float()
    hidden = hx.float()
    H = hidden.shape[-1]
    reset = torch.sigmoid(normed[..., :H])
    cand = torch.tanh(reset * normed[..., H : 2 * H])
    update = torch.sigmoid(normed[..., 2 * H :] - 1.0)
    return (update * cand + (1.0 - update) * hidden).to(hx.dtype)


def _split_k(B: int, K: int, N: int, tile_b: int, tile_n: int, tile_k: int) -> Tuple[int, int]:
    """(splits, k_per_split): enough K chunks to keep ~_TARGET_BLOCKS blocks in
    flight, each chunk a multiple of the kernel's K tile."""
    tiles = -(-N // tile_n) * -(-B // tile_b)
    k_tiles = -(-K // tile_k)
    splits = max(1, min(k_tiles, -(-_TARGET_BLOCKS // tiles)))
    k_per_split = -(-k_tiles // splits) * tile_k
    return -(-K // k_per_split), k_per_split


def _check_operands(inp, hx, w, b, scale, bias) -> None:
    tensors = {"inp": inp, "hx": hx, "w": w, "b": b, "scale": scale, "bias": bias}
    device = inp.device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"ln_gru_step: {name} is on {t.device}, inp on {device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"ln_gru_step: the CUDA kernel takes float32 only, {name} is {t.dtype} "
                "(bf16 operands are not yet ported)"
            )
        if not t.is_contiguous():
            raise ValueError(f"ln_gru_step: {name} must be contiguous")
    B, K = inp.shape
    H = hx.shape[-1]
    if hx.shape != (B, H) or w.shape != (K, 3 * H):
        raise ValueError(
            f"ln_gru_step: shapes inp {tuple(inp.shape)}, hx {tuple(hx.shape)}, w "
            f"{tuple(w.shape)} do not fit inp [B,K], hx [B,H], w [K,3H]"
        )
    for name, t in (("b", b), ("scale", scale), ("bias", bias)):
        if t.shape != (3 * H,):
            raise ValueError(f"ln_gru_step: {name} has shape {tuple(t.shape)}, expected ({3 * H},)")
    if B < 1:
        raise ValueError("ln_gru_step: empty batch")


def _kernel() -> Tuple[ctypes.CDLL, Tuple[int, int, int]]:
    """The built library with its entry point typed, and its (B, N, K) tiles."""
    lib = load(LN_GRU)
    fn = lib.ln_gru_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, (lib.ln_gru_tile_b(), lib.ln_gru_tile_n(), lib.ln_gru_tile_k())


def _launch(inp, hx, w, b, scale, bias, eps: float) -> torch.Tensor:
    """Run the CUDA kernel on [B,K] / [B,H] float32 CUDA tensors."""
    _check_operands(inp, hx, w, b, scale, bias)
    lib, (tile_b, tile_n, tile_k) = _kernel()
    B, K = inp.shape
    H = hx.shape[-1]
    N = 3 * H
    splits, k_per_split = _split_k(B, K, N, tile_b, tile_n, tile_k)
    partial = torch.empty((splits, B, N), dtype=torch.float32, device=inp.device)
    out = torch.empty((B, H), dtype=torch.float32, device=inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    err = lib.ln_gru_forward(
        inp.data_ptr(), hx.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, K, H, splits, k_per_split, float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"ln_gru_forward launch failed with cudaError {err}")
    LN_GRU.launches += 1
    return out


class _LnGruStep(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain math, as the JAX
    custom VJP's backward differentiates its XLA reference."""

    @staticmethod
    def forward(ctx, inp, hx, w, b, scale, bias, eps):
        ctx.save_for_backward(inp, hx, w, b, scale, bias)
        ctx.eps = eps
        return _launch(inp, hx, w, b, scale, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ln_gru_step_plain(*saved, eps=ctx.eps)
            grads = torch.autograd.grad(out, saved, grad_out)
        return (*grads, None)


def ln_gru_step(
    inp: torch.Tensor,
    hx: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-3,
) -> torch.Tensor:
    """One LayerNorm-GRU step over any leading batch shape (differentiable).

    On CPU tensors this is :func:`ln_gru_step_plain`; on CUDA tensors it is the
    hand-written kernel, and an operand the kernel does not take raises."""
    if inp.device.type == "cpu":
        return ln_gru_step_plain(inp, hx, w, b, scale, bias, eps)
    if inp.device.type != "cuda":
        raise ValueError(f"ln_gru_step: no kernel for device {inp.device}")
    lead = hx.shape[:-1]
    out = _LnGruStep.apply(
        inp.reshape(-1, inp.shape[-1]), hx.reshape(-1, hx.shape[-1]), w, b, scale, bias, float(eps)
    )
    return out.reshape(*lead, hx.shape[-1])
