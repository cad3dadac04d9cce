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
  :func:`_launch`, the only place that counts ``LN_GRU``'s launches. It has two
  instances: every operand float32, or ``inp``, ``hx``, ``w`` and ``b`` bf16
  with ``scale`` and ``bias`` float32 (the JAX cell's mix under a bf16
  policy), the output in ``hx``'s dtype. Any other mix raises: a bf16 operand
  is never widened to reach the float32 instance.
- :class:`_LnGruStep`, the ``torch.autograd.Function`` counterpart of the JAX
  custom VJP: the forward is the kernel, the backward recomputes through the
  plain math (as ``_fused_bwd`` does through ``ln_gru_step_reference``).
- :func:`ln_gru_step`, the dispatch: a CPU tensor takes the plain math, a CUDA
  tensor takes the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from sheeprl_tpu_torch.ops._build import KernelSpec, load

LN_GRU = KernelSpec(
    name="ln_gru_step",
    source="ln_gru.cu",
    replaces="sheeprl_tpu/ops/gru.py:77",
)

# batch rows of a block's tile: the kernel is built for these two
_ROW_TILES = (4, 16)


@dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/ln_gru.cu`` cuts one call: ``tile_b`` batch rows a block,
    ``groups`` column groups (``col_group`` columns of each third of 3H), and a
    cluster of ``cluster`` blocks along K per (group, row tile), each block
    taking ``k_chunk`` rows of K."""

    tile_b: int
    groups: int
    cluster: int
    k_chunk: int


def _launch_plan(
    B: int, K: int, H: int, col_group: int, stage_k: int, max_cluster: int, sms: int
) -> LaunchPlan:
    """The cluster along K grows (by powers of two, up to ``max_cluster``)
    while the grid still fits one block on each of the card's ``sms`` SMs and
    K has a whole stage for each block: on an H100, one block an SM, each
    streaming the longest run of K, pulls W fastest (PERF.md). Each K chunk is
    a whole number of ``stage_k`` rows and none is empty."""
    tile_b = _ROW_TILES[0] if B <= _ROW_TILES[0] else _ROW_TILES[1]
    groups = -(-H // col_group)
    tiles = groups * -(-B // tile_b)
    k_stages = -(-K // stage_k)
    cluster = 1
    while 2 * cluster <= min(max_cluster, k_stages) and 2 * cluster * tiles <= sms:
        cluster *= 2
    while True:
        k_chunk = -(-k_stages // cluster) * stage_k
        if cluster == 1 or (cluster - 1) * k_chunk < K:
            return LaunchPlan(tile_b, groups, cluster, k_chunk)
        cluster //= 2


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


# the operand mixes the kernel takes: (inp, hx, w, b) dtype -> its C entry point;
# scale and bias are float32 in both, as the JAX cell keeps its LayerNorm
# parameters
_ENTRY_POINTS = {torch.float32: "ln_gru_forward", torch.bfloat16: "ln_gru_forward_bf16"}


def _check_operands(inp, hx, w, b, scale, bias) -> None:
    tensors = {"inp": inp, "hx": hx, "w": w, "b": b, "scale": scale, "bias": bias}
    device = inp.device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"ln_gru_step: {name} is on {t.device}, inp on {device}")
        if not t.is_contiguous():
            raise ValueError(f"ln_gru_step: {name} must be contiguous")
    dtypes = {name: t.dtype for name, t in tensors.items()}
    compute = inp.dtype
    if (
        compute not in _ENTRY_POINTS
        or any(dtypes[n] != compute for n in ("hx", "w", "b"))
        or dtypes["scale"] != torch.float32
        or dtypes["bias"] != torch.float32
    ):
        got = ", ".join(f"{n} {str(d).replace('torch.', '')}" for n, d in dtypes.items())
        raise NotImplementedError(
            "ln_gru_step: the CUDA kernel takes inp, hx, w and b all float32 or all bfloat16, "
            f"with scale and bias float32; got {got}"
        )
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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel(dtype: torch.dtype) -> Tuple[Callable, Tuple[int, int, int]]:
    """The entry point of ``dtype``'s instance in the built library, typed,
    and the plan constants (col_group, stage_k, max_cluster)."""
    lib = load(LN_GRU)
    fn = getattr(lib, _ENTRY_POINTS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn, (lib.ln_gru_col_group(), lib.ln_gru_stage_k(), lib.ln_gru_max_cluster())


def _launch(inp, hx, w, b, scale, bias, eps: float) -> torch.Tensor:
    """Run the CUDA kernel on [B,K] / [B,H] CUDA tensors: float32, or bf16
    with float32 ``scale`` and ``bias``. The output has ``hx``'s dtype."""
    _check_operands(inp, hx, w, b, scale, bias)
    fn, consts = _kernel(inp.dtype)
    B, K = inp.shape
    H = hx.shape[-1]
    # the plan counts K rows and columns, not bytes: one plan serves both
    # instances (the 16-byte copy rules for 2-byte elements are the kernel's)
    plan = _launch_plan(B, K, H, *consts, _sm_count(inp.device))
    # the gates [B,3H] between the two launches, then the LayerNorm partials
    # [B, groups, 2], float32 in both instances
    scratch = torch.empty(B * (3 * H + 2 * plan.groups), dtype=torch.float32, device=inp.device)
    out = torch.empty((B, H), dtype=hx.dtype, device=inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    err = fn(
        inp.data_ptr(), hx.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, K, H, plan.tile_b, plan.cluster, plan.k_chunk, float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"{_ENTRY_POINTS[inp.dtype]} launch failed with cudaError {err}")
    LN_GRU.count_launch(str(inp.dtype).replace("torch.", ""))
    return out


class _LnGruStep(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain math, as the JAX
    custom VJP's backward differentiates its XLA reference (which keeps the
    bf16 dtype policy: bf16 operands get bf16 gradients)."""

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
