"""The port's LayerNorm-GRU op (sheeprl_tpu_torch/ops/gru.py) against the JAX op.

The plain PyTorch math is held against ``ln_gru_step_reference`` and against
the Pallas kernel run in interpret mode, at the shapes of
tests/test_ops/test_gru_kernel.py plus the Dreamer-V3 S cell (B=4, K=1024,
H=512). Both sides are float32 on the CPU; XLA and PyTorch sum the K products
in different orders, so outputs agree to float32 rounding: 1e-5, the tolerance
the JAX kernel's own parity tests use. The CUDA kernel itself runs only on a
card (tests/test_torch_cuda.py; ``python3 chip_smoke.py`` holds it at S, L
and XL).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.gru import fused_ln_gru_step, ln_gru_step_reference
from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain
from sheeprl_tpu_torch.ops.gru import _ROW_TILES, _launch_plan

ATOL = 1e-5

SHAPES = [(4, 6, 8), (16, 32, 64), (33, 8, 16), (300, 16, 32), (4, 512, 512)]


def _case(B: int, X: int, H: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    K = X + H
    return (
        rng.standard_normal((B, K)).astype(np.float32),
        rng.standard_normal((B, H)).astype(np.float32),
        (rng.standard_normal((K, 3 * H)) * 0.3 / np.sqrt(max(K / 16, 1))).astype(np.float32),
        (0.1 * rng.standard_normal(3 * H)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(3 * H)).astype(np.float32),
        (0.1 * rng.standard_normal(3 * H)).astype(np.float32),
    )


def _torch(args):
    return [torch.from_numpy(a.copy()) for a in args]


@pytest.mark.parametrize("B,X,H", SHAPES)
def test_plain_matches_jax_reference(B, X, H):
    args = _case(B, X, H)
    ref = np.asarray(ln_gru_step_reference(*[jnp.asarray(a) for a in args]))
    out = ln_gru_step_plain(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("B,X,H", SHAPES)
def test_plain_matches_pallas_kernel_interpreted(B, X, H):
    args = _case(B, X, H, seed=1)
    block_b = 128 if B > 128 else 256
    ref = np.asarray(fused_ln_gru_step(*[jnp.asarray(a) for a in args], block_b=block_b, interpret=True))
    out = ln_gru_step_plain(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("B,X,H", [(8, 6, 16), (4, 512, 512)])
def test_plain_gradients_match_jax_vjp(B, X, H):
    args = _case(B, X, H, seed=2)
    cot = np.random.default_rng(3).standard_normal((B, H)).astype(np.float32)
    _, vjp = jax.vjp(ln_gru_step_reference, *[jnp.asarray(a) for a in args])
    ref_grads = vjp(jnp.asarray(cot))
    targs = [t.requires_grad_(True) for t in _torch(args)]
    grads = torch.autograd.grad(ln_gru_step_plain(*targs), targs, torch.from_numpy(cot))
    for name, g, r in zip(("inp", "hx", "w", "b", "scale", "bias"), grads, ref_grads):
        # gradients sum B rows (and K for the weight), so their scale grows with
        # the batch; hold them relative to that scale
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(r).max()), err_msg=name)


def test_plain_keeps_the_bf16_dtype_policy():
    """bf16 operands, float32 accumulation, output in hx's dtype — as the JAX op."""
    args = _case(4, 16, 32, seed=4)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref = np.asarray(ln_gru_step_reference(*jargs).astype(jnp.float32))
    out = ln_gru_step_plain(*[t.to(torch.bfloat16) for t in _torch(args)])
    assert out.dtype == torch.bfloat16
    # both round the float32 result to bf16 once (8 bits of mantissa)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2**-7, atol=2**-7)


def test_dispatch_takes_the_plain_math_on_cpu():
    args = _torch(_case(5, 7, 12, seed=5))
    before = LN_GRU.launches
    out = ln_gru_step(*args)
    assert LN_GRU.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, ln_gru_step_plain(*args))
    # leading batch dims pass through
    lead = [args[0].reshape(5, 1, -1), args[1].reshape(5, 1, -1), *args[2:]]
    assert torch.equal(ln_gru_step(*lead).reshape(5, -1), out)


def test_dispatch_refuses_other_devices():
    args = [t.to("meta") for t in _torch(_case(2, 3, 4))]
    with pytest.raises(ValueError, match="no kernel for device"):
        ln_gru_step(*args)


# the kernel's plan constants (csrc/ln_gru.cu: kColGroup, kStageK, kMaxCluster),
# and an H100's SM count
COL_GROUP, STAGE_K, MAX_CLUSTER, SMS = 32, 32, 8, 132


def _check_plan(B, K, H):
    plan = _launch_plan(B, K, H, COL_GROUP, STAGE_K, MAX_CLUSTER, SMS)
    # a portable cluster size the kernel is built for
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    # K chunks: whole stages, none empty, together covering K
    assert plan.k_chunk > 0 and plan.k_chunk % STAGE_K == 0
    assert plan.cluster * plan.k_chunk >= K
    assert (plan.cluster - 1) * plan.k_chunk < K
    # column groups cover each third of 3H, none empty
    assert plan.groups * COL_GROUP >= H
    assert (plan.groups - 1) * COL_GROUP < H
    # a row tile the kernel is built for; K is split only while the grid
    # fits one block on each SM
    assert plan.tile_b in _ROW_TILES
    assert plan.cluster == 1 or plan.groups * plan.cluster * -(-B // plan.tile_b) <= SMS
    return plan


@pytest.mark.parametrize(
    "B,K,H",
    [(1, 512, 256), (4, 1024, 512), (64, 1024, 512), (4, 1664, 1024), (4, 2816, 2048), (16, 5120, 4096), (33, 14, 8)]
    # ragged row tiles, odd H (the kernel's 4-byte path), K that ends inside a
    # stage, and the smallest call
    + [(300, 1024, 512), (1024, 1024, 512), (3, 40, 24), (2, 35, 25), (5, 161, 33), (1, 1, 1)],
)
def test_split_k_covers_k_in_whole_tiles(B, K, H):
    """The launch plan of the CUDA wrapper: the cluster that splits K is a legal
    size, its K chunks are whole stages, none is empty, together they cover K,
    and the column groups cover each third of 3H."""
    _check_plan(B, K, H)


@pytest.mark.parametrize(
    "B,K,H,plan",
    [
        # DV3 S at 4 slots: one row tile and a full cluster of 8 along K, so
        # 128 blocks each stream a contiguous run of 128 K rows
        (4, 1024, 512, (4, 16, 8, 128)),
        (16, 1024, 512, (16, 16, 8, 128)),
        (4, 2816, 2048, (4, 64, 2, 1408)),  # L
        (4, 5120, 4096, (4, 128, 1, 5120)),  # XL: one block a column group
        (1024, 1024, 512, (16, 16, 1, 1024)),  # the imagination batch
    ],
)
def test_launch_plan_at_the_dreamer_shapes(B, K, H, plan):
    got = _check_plan(B, K, H)
    assert (got.tile_b, got.groups, got.cluster, got.k_chunk) == plan
