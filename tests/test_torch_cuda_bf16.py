"""Card-only tests of the LN-GRU kernel's bf16 instance (marker ``cuda``; they
skip without a card). No jax import: from the repo root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_bf16.py -q

The bf16 instance takes bf16 ``inp``, ``hx``, ``w`` and ``b`` with float32
``scale`` and ``bias``, sums the products in float32 and rounds its output
to bf16 once. The plain version on the card computes the same float32 value
from the same bf16 operands (cuBLAS, TF32 and reduced-precision reductions
off) and rounds it once too; the two sums run in other orders, so an output
may land on the neighbouring bf16 value: the bar is one bf16 rounding,
``rtol = atol = 2**-7``, the bar of ``tests/test_torch_gru.py``'s bf16 test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain

pytestmark = pytest.mark.cuda

BF16_TOL = 2**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _case(B, K, H, device, seed=0):
    """bf16 inp, hx, w, b; float32 scale and bias."""
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((B, K)),
        rng.standard_normal((B, H)),
        rng.standard_normal((K, 3 * H)) / np.sqrt(K),
        0.1 * rng.standard_normal(3 * H),
        1.0 + 0.1 * rng.standard_normal(3 * H),
        0.1 * rng.standard_normal(3 * H),
    )
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]
    return [t.to(torch.bfloat16) for t in out[:4]] + out[4:]


# the serving shape, imagination's rows, and a shape off the 16-byte path
@pytest.mark.parametrize("B,K,H", [(4, 1024, 512), (1024, 1024, 512), (3, 40, 24)])
def test_bf16_kernel_matches_plain(cuda, B, K, H):
    args = _case(B, K, H, cuda)
    before = LN_GRU.launches
    out = ln_gru_step(*args)
    assert LN_GRU.launches == before + 1
    ref = ln_gru_step_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (B, H)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert torch.equal(out, ln_gru_step(*args))  # fixed summation orders


def test_bf16_kernel_gradient(cuda):
    """The backward differentiates the plain math: bf16 operands get bf16
    gradients, scale and bias float32 ones, as the JAX custom VJP gives."""
    args = [t.requires_grad_(True) for t in _case(16, 1024, 512, cuda, seed=1)]
    g = torch.randn(16, 512, device=cuda, generator=torch.Generator(cuda).manual_seed(0)).to(torch.bfloat16)
    grads = torch.autograd.grad(ln_gru_step(*args), args, g)
    refs = torch.autograd.grad(ln_gru_step_plain(*args), args, g)
    for a, gk, gp in zip(args, grads, refs):
        assert gk.dtype == a.dtype
        torch.testing.assert_close(gk.float(), gp.float(), rtol=BF16_TOL, atol=BF16_TOL)


def test_kernel_refuses_a_wrong_bf16_mix(cuda):
    """Any other mix raises: no bf16 operand is widened to reach the float32
    instance, and the LayerNorm's parameters stay float32."""
    args = _case(4, 64, 32, cuda)
    wrong = [
        [args[0], args[1], args[2].float(), *args[3:]],  # a float32 kernel beside bf16 operands
        [args[0].float(), *args[1:]],  # a float32 input
        [*args[:4], args[4].to(torch.bfloat16), args[5]],  # a bf16 LayerNorm scale
        [a.half() if i < 4 else a for i, a in enumerate(args)],  # float16
    ]
    for mix in wrong:
        with pytest.raises(NotImplementedError, match="all float32 or all bfloat16"):
            ln_gru_step(*mix)
