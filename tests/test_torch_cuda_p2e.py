"""Card-only tests of Plan2Explore and Offline Dreamer (marker ``cuda``; they
skip without a card). Like ``test_torch_cuda.py`` this file imports neither
jax nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_p2e.py -q

- one P2E gradient step at the DOA++ exps' widths and one Offline Dreamer
  step at its S preset on the card against the same step on the CPU (TF32
  off): ``chip_smoke.family_step_parity``, which raises past the float32 bars
  of ``chip_smoke.train_step_parity``;
- the LN-GRU kernel at the DOA++ cell, K = 768 + 1024 = 1792 and 3H = 3072,
  at the scan's, the player's and imagination's batches, float32 and bf16,
  forward and gradient against the plain version (float32 1e-4; bf16 one
  rounding, rtol = atol = 2^-7);
- a P2E step launches the kernel once a scan step and once a step of each
  of its two imaginations.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
F32_ATOL = 1e-4
BF16_TOL = 2**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("kind", ["p2e", "odv3"])
def test_family_steps_on_the_card_match_the_cpu(cuda, kind):
    _smoke().family_step_parity(kind)


@pytest.mark.parametrize("B", [4, 16, 256])
def test_kernel_at_the_doa_cell(cuda, B):
    K, H = 1792, 1024
    rng = np.random.default_rng(B)
    arrs = (rng.standard_normal((B, K)), rng.standard_normal((B, H)), rng.standard_normal((K, 3 * H)) / np.sqrt(K),
            0.1 * rng.standard_normal(3 * H), 1.0 + 0.1 * rng.standard_normal(3 * H), 0.1 * rng.standard_normal(3 * H))
    base = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in arrs]
    for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_TOL)):
        args = [t.to(dtype) for t in base[:4]] + base[4:]
        before = LN_GRU.launches
        out = ln_gru_step(*args)
        assert LN_GRU.launches == before + 1
        ref = ln_gru_step_plain(*args)
        rtol = tol if dtype == torch.bfloat16 else 0.0
        assert out.dtype == dtype and out.shape == (B, H)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=tol)
        grads = [t.clone().requires_grad_(True) for t in args]
        g = torch.randn(B, H, device=cuda, generator=torch.Generator(cuda).manual_seed(0)).to(dtype)
        for a, p in zip(torch.autograd.grad(ln_gru_step(*grads), grads, g),
                        torch.autograd.grad(ln_gru_step_plain(*grads), grads, g)):
            torch.testing.assert_close(a.float(), p.float(), rtol=rtol, atol=tol)


def test_p2e_step_launches_the_kernel_in_all_three_scans(cuda):
    """T scan steps and two rollouts of ``horizon`` steps: 16 + 15 + 15."""
    smoke = _smoke()
    trainers, batch = smoke._family_trainers("p2e", ("gpu",), 16, 4)
    trainer = trainers["gpu"]
    batch = {k: v.to(cuda) for k, v in batch.items()}
    noise = trainer.draw_noise(16, 4, torch.Generator(cuda).manual_seed(0))
    before = LN_GRU.launches
    metrics = trainer.train_step(batch, 0, noise)
    assert LN_GRU.launches - before == 16 + 2 * trainer.horizon == 46
    assert all(torch.isfinite(v).all() for v in metrics.values())
