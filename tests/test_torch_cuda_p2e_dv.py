"""Card-only tests of Plan2Explore on Dreamer-V2 and V1 and of SAC-AE (marker
``cuda``; they skip without a card). Like ``test_torch_cuda.py`` this file
imports neither jax nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_p2e_dv.py -q

- the LN-GRU kernel at the P2E-DV2 cell, K = 400 + 400 = 800 and 3H = 1200
  (the 13th column group holds 16 of its 32 columns, the finish launch's 4th
  block 16 of 128; K is 25 whole stages), at the player's, the posterior
  scan's and imagination's batches, float32 and bf16, forward and gradient
  against the plain version (float32 1e-4; bf16 one rounding, rtol = atol =
  2^-7);
- one P2E-DV2, one P2E-DV1 and one SAC-AE gradient step at their exps'
  widths on the card against the same step on the CPU (TF32 off):
  ``chip_smoke.family_step_parity`` with the float32 bars of
  ``chip_smoke.train_step_parity`` (the new actors' too), and
  ``chip_smoke.sac_ae_step_parity``;
- a P2E-DV2 exploration step launches the kernel once a scan step and once an
  imagined step of each of its two rollouts, a P2E-DV1 step never.
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


@pytest.mark.parametrize("B", [4, 16, 800])
def test_kernel_at_the_p2e_dv2_cell(cuda, B):
    K, H = 800, 400
    rng = np.random.default_rng(B + 1)
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


@pytest.mark.parametrize("kind", ["p2e_dv2", "p2e_dv1"])
def test_p2e_steps_on_the_card_match_the_cpu(cuda, kind):
    smoke = _smoke()
    smoke.family_step_parity(kind, actor_rtol=smoke.TRAIN_STEP_RTOL)


def test_sac_ae_step_on_the_card_matches_the_cpu(cuda):
    _smoke().sac_ae_step_parity()


def test_launches_of_p2e_steps(cuda):
    """T scan steps and two rollouts of ``horizon`` steps, 16 + 15 + 15, for
    P2E-DV2; none for P2E-DV1."""
    smoke = _smoke()
    for kind, need in (("p2e_dv2", 16 + 15 + 15), ("p2e_dv1", 0)):
        trainers, batch = smoke._family_trainers(kind, ("gpu",), 16, 4)
        trainer = trainers["gpu"]
        noise = trainer.draw_noise(16, 4, torch.Generator(cuda).manual_seed(0))
        before = LN_GRU.launches
        metrics = trainer.train_step({k: v.to(cuda) for k, v in batch.items()}, 0, noise)
        assert LN_GRU.launches - before == need
        assert all(torch.isfinite(v).all() for v in metrics.values())
