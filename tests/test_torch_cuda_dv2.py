"""Card-only tests of Dreamer-V2 and Dreamer-V1 (marker ``cuda``; they skip
without a card). Like ``test_torch_cuda.py`` this file imports neither jax
nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dv2.py -q

- the LN-GRU kernel at the DV2 cell, K = 400 + 600 = 1000 and 3H = 1800 (the
  first shape that is not a whole number of the kernel's tiles: the 19th
  column group holds 24 of its 32 columns, the last K stage 8 of its 32
  rows), at the player's, the posterior scan's and imagination's batches,
  float32 and bf16, forward and gradient against the plain version (float32
  1e-4; bf16 one rounding, rtol = atol = 2^-7);
- one DV2 and one DV1 gradient step at their exps' widths on the card against
  the same step on the CPU (TF32 off): ``chip_smoke.family_step_parity`` with
  the float32 bars of ``chip_smoke.train_step_parity``;
- a DV2 step launches the kernel once a scan step and once an imagined step,
  a DV1 step never; DV2 serving launches it once a tick.
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
def test_kernel_at_the_dv2_cell(cuda, B):
    K, H = 1000, 600
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


@pytest.mark.parametrize("kind", ["dv2", "dv1"])
def test_steps_on_the_card_match_the_cpu(cuda, kind):
    smoke = _smoke()
    smoke.family_step_parity(kind, actor_rtol=smoke.TRAIN_STEP_RTOL)


def test_launches_of_a_dv2_and_a_dv1_step_and_of_dv2_serving(cuda):
    """T scan steps and a rollout of ``horizon`` steps, 16 + 15, for DV2; none
    for DV1. Serving: one launch a tick at [slots, 1000]."""
    from sheeprl_tpu_torch.algos.dreamer_v2.serve import get_serve_policy
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.slots import SlotTable

    smoke = _smoke()
    for kind, need in (("dv2", 16 + 15), ("dv1", 0)):
        trainers, batch = smoke._family_trainers(kind, ("gpu",), 16, 4)
        trainer = trainers["gpu"]
        noise = trainer.draw_noise(16, 4, torch.Generator(cuda).manual_seed(0))
        before = LN_GRU.launches
        metrics = trainer.train_step({k: v.to(cuda) for k, v in batch.items()}, 0, noise)
        assert LN_GRU.launches - before == need
        assert all(torch.isfinite(v).all() for v in metrics.values())
    cfg = compose(smoke.dv_overrides("dreamer_v2"))
    cfg["serve"] = {"greedy": True}
    policy = get_serve_policy(Fabric(accelerator="gpu"), cfg, {})
    table = SlotTable(policy, 4, base_seed=0)
    obs = {k: spec.zeros(4) for k, spec in policy.obs_spec.items()}
    before = LN_GRU.launches
    for _ in range(5):
        table.step(obs, np.ones(4, np.bool_))
    assert LN_GRU.launches - before == 5
