"""Card-only tests of the PyTorch port (marker ``cuda``; they skip without a card).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only torch: from the repo root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax). The hand-written kernel is
held against its plain PyTorch version on the card with TF32 off; the sums over
K are split across blocks on the card and taken in another order by cuBLAS, so
they agree to 1e-4 (``chip_smoke.py`` measures ~2e-6).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(B, K, H, device, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((B, K)),
        rng.standard_normal((B, H)),
        rng.standard_normal((K, 3 * H)) / np.sqrt(K),
        0.1 * rng.standard_normal(3 * H),
        1.0 + 0.1 * rng.standard_normal(3 * H),
        0.1 * rng.standard_normal(3 * H),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]


@pytest.mark.parametrize("B,K,H", [(4, 1024, 512), (64, 1024, 512), (3, 40, 24), (4, 2816, 2048), (4, 5120, 4096)])
def test_kernel_matches_plain(cuda, B, K, H):
    args = _case(B, K, H, cuda)
    before = LN_GRU.launches
    out = ln_gru_step(*args)
    assert LN_GRU.launches == before + 1
    torch.testing.assert_close(out, ln_gru_step_plain(*args), rtol=1e-4, atol=1e-4)
    targs = [a.clone().requires_grad_(True) for a in args]
    g = torch.randn(B, H, device=cuda)
    gk = torch.autograd.grad(ln_gru_step(*targs), targs, g)
    gp = torch.autograd.grad(ln_gru_step_plain(*targs), targs, g)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    args = _case(4, 64, 32, cuda)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ln_gru_step(*[a.to(torch.bfloat16) for a in args])
    w_t = args[2].t().contiguous().t()  # same values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ln_gru_step(args[0], args[1], w_t, *args[3:])
    with pytest.raises(ValueError, match="is on"):
        ln_gru_step(args[0], args[1].cpu(), *args[2:])


def test_serve_verb_runs_on_the_card_by_default(cuda, tmp_path):
    """``python -m sheeprl_tpu_torch serve`` with no accelerator override serves
    on the card, through the kernel."""
    import yaml

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(
        ["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XS", "algo.cnn_keys.encoder=[rgb]",
         "algo.mlp_keys.encoder=[state]", "env.capture_video=False"]
    )
    env = make_env(cfg, 0, 0)()
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, env.observation_space, 0)
    run = tmp_path / "run"
    save_checkpoint(str(run / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"), {"agent": agent_to_flax(agent)})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.as_dict(), f)
    proc = subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}",
         "serve.sessions=2", "serve.slots=2", f"serve.log_dir={tmp_path / 'log'}"],
        env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    summary = json.loads((tmp_path / "log" / "summary.json").read_text())
    assert summary["device"] == torch.cuda.get_device_name(0)
    assert summary["sessions_completed"] == 2
