"""Card-only tests of recurrent PPO (marker ``cuda``; they skip without a
card). Like ``test_torch_cuda.py`` this file imports neither jax nor the JAX
package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ppo_recurrent.py -q

- the agent's forward and its gradient over a padded sequence at the exp's
  widths (LSTM 64, LayerNorm on, the pre- and post-RNN MLPs on) on the card
  against the CPU with TF32 off: outputs, values and the last ``(hx, cx)``
  within 1e-5; every gradient tensor within 1e-5 relative in norm (each
  entry sums 512 rows of terms up to ~10, and float32 rounding scales with
  the terms, not with the sum: an entry that cancels to ~0.1 differed by
  1.5e-5 on the card);
- one train phase at the exp's shape and 4 greedy serve ticks, card vs CPU:
  ``chip_smoke.rppo_parity`` with PPO's bars;
- ``exp=ppo_recurrent`` through ``run`` on the card for two iterations: the
  train phase's weights on the card, the acting copy on the host, a
  checkpoint, finite losses; its evaluation on the card; no LN-GRU launch.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import LN_GRU

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_forward_and_gradient_on_the_card_match_the_cpu(cuda):
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(["exp=ppo_recurrent", "algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"])
    space = make_env(cfg, 0, 0)().observation_space
    agents = {accel: build_agent(Fabric(accelerator=accel, float32_matmul_precision="highest"), (2,), False, cfg,
                                 space, 0) for accel in ("gpu", "cpu")}
    rng = np.random.default_rng(0)
    T, B, H = 16, 32, 64
    inputs = [rng.standard_normal((T, B, 4)), np.eye(2)[rng.integers(0, 2, (T, B))], rng.standard_normal((B, H)),
              rng.standard_normal((B, H)), (np.arange(T)[:, None, None] < rng.integers(1, T + 1, (1, B, 1)))]
    out = {}
    for accel, agent in agents.items():
        dev = next(agent.parameters()).device
        state, prev, hx, cx, mask = (torch.tensor(a, dtype=torch.float32, device=dev) for a in inputs)
        actor_outs, values, (hx, cx) = agent({"state": state}, prev, hx, cx, mask)
        loss = (actor_outs[0] * mask).square().sum() + (values * mask).sum() + hx.sum() + cx.square().sum()
        grads = torch.autograd.grad(loss, list(agent.parameters()))
        out[accel] = [t.detach().cpu() for t in (actor_outs[0], values, hx, cx, *grads)]
    for card, cpu in zip(out["gpu"][:4], out["cpu"][:4]):
        torch.testing.assert_close(card, cpu, rtol=0, atol=ATOL)
    for i, (card, cpu) in enumerate(zip(out["gpu"][4:], out["cpu"][4:])):
        rel = float((card - cpu).norm() / cpu.norm().clamp_min(1e-12))
        assert rel <= GRAD_RTOL, f"gradient {i}: relative error {rel}"


def test_train_phase_and_serve_step_on_the_card_match_the_cpu(cuda):
    res = _smoke().rppo_parity()
    assert res["updates"] == 64 and res["serve_actions_equal"]


def test_training_runs_on_the_card(cuda, tmp_path):
    from sheeprl_tpu_torch.cli import evaluation, run

    before = LN_GRU.launches
    summary = run(["exp=ppo_recurrent", "env.num_envs=4", "algo.rollout_steps=32", "algo.total_steps=256",
                   "env.capture_video=False", f"hydra.run.dir={tmp_path / 'rppo'}"])
    assert summary["train_phases"] == 2 and Path(summary["checkpoint"]).is_file()
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    assert np.isfinite(evaluation([f"checkpoint_path={summary['checkpoint']}", "env.capture_video=False"]))
    assert LN_GRU.launches == before
