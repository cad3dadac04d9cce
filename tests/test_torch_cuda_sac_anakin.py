"""Card-only tests of the off-policy Anakin topology (marker ``cuda``; they
skip without a card). Like ``test_torch_cuda.py`` this file imports neither
jax nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sac_anakin.py -q

- the replay ring's write and sample at ``exp=sac_anakin``'s shape, card vs
  CPU: ``chip_smoke.sac_anakin_ring_parity`` (the rings and the draws
  bitwise equal, on the fill ramp and after a wrap);
- one SAC Anakin iteration, card vs CPU with TF32 off:
  ``chip_smoke.sac_anakin_step_parity`` (SAC's train-phase bars);
- an iteration makes no host sync in the rollout, the ring write, the ring
  sample or the gradient steps: ``chip_smoke.sac_anakin_syncs``;
- ``exp=sac_anakin`` with ``xla_deterministic_ops=True`` trained twice
  through the CLI, each run in a fresh process: the two checkpoints'
  parameters, optimizer states and ring twins are equal bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_the_ring_on_the_card_matches_the_cpu(cuda):
    res = _smoke().sac_anakin_ring_parity()
    assert res["wrapped"]["fill"] == 4096 and res["wrapped"]["distinct_slots"] == 65536


def test_a_sac_anakin_iteration_on_the_card_matches_the_cpu(cuda):
    res = _smoke().sac_anakin_step_parity()
    assert res["grad_steps"] == 4 and res["ep_stats_cpu"][2] > 0


def test_the_iteration_makes_no_host_sync(cuda):
    counts = _smoke().sac_anakin_syncs()
    assert all(counts[k] == 0 for k in ("rollout", "ring_write", "ring_sample", "train"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.timeout(600)
def test_xla_deterministic_ops_repeats_a_run_bit_for_bit(cuda, tmp_path):
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = str(REPO)
    states = []
    for i in range(2):
        cwd = tmp_path / f"run{i}"
        cwd.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", "sheeprl_tpu_torch", "exp=sac_anakin", "xla_deterministic_ops=True",
             "algo.total_steps=8192", "checkpoint.every=8192", "algo.run_test=False", "root_dir=det", "run_name=run"],
            cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        ckpts = sorted((cwd / "logs" / "runs" / "det" / "run" / "version_0" / "checkpoint").glob("*.ckpt"))
        states.append(load_checkpoint(str(ckpts[-1])))
    first, second = ({k: s[k] for k in ("agent", "opt_state", "iter_num")} for s in states)
    assert first["iter_num"] == second["iter_num"] == 2
    a, b = list(_leaves(first)), list(_leaves(second))
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 10
    # numbers bit for bit; the optimizers' flags (None, bools) by value
    differ = [p for (p, x), (_, y) in zip(a, b)
              if (x.tolist() != y.tolist() if x.dtype == object else x.tobytes() != y.tobytes())]
    assert not differ, differ
    rings = [s["rb"] for s in states]
    assert rings[0]._pos == rings[1]._pos == 128
    for k in rings[0].buffer:  # the filled rows: the file holds no others
        assert rings[0][k][:128].tobytes() == rings[1][k][:128].tobytes(), k
