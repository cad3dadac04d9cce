"""Card-only tests of the on-policy Anakin topology and of
``xla_deterministic_ops`` (marker ``cuda``; they skip without a card). Like
``test_torch_cuda.py`` this file imports neither jax nor the JAX package; on
the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_anakin.py -q

- the device env step, card vs CPU: ``chip_smoke.anakin_env_parity``
  (CartPole and Pendulum, 128 steps of 64 envs, each from the CPU's state;
  within 1e-5, flags equal);
- one PPO and one A2C Anakin train phase, card vs CPU:
  ``chip_smoke.anakin_train_parity`` (PPO's bars);
- the rollout's step loop makes no host sync: ``chip_smoke.anakin_syncs``;
- one step of each family with ``xla_deterministic_ops`` on
  (``chip_smoke.deterministic_step``): it runs, with deterministic
  algorithms on, to finite results;
- ``exp=ppo_anakin`` with ``xla_deterministic_ops=True`` trained twice
  through the CLI, each run in a fresh process (so the Fabric sets
  ``CUBLAS_WORKSPACE_CONFIG`` before the process's first cuBLAS call): the
  two checkpoints' parameters and optimizer state are equal bit for bit.
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
FAMILIES = ["dv3", "p2e", "odv3", "dv2", "dv1", "p2e_dv2", "p2e_dv1", "sac_ae", "sac", "droq", "ppo", "a2c",
            "ppo_recurrent", "ppo_anakin", "a2c_anakin", "sac_anakin"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def test_device_env_step_on_the_card_matches_the_cpu(cuda):
    res = _smoke().anakin_env_parity()
    assert set(res) == {"CartPole-v1", "Pendulum-v1"}


def test_anakin_train_phases_on_the_card_match_the_cpu(cuda):
    res = _smoke().anakin_train_parity()
    assert res["ppo_anakin"]["updates"] == 16 and res["a2c_anakin"]["updates"] == 1
    assert all(r["truncated_rows"] > 0 for r in res.values())


def test_the_rollout_makes_no_host_sync(cuda):
    assert _smoke().anakin_syncs()["rollout"] == 0


def test_one_step_of_each_family_runs_with_xla_deterministic_ops(cuda):
    # one case for all the families: a file of few cases keeps the CPU run's
    # test schedule
    smoke = _smoke()
    res = {family: smoke.deterministic_step(family) for family in FAMILIES}
    assert all(r["ok"] for r in res.values()), res
    assert not torch.are_deterministic_algorithms_enabled()


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
            [sys.executable, "-m", "sheeprl_tpu_torch", "exp=ppo_anakin", "xla_deterministic_ops=True",
             "algo.total_steps=32768", "checkpoint.every=32768", "env.capture_video=False", "root_dir=det",
             "run_name=run"],
            cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        ckpts = sorted((cwd / "logs" / "runs" / "det" / "run" / "version_0" / "checkpoint").glob("*.ckpt"))
        states.append(load_checkpoint(str(ckpts[-1])))
    first, second = ({k: s[k] for k in ("agent", "optimizer", "iter_num")} for s in states)
    assert first["iter_num"] == second["iter_num"] == 4
    a, b = list(_leaves(first)), list(_leaves(second))
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 10
    differ = [p for (p, x), (_, y) in zip(a, b) if x.tobytes() != y.tobytes()]
    assert not differ, differ
