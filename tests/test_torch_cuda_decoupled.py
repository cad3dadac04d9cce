"""Card-only tests of the decoupled topology (marker ``cuda``; they skip
without a card). Like ``test_torch_cuda.py`` this file imports neither jax nor
the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_decoupled.py -q

- one learner round of ``ppo_decoupled``, ``sac_decoupled`` and
  ``dreamer_v3_decoupled``, driven through its thread, on the card against
  the same round on the CPU (TF32 off): ``chip_smoke.decoupled_round_parity``
  (the coupled families' bars);
- the LN-GRU kernel launched from both threads of a decoupled DV3 run is
  counted once a launch: a round of the channel trainer in the learner's
  thread, then the player's step in this one;
- two processes that start together on an empty build directory (the
  player and the learner of a two-process run, each in its own CUDA context)
  both build and load the kernel, and its call agrees with the plain version
  in each; one library is left, and no partial file.
"""

from __future__ import annotations

import sys
from pathlib import Path

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


@pytest.mark.timeout(600)
@pytest.mark.parametrize("kind", ["ppo", "sac", "dv3"])
def test_a_learner_round_on_the_card_matches_the_cpu(cuda, kind):
    res = _smoke().decoupled_round_parity(kind)
    assert res["opt_state_shipped"]


@pytest.mark.timeout(300)
def test_launches_from_the_learner_and_the_player_threads_are_counted(cuda):
    """DV3 S on short sequences (4 steps, a horizon of 3): one round of one
    gradient step launches the kernel 4 + 3 times in the learner's thread;
    the player's step on its own copy of the agent once more here."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import ChannelTrainer
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops import LN_GRU
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(["exp=dreamer_v3_decoupled", "env=dummy", "algo.cnn_keys.encoder=[rgb]",
                   "algo.mlp_keys.encoder=[state]", "algo.horizon=3"])
    space = make_env(cfg, 0, 0)().observation_space
    agent = build_agent(Fabric(accelerator="gpu"), (2,), False, cfg, space, 0)
    trainer = ChannelTrainer(agent, cfg)
    rng = np.random.default_rng(0)
    T, B = 4, 2
    block = {
        "rgb": torch.from_numpy(rng.integers(0, 256, (1, T, B, 3, 64, 64)).astype(np.uint8)),
        "state": torch.from_numpy(rng.standard_normal((1, T, B, 10)).astype(np.float32)),
        "actions": torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, (1, T, B))]),
        **{k: torch.zeros((1, T, B, 1)) for k in ("rewards", "terminated", "truncated", "is_first")},
    }
    LN_GRU.zero_launches()
    try:
        metrics = trainer.train({k: v.to(cuda) for k, v in block.items()}, 0, torch.Generator(cuda).manual_seed(0))
        assert LN_GRU.launches == T + 3 and all(np.isfinite(v) for v in metrics.values())
        player = PlayerDV3(trainer.act_agent, 2, ["rgb"], ["state"])
        player.init_states()
        obs = {"rgb": rng.integers(0, 256, (2, 3, 64, 64)).astype(np.uint8),
               "state": rng.standard_normal((2, 10)).astype(np.float32)}
        jobs = prepare_obs(obs, cnn_keys=["rgb"], mlp_keys=["state"], num_envs=2, device=cuda)
        player.get_actions(jobs, generator=torch.Generator(cuda).manual_seed(1))
        assert LN_GRU.launches == T + 3 + 1
    finally:
        trainer.close()


# each process: the kernel built into the directory it is given, one call at
# the player's shape (S, B = 4) against the plain version, the error printed
_BUILD_AND_CALL = """
import sys
from pathlib import Path

import torch

import sheeprl_tpu_torch.ops._build as build

build.BUILD_DIR = Path(sys.argv[1])
sys.path.insert(0, sys.argv[2])
import chip_smoke
from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain

args = chip_smoke.gru_case(4, 1024, 512, 0, torch.device("cuda", 0))
torch.backends.cuda.matmul.allow_tf32 = False
err = (ln_gru_step(*args) - ln_gru_step_plain(*args)).abs().max().item()
print("launches", LN_GRU.launches, "max_abs_err", err, flush=True)
"""


@pytest.mark.timeout(600)
def test_two_processes_building_into_an_empty_directory_both_load_the_kernel(cuda, tmp_path):
    import os
    import re
    import subprocess

    build_dir = tmp_path / "torch_kernels"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CALL, str(build_dir), str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    try:
        logs = [p.communicate(timeout=540)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    for log in logs:
        found = re.search(r"launches (\d+) max_abs_err (\S+)", log)
        assert found and int(found.group(1)) == 1 and float(found.group(2)) <= _smoke().GRU_ATOL, log
    files = sorted(p.name for p in build_dir.iterdir())
    assert len(files) == 1 and files[0].endswith(".so") and ".tmp." not in files[0], files
