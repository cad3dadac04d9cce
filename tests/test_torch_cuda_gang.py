"""Card-only test of the gang (marker ``cuda``; it skips without a card). It
imports neither jax nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_gang.py -q

A Dreamer-V3 gang of two processes (``exp=dreamer_v3_decoupled`` at phase
7c's S config, ``resilience.distributed.gang.processes=2``) whose learner is
SIGKILLed after its second round: ``chip_smoke.gang_path`` runs it through
``python -m sheeprl_tpu_torch`` and holds its gates (the player's exit 77
within the heartbeat timeout + 10 s, the restart from the newest
manifest-complete checkpoint, a complete last manifest). Here: the restarted
attempt's LN-GRU launches, player plus learner, are 79 a gradient step
(the posterior scan over T = 64 and the imagination over the horizon of 15)
plus one a policy step, both roles launched it, and neither built a kernel.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.timeout(600)
def test_a_dv3_gang_restarts_after_its_learner_is_killed_and_launches_the_kernel_in_both_roles(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from sheeprl_tpu_torch.ops import KERNELS
    from sheeprl_tpu_torch.ops._build import build

    build(KERNELS)  # the gang's processes load what this built
    out = chip_smoke.gang_path(str(tmp_path))
    launches, steps = out["attempt1_launches"], out["attempt1_gradient_steps"]
    assert steps > 0 and launches["learner"] == 79 * steps
    assert launches["player"] + launches["learner"] == out["attempt1_need"] and launches["player"] > 0
    assert out["exit_codes"] == {"0": 77, "1": -9} and out["last_manifest"]["complete"]
    assert out["attempt1_builds"] == {"player": 0, "learner": 0}
