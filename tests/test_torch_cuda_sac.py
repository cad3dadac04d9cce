"""Card-only tests of the port's SAC and DroQ (marker ``cuda``; they skip
without a card). Like ``test_torch_cuda.py`` this file imports neither jax
nor the JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py tests/test_torch_cuda_sac.py -q
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


@pytest.mark.parametrize("algo", ["sac", "droq"])
def test_sac_and_droq_train_phases_on_the_card_match_the_cpu(cuda, algo):
    """One SAC train phase (4 gradient steps), or one DroQ phase (4 critic
    updates, then the actor's), at the exp's widths on the card and on the
    CPU from the same weights, block, normal draws and dropout masks, TF32
    off: ``chip_smoke.sac_train_phase_parity``, which raises past its bars
    (every parameter within 1e-4, the losses within 1e-4 relative)."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import sac_train_phase_parity

    sac_train_phase_parity(algo)
