"""Plan2Explore on the Dreamer-V2 backbone, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py``): Plan2Explore-DV1's
:func:`finetune` on Dreamer-V2's ``main``, whose checkpoints hold
Dreamer-V2's layout (the target critic included)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning import EXPLORATION_ALGO_KEYS, finetune

# Dreamer-V2's blocks also take the exploration run's ``layer_norm``
EXPLORATION_ALGO_KEYS_DV2 = ("layer_norm", *EXPLORATION_ALGO_KEYS)


def main(fabric, cfg: Dict[str, Any], exploration_cfg: Dict[str, Any]) -> Dict[str, Any]:
    return finetune(fabric, cfg, exploration_cfg, dreamer_v2.main, EXPLORATION_ALGO_KEYS_DV2)
