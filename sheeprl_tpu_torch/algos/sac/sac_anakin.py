"""SAC, Anakin topology (port of ``sheeprl_tpu/algos/sac/sac_anakin.py``): the
envs and the replay ring on the card, rollout, ring write and sample and the
gradient steps in one loop with no host round trip (``algos/sac/anakin.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.sac.anakin import run_sac_anakin


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_sac_anakin(fabric, cfg)
