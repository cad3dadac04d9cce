"""A2C, Anakin topology (port of ``sheeprl_tpu/algos/a2c/a2c_anakin.py``): the
envs on the card, one full-rollout A2C update an iteration
(``algos/ppo/anakin.py`` holds the shared loop)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.anakin import run_anakin


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_anakin(fabric, cfg)
