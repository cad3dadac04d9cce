"""PPO, Anakin topology (port of ``sheeprl_tpu/algos/ppo/ppo_anakin.py``): the
envs on the card, rollout, GAE and the clipped-surrogate epochs in one loop
with no host round trip (``algos/ppo/anakin.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.anakin import run_anakin


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_anakin(fabric, cfg)
