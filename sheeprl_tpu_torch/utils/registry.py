"""Algorithm, evaluation and serving entry points (port of
``sheeprl_tpu/utils/registry.py``).

One table per verb maps an algorithm name to the module and function that run
it. The CLI imports a module only when its algorithm is used, so importing the
package loads no algorithm."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

_DV3 = "sheeprl_tpu_torch.algos.dreamer_v3"
_DV3_NAMES = ("dreamer_v3", "dreamer_v3_decoupled")

# the training loop ``main(fabric, cfg)``
ALGORITHMS: Dict[str, Tuple[str, str]] = {
    "dreamer_v3": (f"{_DV3}.dreamer_v3", "main"),
    "ppo": ("sheeprl_tpu_torch.algos.ppo.ppo", "main"),
    "a2c": ("sheeprl_tpu_torch.algos.a2c.a2c", "main"),
    "sac": ("sheeprl_tpu_torch.algos.sac.sac", "main"),
    "droq": ("sheeprl_tpu_torch.algos.droq.droq", "main"),
}
# ``evaluate(fabric, cfg, state)``
EVALUATIONS: Dict[str, Tuple[str, str]] = {
    **{name: (f"{_DV3}.evaluate", "evaluate") for name in _DV3_NAMES},
    "ppo": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "a2c": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "sac": ("sheeprl_tpu_torch.algos.sac.evaluate", "evaluate"),
    "droq": ("sheeprl_tpu_torch.algos.droq.evaluate", "evaluate"),
}
# the family's ``get_serve_policy(fabric, cfg, state)`` extractor
SERVE_POLICIES: Dict[str, Tuple[str, str]] = {
    **{name: (f"{_DV3}.serve", "get_serve_policy") for name in _DV3_NAMES},
    # A2C checkpoints hold the PPO agent
    **{name: ("sheeprl_tpu_torch.algos.ppo.serve", "get_serve_policy") for name in ("ppo", "a2c")},
    "sac": ("sheeprl_tpu_torch.algos.sac.serve", "get_serve_policy"),
    "droq": ("sheeprl_tpu_torch.algos.sac.serve", "get_serve_policy_droq"),
}


def load_entrypoint(table: Dict[str, Tuple[str, str]], name: str, what: str) -> Callable:
    """The function ``table`` names for algorithm ``name``, importing its
    module; raises with the ported set when there is none."""
    if name not in table:
        raise ValueError(
            f"no {what} for algorithm {name!r} in sheeprl_tpu_torch; available: {', '.join(sorted(table))}"
        )
    module, entrypoint = table[name]
    return getattr(importlib.import_module(module), entrypoint)
