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
_P2E = "sheeprl_tpu_torch.algos.p2e_dv3"
_ODV3 = "sheeprl_tpu_torch.algos.offline_dreamer"
_DV2 = "sheeprl_tpu_torch.algos.dreamer_v2"
_DV1 = "sheeprl_tpu_torch.algos.dreamer_v1"
_P2E_DV1 = "sheeprl_tpu_torch.algos.p2e_dv1"
_P2E_DV2 = "sheeprl_tpu_torch.algos.p2e_dv2"

# the training loop ``main(fabric, cfg)``
ALGORITHMS: Dict[str, Tuple[str, str]] = {
    "dreamer_v3": (f"{_DV3}.dreamer_v3", "main"),
    "p2e_dv3_exploration": (f"{_P2E}.p2e_dv3_exploration", "main"),
    "p2e_dv3_finetuning": (f"{_P2E}.p2e_dv3_finetuning", "main"),
    "offline_dreamer": (f"{_ODV3}.offline_dreamer", "main"),
    "dreamer_v2": (f"{_DV2}.dreamer_v2", "main"),
    "dreamer_v1": (f"{_DV1}.dreamer_v1", "main"),
    "p2e_dv1_exploration": (f"{_P2E_DV1}.p2e_dv1_exploration", "main"),
    "p2e_dv1_finetuning": (f"{_P2E_DV1}.p2e_dv1_finetuning", "main"),
    "p2e_dv2_exploration": (f"{_P2E_DV2}.p2e_dv2_exploration", "main"),
    "p2e_dv2_finetuning": (f"{_P2E_DV2}.p2e_dv2_finetuning", "main"),
    "ppo": ("sheeprl_tpu_torch.algos.ppo.ppo", "main"),
    "a2c": ("sheeprl_tpu_torch.algos.a2c.a2c", "main"),
    "ppo_anakin": ("sheeprl_tpu_torch.algos.ppo.ppo_anakin", "main"),
    "a2c_anakin": ("sheeprl_tpu_torch.algos.a2c.a2c_anakin", "main"),
    "ppo_recurrent": ("sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent", "main"),
    "sac": ("sheeprl_tpu_torch.algos.sac.sac", "main"),
    "sac_anakin": ("sheeprl_tpu_torch.algos.sac.sac_anakin", "main"),
    "droq": ("sheeprl_tpu_torch.algos.droq.droq", "main"),
    "sac_ae": ("sheeprl_tpu_torch.algos.sac_ae.sac_ae", "main"),
    "ppo_decoupled": ("sheeprl_tpu_torch.algos.ppo.ppo_decoupled", "main"),
    "sac_decoupled": ("sheeprl_tpu_torch.algos.sac.sac_decoupled", "main"),
    "dreamer_v3_decoupled": (f"{_DV3}.dreamer_v3_decoupled", "main"),
}
# the JAX registry's ``decoupled`` flag: a player loop and a learner thread
DECOUPLED = frozenset({"ppo_decoupled", "sac_decoupled", "dreamer_v3_decoupled"})
# ``evaluate(fabric, cfg, state)``
EVALUATIONS: Dict[str, Tuple[str, str]] = {
    **{name: (f"{_DV3}.evaluate", "evaluate") for name in _DV3_NAMES},
    # both phases evaluate the task actor
    **{name: (f"{_P2E}.evaluate", "evaluate") for name in ("p2e_dv3_exploration", "p2e_dv3_finetuning")},
    "offline_dreamer": (f"{_ODV3}.evaluate", "evaluate"),
    "dreamer_v2": (f"{_DV2}.evaluate", "evaluate"),
    "dreamer_v1": (f"{_DV1}.evaluate", "evaluate"),
    # both phases: the task actor of an exploration checkpoint, or a
    # finetuning checkpoint in the backbone's layout
    **{name: (f"{_P2E_DV1}.evaluate", "evaluate") for name in ("p2e_dv1_exploration", "p2e_dv1_finetuning")},
    **{name: (f"{_P2E_DV2}.evaluate", "evaluate") for name in ("p2e_dv2_exploration", "p2e_dv2_finetuning")},
    "ppo": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "ppo_decoupled": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "a2c": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    # the Anakin checkpoints hold the PPO agent
    "ppo_anakin": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "a2c_anakin": ("sheeprl_tpu_torch.algos.ppo.evaluate", "evaluate"),
    "ppo_recurrent": ("sheeprl_tpu_torch.algos.ppo_recurrent.evaluate", "evaluate"),
    "sac": ("sheeprl_tpu_torch.algos.sac.evaluate", "evaluate"),
    "sac_decoupled": ("sheeprl_tpu_torch.algos.sac.evaluate", "evaluate"),
    "droq": ("sheeprl_tpu_torch.algos.droq.evaluate", "evaluate"),
    "sac_ae": ("sheeprl_tpu_torch.algos.sac_ae.evaluate", "evaluate"),
}
# the family's ``get_serve_policy(fabric, cfg, state)`` extractor
SERVE_POLICIES: Dict[str, Tuple[str, str]] = {
    **{name: (f"{_DV3}.serve", "get_serve_policy") for name in _DV3_NAMES},
    "dreamer_v2": (f"{_DV2}.serve", "get_serve_policy"),
    "dreamer_v1": (f"{_DV1}.serve", "get_serve_policy"),
    # A2C and the Anakin checkpoints hold the PPO agent
    **{name: ("sheeprl_tpu_torch.algos.ppo.serve", "get_serve_policy")
       for name in ("ppo", "ppo_decoupled", "a2c", "ppo_anakin", "a2c_anakin")},
    "ppo_recurrent": ("sheeprl_tpu_torch.algos.ppo_recurrent.serve", "get_serve_policy"),
    "sac": ("sheeprl_tpu_torch.algos.sac.serve", "get_serve_policy"),
    "sac_decoupled": ("sheeprl_tpu_torch.algos.sac.serve", "get_serve_policy"),
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
