"""Serving-policy registry (port of the serve half of ``sheeprl_tpu/utils/registry.py``).

``register_serve_policy`` records (module, entrypoint) per algorithm name; the
serve verb imports the module by name only when that algorithm is served, so
importing the package loads no algorithm."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

# algo name -> [{"module": str, "entrypoint": str, "name": str}]
serve_registry: Dict[str, List[Dict[str, Any]]] = {}

# algorithms whose serving extractor the port has, and the module holding it
SERVE_MODULES: Dict[str, str] = {
    "dreamer_v3": "sheeprl_tpu_torch.algos.dreamer_v3.serve",
    "dreamer_v3_decoupled": "sheeprl_tpu_torch.algos.dreamer_v3.serve",
}


def register_serve_policy(algorithms: Sequence[str]) -> Callable:
    """Register a family's ``get_serve_policy(fabric, cfg, state)`` extractor."""

    def wrap(fn: Callable) -> Callable:
        algos = [algorithms] if isinstance(algorithms, str) else list(algorithms)
        for algo in algos:
            regs = serve_registry.setdefault(algo, [])
            entry = {"module": fn.__module__, "entrypoint": fn.__name__, "name": algo}
            if entry not in regs:
                regs.append(entry)
        return fn

    return wrap


def get_serve(name: str) -> Optional[Dict[str, Any]]:
    """The registered extractor for ``name``, importing its module on demand."""
    if name not in serve_registry and name in SERVE_MODULES:
        import importlib

        importlib.import_module(SERVE_MODULES[name])
    regs = serve_registry.get(name)
    return regs[0] if regs else None
