"""``_target_``-driven object construction, the DI mechanism of the config tree.

Mirrors the role of ``hydra.utils.instantiate`` in the reference (optimizers at
sheeprl/algos/ppo/ppo.py:183, env wrappers at sheeprl/utils/env.py:74): a config node
whose ``_target_`` names a dotted callable is imported and called with the node's other
keys as kwargs.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict


def locate(path: str) -> Any:
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"cannot locate bare name {path!r}")
    try:
        module = importlib.import_module(module_path)
        return getattr(module, attr)
    except (ImportError, AttributeError):
        # maybe the attr is a nested class: walk from the longest importable prefix
        parts = path.split(".")
        for i in range(len(parts) - 1, 0, -1):
            try:
                obj: Any = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            for p in parts[i:]:
                obj = getattr(obj, p)
            return obj
        raise


def instantiate(node: Dict[str, Any], *args: Any, **overrides: Any) -> Any:
    if node is None:
        return None
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"cannot instantiate non-_target_ node: {node!r}")
    target: Callable = locate(node["_target_"])
    kwargs = {k: v for k, v in node.items() if not (k.startswith("_") and k.endswith("_"))}
    partial = bool(node.get("_partial_", False))
    kwargs.update(overrides)
    if partial:
        import functools

        return functools.partial(target, *args, **kwargs)
    return target(*args, **kwargs)
