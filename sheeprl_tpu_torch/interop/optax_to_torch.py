"""Optimizer states across: an optax state from a checkpoint of the JAX
package -> a torch optimizer's state.

The port's checkpoint loader turns optax's state classes into inert objects
that keep their fields (``utils/checkpoint.py``). An optax chain's state is a
tuple of its links' states; :func:`load_optax_state` walks it and takes:

- ``ScaleByAdamState(count, mu, nu)`` -> torch Adam / AdamW ``step``,
  ``exp_avg``, ``exp_avg_sq`` (optax's ``count`` is the updates taken, which
  is torch's ``step``; both then correct the bias by ``1 - b^(count + 1)``);
- ``ScaleByRmsState(nu)``, ``ScaleByRStdDevState(mu, nu)`` (centered) and
  ``TraceState(trace)`` (momentum) -> the port's ``RMSprop`` state of the
  same names;
- ``ScaleByScheduleState(count)`` -> the param groups' ``schedule_count``
  (``optim.set_scheduled_lr``);
- ``EmptyState`` (``clip_by_global_norm``, a constant learning rate, weight
  decay): nothing.

``mu``, ``nu`` and ``trace`` are trees in the Flax layout of the parameters
they follow; ``to_torch`` maps such a tree onto the optimizer's parameters,
in the order its param groups hold them (``flax_to_torch`` does the layout).
Anything else, or a state whose kind does not match the optimizer, raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.optim import RMSprop

Tree = Any
ToTorch = Callable[[Tree], List[torch.Tensor]]


def _links(state: Any) -> Dict[str, tuple]:
    """Class name -> fields of every link state in a (nested) optax chain state."""
    found: Dict[str, tuple] = {}

    def walk(node: Any) -> None:
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
            return
        name = type(node).__name__
        if not hasattr(node, "args") or not type(node).__module__.startswith("inert.optax"):
            raise ValueError(f"not an optax state: {type(node).__module__}.{name}")
        if name == "EmptyState":
            return
        if name in found:
            raise ValueError(f"an optax chain with two {name} links has no torch counterpart")
        found[name] = tuple(node.args)

    walk(state)
    return found


def _check_shapes(params: List[torch.Tensor], values: List[torch.Tensor], what: str) -> None:
    if len(values) != len(params) or any(tuple(v.shape) != tuple(p.shape) for p, v in zip(params, values)):
        raise ValueError(f"the checkpoint's {what} does not match the optimizer's parameters")


def load_optax_state(optimizer: torch.optim.Optimizer, opt_state: Any, to_torch: ToTorch) -> None:
    """Load the optax ``opt_state`` into ``optimizer`` (module docstring)."""
    links = _links(opt_state)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    per_param: Dict[str, List[torch.Tensor]] = {}
    if "ScaleByAdamState" in links:
        if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
            raise ValueError(f"an optax Adam state cannot load into {type(optimizer).__name__}")
        count, mu, nu = links.pop("ScaleByAdamState")
        step = float(np.asarray(count))
        per_param["exp_avg"], per_param["exp_avg_sq"] = to_torch(mu), to_torch(nu)
    elif "ScaleByRmsState" in links or "ScaleByRStdDevState" in links:
        if not isinstance(optimizer, RMSprop):
            raise ValueError(f"an optax RMSprop state cannot load into {type(optimizer).__name__}")
        centered = "ScaleByRStdDevState" in links
        if centered != optimizer.defaults["centered"]:
            raise ValueError("the checkpoint's RMSprop and the optimizer disagree on 'centered'")
        if centered:
            mu, nu = links.pop("ScaleByRStdDevState")
            per_param["mu"] = to_torch(mu)
        else:
            (nu,) = links.pop("ScaleByRmsState")
        per_param["nu"] = to_torch(nu)
        if bool(optimizer.defaults["momentum"]) != ("TraceState" in links):
            raise ValueError("the checkpoint's RMSprop and the optimizer disagree on momentum")
        if "TraceState" in links:
            per_param["trace"] = to_torch(links.pop("TraceState")[0])
    else:
        raise ValueError(f"no Adam or RMSprop state among the optax links {sorted(links)}")
    schedule = links.pop("ScaleByScheduleState", None)
    if links:
        raise ValueError(f"optax states with no torch counterpart: {sorted(links)}")
    for key, values in per_param.items():
        _check_shapes(params, values, key)

    sd = optimizer.state_dict()
    state = {}
    for i in range(len(params)):
        entry = {key: values[i] for key, values in per_param.items()}
        if "exp_avg" in entry:
            entry["step"] = torch.tensor(step, dtype=torch.float32)
        state[i] = entry
    sd["state"] = state
    for group in sd["param_groups"]:
        if schedule is not None:
            group["schedule_count"] = int(np.asarray(schedule[0]))
        else:
            group.pop("schedule_count", None)
    optimizer.load_state_dict(sd)


def is_optax_state(opt_state: Any) -> bool:
    """True when ``opt_state`` came from optax (its links are inert optax objects)."""
    node = opt_state
    while isinstance(node, (tuple, list)) and node:
        node = node[0]
    return type(node).__module__.startswith("inert.optax")


def _to_tensors(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v) for v in tree]
    return tree


def load_optimizer_state(optimizer: torch.optim.Optimizer, opt_state: Any, to_torch: ToTorch) -> None:
    """Load a checkpoint's optimizer state: a torch state dict the port wrote
    (numpy leaves), or an optax state of the JAX package, converted."""
    if is_optax_state(opt_state):
        load_optax_state(optimizer, opt_state, to_torch)
    elif isinstance(opt_state, dict) and "param_groups" in opt_state and "state" in opt_state:
        optimizer.load_state_dict(_to_tensors(opt_state))
    else:
        raise ValueError(f"the checkpoint's optimizer state ({type(opt_state).__name__}) is neither "
                         "a torch state dict nor an optax state")
