"""Checkpoint files shared with the JAX package (port of the pickle half of
``sheeprl_tpu/utils/checkpoint.py``).

A checkpoint is one pickle file of a state dict whose arrays are numpy arrays
(the agent's parameters in the Flax layout, see ``interop/flax_to_torch.py``),
committed by rename and paired with a ``<path>.sha256`` integrity sidecar.

:func:`load_checkpoint` reads files the JAX package wrote without importing
jax, flax or optax: its unpickler admits numpy and a few builtins, maps every
class from ``jax``, ``jaxlib``, ``flax``, ``optax``, ``chex``, ``orbax`` and
``sheeprl_tpu`` (optimizer states, replay buffers) to an inert placeholder, and
refuses anything else. Only ``state["agent"]`` is used by the port.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

SHA_SIDECAR_SUFFIX = ".sha256"

# modules whose classes load as placeholders (their objects are not used)
_INERT_MODULES = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "ml_dtypes", "sheeprl_tpu")
_BUILTINS = frozenset(
    {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex", "bool", "str",
     "bytes", "bytearray", "slice", "range", "object"}
)


def sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def write_sha_sidecar(path: str) -> None:
    sidecar = path + SHA_SIDECAR_SUFFIX
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(sha256_file(path) + "\n")
    os.replace(tmp, sidecar)


def verify_sha_sidecar(path: str) -> Optional[bool]:
    """True/False when ``<path>.sha256`` exists and matches/differs; None when
    there is no sidecar."""
    sidecar = path + SHA_SIDECAR_SUFFIX
    if not os.path.isfile(sidecar):
        return None
    try:
        with open(sidecar) as fh:
            expected = fh.read().strip().split()[0]
        return sha256_file(path) == expected
    except (OSError, IndexError):
        return False


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Pickle ``state`` (tensors become numpy arrays) to ``path`` atomically and
    write its sha256 sidecar."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(state), f, protocol=pickle.HIGHEST_PROTOCOL)
    # a stale sidecar must never outlive the file it described
    try:
        os.remove(path + SHA_SIDECAR_SUFFIX)
    except OSError:
        pass
    os.replace(tmp, path)
    write_sha_sidecar(path)


class InertObject:
    """Stands in for an object of a JAX-side class: accepts any construction and
    state, and remembers them, but has no behaviour."""

    def __new__(cls, *args: Any, **kwargs: Any):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __setstate__(self, state: Any) -> None:
        self.state = state


def _inert_class(module: str, name: str) -> type:
    return type(name, (InertObject,), {"__module__": f"inert.{module}"})


def _numpy_admitted(module: str, name: str) -> bool:
    """Arrays, dtypes and scalars — nothing of numpy that does I/O or runs code."""
    if module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        return name in ("_reconstruct", "scalar")
    if module in ("numpy.core.numeric", "numpy._core.numeric"):
        return name == "_frombuffer"
    if module == "numpy.dtypes":
        return True
    if module == "numpy":
        obj = getattr(np, name, None)
        return name in ("dtype", "ndarray") or (isinstance(obj, type) and issubclass(obj, np.generic))
    return False


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        root = module.split(".")[0]
        if root == "numpy" and _numpy_admitted(module, name):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        if root in _INERT_MODULES:
            return _inert_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, which is not admitted")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a pickle checkpoint of either package (see the module docstring)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a sharded (orbax directory) checkpoint; only pickle files are ported"
        )
    with open(path, "rb") as f:
        data = f.read()
    return _CheckpointUnpickler(io.BytesIO(data)).load()
