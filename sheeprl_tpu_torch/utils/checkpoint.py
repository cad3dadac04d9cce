"""Checkpoint files shared with the JAX package (port of the pickle half of
``sheeprl_tpu/utils/checkpoint.py``).

A checkpoint is one pickle file of a state dict whose arrays are numpy arrays
(the agent's parameters in the Flax layout, see ``interop/flax_to_torch.py``),
committed by rename and paired with a ``<path>.sha256`` integrity sidecar.

:func:`load_checkpoint` reads files the JAX package wrote without importing
jax, flax or optax: its unpickler admits numpy and a few builtins, maps every
class from ``jax``, ``jaxlib``, ``flax``, ``optax``, ``chex``, ``orbax`` and
``sheeprl_tpu`` (optimizer states, replay buffers) to an inert placeholder, and
refuses anything else but the port's own replay buffers. Of a JAX package's
checkpoint the port uses ``state["agent"]`` only.

:func:`save_run_checkpoint` is the training loop's checkpoint: the replay
buffer rides along with its last rows marked truncated (so a resumed run never
joins an episode across the gap), and only the newest ``keep_last``
checkpoints stay. The loops write it through :func:`write_run_checkpoint`,
which pauses the progress watchdogs and, in a multi-process run, brackets the
write with the step's consistency manifest. The ``ckpt_kill`` fault raises
between the temporary file and its rename (``_fault_hook``).

A memory-mapped buffer is pickled as references to its files (at the exp's
size they hold ~12 GB), so the files belong to the checkpoints once one
refers to them: the live buffer stops owning them (it no longer deletes them
when it is collected), and ``<ckpt>.memmap`` lists them. Rotation deletes a
file when the last kept checkpoint listing it goes. A resumed run reads the
live files with the checkpoint's cursors: rows the old run wrote after the
checkpoint sit at and beyond the cursor and are overwritten as the resumed
run adds rows, so the rows it samples are the checkpoint's unless the old run
went on to write more rows than lay between the cursor and the end of the
ring. :func:`load_run_buffer` marks the newest rows truncated again (the live
run restored their flags in the files after the save).
"""

from __future__ import annotations

import glob
import hashlib
import io
import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

SHA_SIDECAR_SUFFIX = ".sha256"
MEMMAP_SIDECAR_SUFFIX = ".memmap"

# the ckpt_kill fault's hook (resilience/faults.py): called as
# ``hook(stage, path)`` between the temporary write and the rename, where a
# kill leaves the torn ``.tmp`` artifact that discovery skips
_fault_hook: Optional[Callable[[str, str], None]] = None

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
    if _fault_hook is not None:
        _fault_hook("pickle:pre-rename", path)
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


# what a pickled replay buffer of the port holds besides arrays: the buffer
# classes, disk-backed arrays, their paths and numpy's random generators
_PORT_CLASSES = {
    "sheeprl_tpu_torch.data.buffers": (
        "ReplayBuffer", "SequentialReplayBuffer", "EnvIndependentReplayBuffer", "EpisodeBuffer",
    ),
    "sheeprl_tpu_torch.utils.memmap": ("MemmapArray",),
    "pathlib": ("Path", "PosixPath", "PurePosixPath"),
    "numpy.random._pickle": ("__generator_ctor", "__bit_generator_ctor"),
    "numpy.random._pcg64": ("PCG64",),
    "numpy.random.bit_generator": ("__pyx_unpickle_SeedSequence", "SeedSequence"),
}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        root = module.split(".")[0]
        if name in _PORT_CLASSES.get(module, ()):
            return super().find_class(module, name)
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


def _sub_buffers(rb) -> list:
    """An ``EnvIndependentReplayBuffer``'s per-env buffers, or a ``ReplayBuffer``
    itself; none of an ``EpisodeBuffer``, which stores whole episodes only
    and has no newest row to mark."""
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    if isinstance(rb, EpisodeBuffer):
        return []
    return list(rb.buffer) if isinstance(rb.buffer, (list, tuple)) else [rb]


def _mark_last_rows_truncated(rb) -> list:
    """Set terminated and truncated on each sub-buffer's newest row; returns
    the flags they had."""
    saved = []
    for b in _sub_buffers(rb):
        if b.empty:
            saved.append(None)
            continue
        last = (b._pos - 1) % b.buffer_size
        saved.append((b["terminated"][last].copy(), b["truncated"][last].copy()))
        b["terminated"][last] = 1
        b["truncated"][last] = 1
    return saved


def _restore_last_rows(rb, saved: list) -> None:
    for b, flags in zip(_sub_buffers(rb), saved):
        if flags is None:
            continue
        terminated, truncated = flags
        last = (b._pos - 1) % b.buffer_size
        b["terminated"][last] = terminated
        b["truncated"][last] = truncated


def _memmap_files(ckpt: str) -> set:
    try:
        with open(ckpt + MEMMAP_SIDECAR_SUFFIX) as fh:
            return {line.strip() for line in fh if line.strip()}
    except OSError:
        return set()


def _delete_old_checkpoints(folder: str, keep_last: int, live: str) -> None:
    """Keep the newest ``keep_last`` checkpoints of ``folder`` (``live``, the one
    just written, among them); the others go with their sidecars, and so do
    the memmap files that only they listed."""
    if not keep_last:
        return
    live = os.path.abspath(live)
    others = [c for c in sorted(glob.glob(os.path.join(folder, "*.ckpt")), key=os.path.getmtime)
              if os.path.abspath(c) != live]
    n_stale = max(0, len(others) - (keep_last - 1))
    stale, kept = others[:n_stale], others[n_stale:] + [live]
    still_listed = set().union(*(_memmap_files(c) for c in kept))
    orphans = set().union(*(_memmap_files(c) for c in stale)) - still_listed
    for path in [p for c in stale for p in (c, c + SHA_SIDECAR_SUFFIX, c + MEMMAP_SIDECAR_SUFFIX)] + sorted(orphans):
        try:
            os.remove(path)
        except OSError:
            pass


def save_run_checkpoint(path: str, state: Dict[str, Any], replay_buffer=None, keep_last: int = 0) -> None:
    """Write a training checkpoint (``state`` plus ``rb`` when a replay buffer
    is given) and keep the newest ``keep_last`` in its folder (0 keeps all).
    A memory-mapped buffer's files pass to the checkpoints (module docstring)."""
    if replay_buffer is not None:
        from sheeprl_tpu_torch.data.buffers import memmap_arrays

        saved = _mark_last_rows_truncated(replay_buffer)
        try:
            save_checkpoint(path, {**state, "rb": replay_buffer})
        finally:
            _restore_last_rows(replay_buffer, saved)
        arrays = memmap_arrays(replay_buffer)
        if arrays:
            for a in arrays:
                a.has_ownership = False
            tmp = path + MEMMAP_SIDECAR_SUFFIX + ".tmp"
            with open(tmp, "w") as fh:
                fh.writelines(f"{os.path.abspath(a.filename)}\n" for a in arrays)
            os.replace(tmp, path + MEMMAP_SIDECAR_SUFFIX)
    else:
        save_checkpoint(path, state)
    _delete_old_checkpoints(os.path.dirname(path), keep_last, path)


def write_run_checkpoint(path: str, state: Dict[str, Any], replay_buffer=None, keep_last: int = 0,
                         ranks=(0,)) -> None:
    """:func:`save_run_checkpoint` as a training loop writes it: the progress
    watchdogs pause over the write (a long write is progress, not a stall),
    and in a multi-process run the step's consistency manifest brackets it
    (``resilience/distributed.py::checkpoint_manifest``; ``ranks`` share the
    save: the player alone in the decoupled topology)."""
    from sheeprl_tpu_torch.resilience.distributed import checkpoint_manifest
    from sheeprl_tpu_torch.resilience.watchdog import watchdogs_paused

    with watchdogs_paused(), checkpoint_manifest(path, ranks=ranks):
        save_run_checkpoint(path, state, replay_buffer=replay_buffer, keep_last=keep_last)


def load_run_buffer(state: Dict[str, Any]):
    """The replay buffer of a training checkpoint, its newest rows marked
    truncated: a memory-mapped buffer's files hold the flags the live run
    restored after the save."""
    rb = state["rb"]
    _mark_last_rows_truncated(rb)
    return rb
