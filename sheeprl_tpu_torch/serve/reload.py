"""Hot weight reload: a long-lived server picks up newer weights, in place
(port of ``sheeprl_tpu/serve/reload.py``).

A reload thread polls a weight source, validates the candidate against the
serving module's layout, stages it on the serving device and hands it to
:meth:`~sheeprl_tpu_torch.serve.server.PolicyServer.update_params`; the tick
loop swaps it in between ticks. The swap changes the weights the step reads and
nothing else: the carries, the generators and the slot map stay.

How the weights move, and why no tick reads a half-copied or freed tensor:

1. The source loads the checkpoint's ``agent`` tree (numpy leaves in the Flax
   layout, written by either package) on the reload thread.
2. :func:`params_aval_mismatch` compares the tree with the serving module's
   layout, leaf by leaf: the same names, shapes and dtypes. Another preset's
   tree (S weights offered to an M server) is rejected here.
3. :class:`WeightStager` copies the tree into a host shadow of the serving
   module, whose tensors live in pinned memory, and from there into fresh device
   tensors on a side stream; the reload thread then waits for the side stream's
   event. The tick thread never waits on staging.
4. At the swap, on the tick thread and under the server's lock, the tick's
   stream waits on that event (already complete) and copies the staged tensors
   into the module's parameters and buffers in place, so their pointers stay
   stable. The previous tick ended in a host copy of its actions, so no earlier
   launch still reads the old weights; every later launch follows the copy in
   stream order. Each staged tensor is marked as used by the tick's stream
   (``record_stream``), so the allocator does not hand its memory out before
   the copy has read it.

On the CPU steps 3-4 are plain copies. At bf16 the parameters stay float32 and
are cast where they are used; no bf16 copy of a weight outlives a tick, so the
swap has nothing else to refresh.

Safety: a candidate that fails integrity validation (torn file, sha mismatch,
unpicklable payload) or whose layout does not match is rejected; the old
weights keep serving and a ``reload`` event with ``status=rejected`` is written
(``serve.weights.failures`` counts it). The ``reload_torn`` fault tears the next
candidate on disk to exercise that path. The fleet weight plane's
``SubscriberReloadSource`` is not yet ported.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CheckpointReloadSource",
    "ReloadRejected",
    "StagedWeights",
    "WeightReloader",
    "WeightStager",
    "params_aval_mismatch",
]


class ReloadRejected(RuntimeError):
    """A reload candidate failed validation; the old weights keep serving."""


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key in sorted(tree, key=str):
            out.update(_flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
        return out
    return {prefix: tree}


def tree_layout(tree: Any) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """``{leaf path: (shape, dtype)}`` of a params tree (nested dicts of arrays)."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = leaf if hasattr(leaf, "dtype") and hasattr(leaf, "shape") else np.asarray(leaf)
        out[path] = (tuple(int(d) for d in arr.shape), np.dtype(arr.dtype))
    return out


def params_aval_mismatch(current: Dict[str, Tuple[Tuple[int, ...], np.dtype]], candidate: Any) -> Optional[str]:
    """None when the ``candidate`` tree has exactly the layout ``current``
    (a :func:`tree_layout`) describes: the same leaf names, shapes and dtypes;
    otherwise a description of the first mismatch. A changed layout is another
    model (a resized preset, a wrong checkpoint) and is rejected."""
    try:
        cand = tree_layout(candidate)
    except Exception as exc:  # not a tree of arrays
        return f"candidate is not a params tree: {exc!r}"
    missing = sorted(set(current) - set(cand))
    extra = sorted(set(cand) - set(current))
    if missing or extra:
        return f"params tree structure changed: missing {missing[:4]}, unexpected {extra[:4]}"
    for path, (shape, dtype) in current.items():
        c_shape, c_dtype = cand[path]
        if c_shape != shape:
            return f"leaf {path} shape changed: {c_shape} != {shape}"
        if c_dtype != dtype:
            return f"leaf {path} dtype changed: {c_dtype} != {dtype}"
    return None


class StagedWeights:
    """Candidate weights on the serving device, keyed by the serving module's
    ``state_dict`` names, ready for :meth:`apply`."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event: Optional[Any], stage_ms: float) -> None:
        self.tensors = tensors
        self.event = event
        self.stage_ms = float(stage_ms)

    def apply(self, module: torch.nn.Module) -> None:
        """Copy into ``module``'s parameters and buffers in place (the tick
        thread, between ticks; see the module docstring)."""
        targets = module.state_dict(keep_vars=True)
        names = list(self.tensors)
        dst = [targets[n].data for n in names]
        src = [self.tensors[n] for n in names]
        cuda = dst[0].device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(dst[0].device)
            if self.event is not None:
                stream.wait_event(self.event)
        with torch.no_grad():
            torch._foreach_copy_(dst, src)
        if cuda:
            for t in src:
                t.record_stream(stream)
        self.tensors = {}


class WeightStager:
    """Validate and stage candidate trees for one serving policy: a host shadow
    of its module (pinned on a card) and a side stream for the copies."""

    def __init__(self, policy: Any) -> None:
        if policy.module is None or policy.load_params is None or policy.params_tree is None:
            raise NotImplementedError(f"hot reload of a {policy.algo} serving policy is not ported")
        self.policy = policy
        self.device = policy.device
        shadow = copy.deepcopy(policy.module).to("cpu")
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            # the shadow's storage is pinned once, so each candidate lands in
            # pinned memory directly and copies to the card asynchronously
            for t in list(shadow.parameters()) + list(shadow.buffers()):
                t.data = t.data.pin_memory()
            self.stream = torch.cuda.Stream(self.device)
            # the first launch of torch's multi-tensor copy loads its kernel
            # module (CUDA's lazy loading), which on an H100 host took far
            # longer than the copy; load it here, before serving, and not on
            # the tick thread under the server's lock
            warm = [torch.zeros(1, device=self.device, dtype=t.dtype) for t in policy.module.state_dict().values()]
            torch._foreach_copy_(warm, [t.clone() for t in warm])
            torch.cuda.synchronize(self.device)
        self.shadow = shadow
        self.layout = tree_layout(policy.params_tree(shadow))
        served = policy.module.state_dict()
        self.names = [n for n in shadow.state_dict() if n in served]

    def stage(self, tree: Any) -> StagedWeights:
        """Load ``tree`` (already validated) into the shadow and copy it onto
        the serving device; returns when the copies are done."""
        t0 = time.perf_counter()
        with torch.no_grad():
            self.policy.load_params(self.shadow, tree)
        host = self.shadow.state_dict()
        served = self.policy.module.state_dict()
        event = None
        if self.cuda:
            with torch.cuda.stream(self.stream):
                staged = {
                    n: torch.empty(served[n].shape, dtype=served[n].dtype, device=self.device).copy_(
                        host[n], non_blocking=True
                    )
                    for n in self.names
                }
            event = torch.cuda.Event()
            event.record(self.stream)
            event.synchronize()  # the reload thread waits; the tick thread never does
        else:
            staged = {n: host[n].detach().to(served[n].dtype).clone() for n in self.names}
        return StagedWeights(staged, event, (time.perf_counter() - t0) * 1000.0)


class CheckpointReloadSource:
    """Follow the newest valid checkpoint under a directory. Versions are this
    source's own counter (one per newly loaded path); the checkpoint the server
    booted from never re-applies as version 1."""

    name = "checkpoint"

    def __init__(self, watch_dir: str, current_path: Optional[str] = None) -> None:
        self.watch_dir = str(watch_dir)
        self._last_path = os.path.abspath(current_path) if current_path else None
        self._version = 0
        # peek_available() and poll() run back to back: share one scan
        self._scan: Optional[Tuple[Optional[str]]] = None

    def peek_available(self) -> Optional[int]:
        """The source's next version when a newer valid path resolves, else
        the current one."""
        from sheeprl_tpu_torch.resilience.discovery import find_latest_checkpoint

        newest = find_latest_checkpoint(self.watch_dir)
        self._scan = (newest,)
        if newest is not None and os.path.abspath(newest) != self._last_path:
            return self._version + 1
        return self._version

    def poll(self) -> Optional[Tuple[Any, int, Dict[str, Any]]]:
        """``(agent tree, version, meta)`` when a new valid checkpoint
        resolved, None when nothing newer exists. Raises
        :class:`ReloadRejected` for a torn or unloadable candidate."""
        from sheeprl_tpu_torch.resilience import faults
        from sheeprl_tpu_torch.resilience.discovery import (
            checkpoint_step,
            find_latest_checkpoint,
            is_valid_checkpoint,
        )
        from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

        scan, self._scan = self._scan, None
        newest = scan[0] if scan is not None else find_latest_checkpoint(self.watch_dir)
        if newest is None or os.path.abspath(newest) == self._last_path:
            return None
        if faults.consume_reload_torn():
            _tear_checkpoint(newest)
            if not is_valid_checkpoint(newest):
                raise ReloadRejected(f"torn checkpoint rejected by integrity validation: {newest}")
        try:
            state = load_checkpoint(newest)
            tree = state["agent"]
        except Exception as exc:
            raise ReloadRejected(f"checkpoint {newest} failed to load: {exc!r}") from exc
        self._last_path = os.path.abspath(newest)
        self._version += 1
        return tree, self._version, {"path": newest, "checkpoint_step": checkpoint_step(newest)}


def _tear_checkpoint(path: str) -> None:
    """Truncate ``path`` to half, as a kill in mid-write would leave it."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
    except OSError:
        pass


class WeightReloader:
    """The reload thread: poll the source every ``poll_s``, validate, stage on
    the serving device, hand to the server. Telemetry rides
    :class:`~sheeprl_tpu_torch.serve.telemetry.ServingTelemetry`."""

    def __init__(self, server: Any, source: Any, *, telemetry: Any = None, poll_s: float = 2.0) -> None:
        self.server = server
        self.source = source
        self.telemetry = telemetry
        self.poll_s = max(float(poll_s), 0.05)
        self.stager = WeightStager(server.policy)
        self.failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WeightReloader":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="sheeprl-serve-reload", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _run(self) -> None:
        last_reason: Optional[str] = None
        while not self._stop.wait(self.poll_s):
            try:
                self.step()
                last_reason = None
            except Exception as exc:
                # never take the server down, but leave a trail: a repeat of
                # the same failure bumps the counter without another event
                reason = f"{type(exc).__name__}: {exc}"
                self.failures += 1
                if self.telemetry is not None:
                    self.telemetry.observe_reload(
                        failed=True, reason=reason, source=self.source.name, quiet=(reason == last_reason)
                    )
                last_reason = reason

    def _reject(self, reason: str) -> None:
        self.failures += 1
        if self.telemetry is not None:
            self.telemetry.observe_reload(failed=True, reason=reason, source=self.source.name)

    def step(self) -> Optional[int]:
        """One poll (tests drive it directly): the staged version on success,
        None when there was nothing new or the candidate was rejected."""
        from sheeprl_tpu_torch.serve.server import ServerClosed

        try:
            available = self.source.peek_available()
        except Exception:
            available = None
        if available and self.telemetry is not None:
            self.telemetry.observe_reload(available=int(available))
        try:
            candidate = self.source.poll()
        except ReloadRejected as exc:
            self._reject(str(exc))
            return None
        if candidate is None:
            return None
        tree, version, _meta = candidate
        mismatch = params_aval_mismatch(self.stager.layout, tree)
        if mismatch is not None:
            self._reject(f"aval mismatch: {mismatch}")
            return None
        staged = self.stager.stage(tree)
        try:
            self.server.update_params(staged, version)
        except ServerClosed:
            return None
        return int(version)
