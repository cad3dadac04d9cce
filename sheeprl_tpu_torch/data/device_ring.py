"""The replay ring on the device (port of ``sheeprl_tpu/data/device_ring.py``,
``buffer.backend=device``).

The ring is a dict ``{"data": {key: [capacity, n_envs, ...]}, "pos": int,
"fill": int}`` whose tensors live on one device. ``pos`` and ``fill`` depend
only on how many rows were written, so they are host integers: a write or a
sample never reads the card back.

- :func:`ring_write` appends a ``[T, n_envs, ...]`` block at the cursor with
  wraparound, in place: at most two contiguous slice copies a key (a block
  longer than the ring keeps its trailing ``capacity`` rows, written from
  ``pos``), so it stays deterministic under ``torch.use_deterministic_algorithms``;
- :func:`ring_sample` draws ``[n_samples, batch, ...]`` uniformly over the
  filled region through the Feistel permutation of ``utils/prp.py``: the
  draw's ``i``-th slot is ``perm[i % slots]``, folded into the filled region
  by ``% (max(fill, 1) * n_envs)``, then one ``index_select`` a key. The 8
  round keys are an argument (the JAX function draws them from its key), and
  only the drawn entries of the permutation are computed.

:class:`DeviceRingSampler` is the ``make_replay_sampler`` surface over the
ring (``add``, ``sample``, ``note_writes``, ``telemetry_snapshot``), with a
host :class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer` as its durability
twin: :meth:`~DeviceRingSampler.sync_to_host` snapshots the ring into it for
a checkpoint (``_pos`` and ``_full`` from the cursor and fill) and
:meth:`~DeviceRingSampler.restore_from_host` lands it back on the device.
:func:`buffer_from_jax_state` rebuilds a JAX package's pickled buffer (an
inert object in the port's unpickler) as the port's, for a resume.

``capacity * n_envs`` (the slot count) must be a power of two, the Feistel
permutation's domain: :func:`ring_capacity` rounds a transition budget up to
such a row count.

Not ported: the multi-device sharding of the ring (the port's Fabric runs on
one device).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.prp import draw_round_keys, prp_map

__all__ = [
    "DeviceRingSampler",
    "buffer_from_jax_state",
    "buffer_to_ring",
    "ring_capacity",
    "ring_init",
    "ring_sample",
    "ring_to_buffer",
    "ring_write",
]

Ring = Dict[str, Any]


def _next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def ring_capacity(size: int, n_envs: int) -> int:
    """Rows per env for a total transition budget of ``size``: at least
    ``ceil(size / n_envs)``, rounded up so ``capacity * n_envs`` is a power of
    two. ``n_envs`` itself must be a power of two."""
    if n_envs < 1 or (n_envs & (n_envs - 1)):
        raise ValueError(
            f"buffer.backend=device needs a power-of-two env count, got {n_envs}; "
            "the Feistel sampler permutes capacity*n_envs slots and a bijection "
            "needs a power-of-two domain (see howto/device_replay.md)"
        )
    rows = -(-int(size) // int(n_envs))  # ceil
    return max(_next_pow2(rows * n_envs) // n_envs, 1)


def _check_slots(capacity: int, n_envs: int) -> None:
    slots = int(capacity) * int(n_envs)
    if slots < 2 or (slots & (slots - 1)):
        raise ValueError(
            f"device ring needs a power-of-two slot count (capacity*n_envs), got "
            f"{capacity}*{n_envs}={slots}; use ring_capacity() to round the budget up"
        )


def ring_init(capacity: int, n_envs: int, row_specs: Mapping[str, Tuple[Tuple[int, ...], Any]], device) -> Ring:
    """An empty ring on ``device``: ``row_specs`` maps key -> (per-env
    trailing shape, dtype)."""
    _check_slots(capacity, n_envs)
    data = {
        k: torch.zeros((int(capacity), int(n_envs), *shape), dtype=dtype, device=device)
        for k, (shape, dtype) in row_specs.items()
    }
    return {"data": data, "pos": 0, "fill": 0}


def ring_write(ring: Ring, rows: Mapping[str, torch.Tensor]) -> Ring:
    """Append a ``[T, n_envs, ...]`` block of every key at the cursor, in
    place, and advance ``pos`` and ``fill``; returns the ring. A block longer
    than the ring keeps its trailing ``capacity`` rows (the host
    ``ReplayBuffer.add``'s overwrite)."""
    data = ring["data"]
    steps = int(next(iter(rows.values())).shape[0])
    capacity = int(next(iter(data.values())).shape[0])
    if steps > capacity:
        rows = {k: v[-capacity:] for k, v in rows.items()}
        steps = capacity
    pos = int(ring["pos"])
    head = min(steps, capacity - pos)
    for k, buf in data.items():
        src = rows[k]
        buf[pos : pos + head].copy_(src[:head])
        if head < steps:
            buf[: steps - head].copy_(src[head:])
    ring["pos"] = (pos + steps) % capacity
    ring["fill"] = min(int(ring["fill"]) + steps, capacity)
    return ring


def ring_sample(ring: Ring, round_keys: torch.Tensor, batch_size: int, n_samples: int = 1) -> Dict[str, torch.Tensor]:
    """A uniform ``[n_samples, batch_size, ...]`` draw over the filled region
    from the Feistel permutation of all ``capacity * n_envs`` slots under
    ``round_keys`` (8, on the ring's device): its first ``n_samples *
    batch_size`` entries (wrapping around it when the draw is larger), each
    folded into the filled region by a modulo. On a full ring the draw is
    without replacement."""
    data = ring["data"]
    ref = next(iter(data.values()))
    capacity, n_envs = int(ref.shape[0]), int(ref.shape[1])
    slots = capacity * n_envs
    n = int(n_samples) * int(batch_size)
    if n <= 0:
        raise ValueError(f"n_samples*batch_size must be > 0, got {n}")
    draw = torch.arange(n, dtype=torch.int64, device=ref.device)
    if n > slots:
        draw = draw % slots
    flat_idx = prp_map(slots, draw, round_keys.to(ref.device))
    # the filled slots are the first fill*n_envs of the row-major layout:
    # before the first wrap pos == fill (a prefix of rows), after it all
    valid = max(int(ring["fill"]), 1) * n_envs
    if valid < slots:
        flat_idx = flat_idx % valid
    return {
        k: v.reshape(slots, *v.shape[2:]).index_select(0, flat_idx).reshape(int(n_samples), int(batch_size),
                                                                            *v.shape[2:])
        for k, v in data.items()
    }


def ring_to_buffer(ring: Ring, rb: Optional[Any] = None) -> Any:
    """Snapshot the ring into a host ``ReplayBuffer`` (one copy to the host a
    key), the cursor onto ``rb._pos`` and a full ring onto ``rb._full``."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    data = {k: np.array(v.detach().cpu()) for k, v in ring["data"].items()}
    ref = next(iter(data.values()))
    capacity, n_envs = int(ref.shape[0]), int(ref.shape[1])
    if rb is None:
        rb = ReplayBuffer(capacity, n_envs, obs_keys=("observations",), memmap=False)
    rb._buf = data
    rb._pos = int(ring["pos"])
    rb._full = int(ring["fill"]) >= capacity
    return rb


def buffer_to_ring(rb: Any, device) -> Ring:
    """A host ``ReplayBuffer`` snapshot on ``device`` as a ring (copied: the
    ring's writes never touch the twin), cursor and fill intact."""
    data = {k: torch.tensor(np.asarray(v), device=device) for k, v in rb.buffer.items()}
    capacity = int(rb.buffer_size)
    fill = capacity if rb.full else int(rb._pos)
    return {"data": data, "pos": int(rb._pos) % capacity, "fill": fill}


def buffer_from_jax_state(state: Mapping[str, Any]) -> Any:
    """The port's ``ReplayBuffer`` of a JAX package's pickled one: its
    ``__getstate__`` dict (``_buf``, only the ``[:_pos]`` prefix while it is
    not full; ``_pos``, ``_full``, ``_buffer_size``, ``_n_envs``). Only an
    in-memory buffer (the JAX ``sac_anakin`` twin) is read."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    size, n_envs = int(state["_buffer_size"]), int(state["_n_envs"])
    rb = ReplayBuffer(size, n_envs, obs_keys=("observations",), memmap=False)
    for k, v in state["_buf"].items():
        if not isinstance(v, np.ndarray):
            raise NotImplementedError(
                f"the JAX replay buffer's {k!r} is a {type(v).__name__}: only in-memory buffers are read"
            )
        full = np.zeros((size, n_envs, *v.shape[2:]), dtype=v.dtype)
        full[: v.shape[0]] = v
        rb._buf[k] = full
    rb._pos, rb._full = int(state["_pos"]), bool(state["_full"])
    return rb


class DeviceRingSampler:
    """``buffer.backend=device`` behind the ``make_replay_sampler`` surface.

    The storage is the ring on ``device``; the wrapped host ``ReplayBuffer``
    is only the durability twin. ``add``/``sample`` write and draw through
    the ring functions (for tests and loops that do not fuse them); the
    ``sac_anakin`` loop writes and samples :attr:`ring` itself and calls
    :meth:`note_writes`. ``sample`` draws its round keys from the sampler's
    own ``torch.Generator`` on the device, seeded with ``seed``.
    """

    def __init__(
        self, rb: Any, sample_kwargs: Optional[Mapping[str, Any]] = None, device: Any = "cpu", seed: int = 0
    ) -> None:
        self._rb = rb
        kwargs = dict(sample_kwargs or {})
        kwargs.pop("n_samples", None)
        if kwargs.pop("sample_next_obs", False):
            raise ValueError(
                "buffer.backend=device stores next_observations explicitly; "
                "sample_next_obs=True is a host-replay feature (buffer.sample_next_obs=False)"
            )
        self._batch_size = int(kwargs.pop("batch_size"))
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.ring: Optional[Ring] = None
        self._tele_wait_seconds = 0.0
        self._tele_sample_calls = 0
        self._tele_units = 0
        self._tele_rows_written = 0
        if not rb.empty:
            # a restored (resumed) buffer lands on the device at once
            self.ring = buffer_to_ring(rb, self.device)

    @property
    def buffer(self) -> Any:
        return self._rb

    def add(self, data: Mapping[str, Any]) -> None:
        """Write a ``[T, n_envs, ...]`` block (numpy arrays or tensors); the
        first block sizes the ring at the twin's capacity."""
        rows = {k: torch.as_tensor(v, device=self.device) for k, v in data.items()}
        if self.ring is None:
            first = next(iter(rows.values()))
            specs = {k: (tuple(v.shape[2:]), v.dtype) for k, v in rows.items()}
            self.ring = ring_init(self._rb.buffer_size, int(first.shape[1]), specs, self.device)
        self.note_writes(int(next(iter(rows.values())).shape[0]))
        ring_write(self.ring, rows)

    def note_writes(self, steps: int) -> None:
        """Count ``steps`` ring rows written (the overwrite gauge); host
        bookkeeping only."""
        self._tele_rows_written += max(int(steps), 0)

    def sample(self, n_samples: int) -> Dict[str, torch.Tensor]:
        if self.ring is None:
            raise RuntimeError("No sample has been added to the device ring; call add() first")
        t0 = time.perf_counter()
        round_keys = draw_round_keys(1, self.generator, self.device)[0]
        block = ring_sample(self.ring, round_keys, self._batch_size, int(n_samples))
        self._tele_wait_seconds += time.perf_counter() - t0
        self._tele_sample_calls += 1
        self._tele_units += int(n_samples)
        return block

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """The host samplers' schema plus the ring's gauges: ``ring_fill`` and
        ``ring_capacity`` (rows) and ``ring_overwritten`` (slots written past
        capacity x envs). Host integers: no device read."""
        snap = {
            "is_async": False,
            "wait_seconds": self._tele_wait_seconds,
            "sample_calls": self._tele_sample_calls,
            "units": self._tele_units,
            "occupancy_sum": 0.0,
            "staleness_sum": 0.0,
            "empty_waits": 0,
            "pipeline_len": 0,
            "depth": 0,
            "ring_fill": 0,
            "ring_capacity": 0,
            "ring_overwritten": 0,
        }
        if self.ring is not None:
            ref = next(iter(self.ring["data"].values()))
            capacity, n_envs = int(ref.shape[0]), int(ref.shape[1])
            snap["ring_fill"] = int(self.ring["fill"])
            snap["ring_capacity"] = capacity
            snap["ring_overwritten"] = max(self._tele_rows_written - capacity, 0) * n_envs
        return snap

    def close(self) -> None:
        pass

    def __enter__(self) -> "DeviceRingSampler":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def sync_to_host(self) -> Any:
        """Snapshot the ring into the twin (checkpoint cadence); returns it."""
        if self.ring is not None:
            ring_to_buffer(self.ring, self._rb)
        return self._rb

    def restore_from_host(self) -> None:
        """Land the twin's snapshot back on the device (the resume path)."""
        if not self._rb.empty:
            self.ring = buffer_to_ring(self._rb, self.device)
