"""Host-side replay buffers (a copy of the ``ReplayBuffer``,
``SequentialReplayBuffer`` and ``EnvIndependentReplayBuffer`` of
``sheeprl_tpu/data/buffers.py``; numpy only).

The same ``(T, B, *)`` dict-of-numpy semantics: circular wrap-around writes,
uniform and contiguous-sequence sampling, one sub-buffer per env with ragged
cursors. Sampling draws from the same numpy generator calls, in the same
order, so two buffers seeded alike sample the same indices. ``sample_tensors``
lands a sample on a torch device.

Storage is plain numpy or ``MemmapArray`` (disk-backed) per key.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from sheeprl_tpu_torch.utils.memmap import MemmapArray

_VALID_MEMMAP_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


def _first(data: Dict[str, np.ndarray]) -> np.ndarray:
    return next(iter(data.values()))


def _validate_add_data(data: Any) -> None:
    if not isinstance(data, dict):
        raise ValueError(f"'data' must be a dictionary of numpy arrays, got {type(data)}")
    ref_key, ref_shape = None, None
    for k, v in data.items():
        if not isinstance(v, np.ndarray):
            raise ValueError(f"'data' values must be numpy arrays; key {k!r} has type {type(v)}")
        if v.ndim < 2:
            raise RuntimeError(
                f"'data' arrays must be [sequence_length, n_envs, ...]; shape of {k!r} is {v.shape}"
            )
        if ref_shape is not None and v.shape[:2] != ref_shape:
            raise RuntimeError(
                "every array in 'data' must agree on the first two dims: "
                f"{ref_key!r} has {ref_shape}, {k!r} has {v.shape[:2]}"
            )
        ref_key, ref_shape = k, v.shape[:2]



def get_tensor(array: np.ndarray | MemmapArray, dtype: Any = None, clone: bool = False, device: Any = "cpu"):
    """Host numpy -> torch tensor on ``device``."""
    if isinstance(array, MemmapArray):
        array = array.array
    if clone:
        array = np.array(array)
    if dtype is not None:
        array = np.asarray(array, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(array)).to(device)


class ReplayBuffer:
    """Circular ``(buffer_size, n_envs, *)`` dict-of-numpy buffer (reference
    sheeprl/data/buffers.py:20-360)."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: str | os.PathLike | None = None,
        memmap_mode: str = "r+",
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = memmap
        self._memmap_dir = memmap_dir
        self._memmap_mode = memmap_mode
        self._buf: Dict[str, np.ndarray | MemmapArray] = {}
        if self._memmap:
            if self._memmap_mode not in _VALID_MEMMAP_MODES:
                raise ValueError(f"memmap_mode must be one of {_VALID_MEMMAP_MODES}")
            if self._memmap_dir is None:
                raise ValueError(
                    "The buffer is memory-mapped but 'memmap_dir' is None; set it to a directory."
                )
            self._memmap_dir = Path(self._memmap_dir)
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._pos = 0
        self._full = False
        self._rng: np.random.Generator = np.random.default_rng()

    # -- properties ------------------------------------------------------------------

    @property
    def buffer(self) -> Dict[str, np.ndarray]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._full

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return not self._buf

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    def __len__(self) -> int:
        return self._buffer_size

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)

    # -- serialization ---------------------------------------------------------------

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        if self._memmap:
            # the pickle refers to the files: what it refers to must be on disk
            for v in self._buf.values():
                v.flush()
        elif not self._full:
            # The capacity beyond the write cursor is uninitialized garbage;
            # pickling it writes buffer_size rows regardless of fill (observed:
            # a 60 GB checkpoint for a 320-step run with the default 5M-capacity
            # Dreamer buffer). Persist only the filled prefix; restore
            # reallocates the full capacity. Memmap buffers already serialize as
            # file references.
            state["_buf"] = {k: v[: self._pos].copy() for k, v in self._buf.items()}
            state["_truncated_to_pos"] = True
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        truncated = state.pop("_truncated_to_pos", False)
        self.__dict__.update(state)
        if truncated:
            head = self._buf
            self._buf = {}
            for k, v in head.items():
                full = np.empty((self._buffer_size, self._n_envs, *v.shape[2:]), dtype=v.dtype)
                full[: self._pos] = v
                self._buf[k] = full

    # -- write path ------------------------------------------------------------------

    def _allocate(self, key: str, value: np.ndarray) -> None:
        shape = (self._buffer_size, self._n_envs, *value.shape[2:])
        if self._memmap:
            self._buf[key] = MemmapArray(
                filename=Path(self._memmap_dir) / f"{key}.memmap",
                dtype=value.dtype,
                shape=shape,
                mode=self._memmap_mode,
            )
        else:
            self._buf[key] = np.empty(shape, dtype=value.dtype)

    def add(self, data: "ReplayBuffer" | Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Write a ``[steps, n_envs, ...]`` block at the cursor with wrap-around;
        oversize blocks keep only their trailing ``buffer_size`` rows."""
        if isinstance(data, ReplayBuffer):
            data = data.buffer
        if validate_args:
            _validate_add_data(data)
        data_len = _first(data).shape[0]
        if data_len > self._buffer_size:
            data = {k: v[-self._buffer_size :] for k, v in data.items()}
            data_len = self._buffer_size
        next_pos = (self._pos + data_len) % self._buffer_size
        idxes = (np.arange(self._pos, self._pos + data_len) % self._buffer_size).astype(np.intp)
        if self.empty:
            for k, v in data.items():
                self._allocate(k, v)
        for k, v in data.items():
            self._buf[k][idxes] = v
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = next_pos

    # -- read path -------------------------------------------------------------------

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        """Uniform sample → ``[n_samples, batch_size, ...]``. With ``sample_next_obs``
        the row at the write head is excluded (its successor is invalid)."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(
                f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0"
            )
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer; call add() first")
        if self._full:
            first_range_end = self._pos - 1 if sample_next_obs else self._pos
            second_range_end = (
                self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            )
            valid = np.concatenate(
                [np.arange(0, max(first_range_end, 0)), np.arange(self._pos, second_range_end)]
            ).astype(np.intp)
            batch_idxes = valid[self._rng.integers(0, len(valid), size=(batch_size * n_samples,))]
        else:
            max_pos = self._pos - 1 if sample_next_obs else self._pos
            if max_pos == 0:
                raise RuntimeError(
                    "sample_next_obs requires at least two samples in the buffer"
                )
            batch_idxes = self._rng.integers(0, max_pos, size=(batch_size * n_samples,), dtype=np.intp)
        samples = self._get_samples(batch_idxes, sample_next_obs=sample_next_obs, clone=clone)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in samples.items()}

    def _get_samples(
        self, batch_idxes: np.ndarray, sample_next_obs: bool = False, clone: bool = False
    ) -> Dict[str, np.ndarray]:
        """One fancy-gather per key into a preallocated output dict. The gather
        always materializes fresh rows (never a view of the ring storage), so
        ``clone`` is satisfied for free — no second copy is ever taken."""
        if self.empty:
            raise RuntimeError("The buffer has not been initialized; add some data first")
        n = len(batch_idxes)
        env_idxes = self._rng.integers(0, self._n_envs, size=(n,), dtype=np.intp)
        flat = batch_idxes * self._n_envs + env_idxes
        if sample_next_obs:
            flat_next = ((batch_idxes + 1) % self._buffer_size) * self._n_envs + env_idxes
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            v2 = np.reshape(np.asarray(v), (-1, *v.shape[2:]))
            dst = np.empty((n, *v2.shape[1:]), dtype=v2.dtype)
            np.take(v2, flat, axis=0, out=dst)
            out[k] = dst
            if sample_next_obs and k in self._obs_keys:
                dst_next = np.empty_like(dst)
                np.take(v2, flat_next, axis=0, out=dst_next)
                out[f"next_{k}"] = dst_next
        return out

    def sample_tensors(
        self,
        batch_size: int,
        clone: bool = False,
        sample_next_obs: bool = False,
        dtype: Any = None,
        device: Any = "cpu",
        from_numpy: bool = False,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        """Sample and land on ``device`` as torch tensors."""
        n_samples = kwargs.pop("n_samples", 1)
        samples = self.sample(
            batch_size=batch_size, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs
        )
        return {k: get_tensor(v, dtype=dtype, clone=False, device=device) for k, v in samples.items()}

    def to_tensor(self, dtype: Any = None, clone: bool = False, device: Any = "cpu", from_numpy: bool = False):
        return {k: get_tensor(v, dtype=dtype, clone=clone, device=device) for k, v in self._buf.items()}

    # -- dict access -----------------------------------------------------------------

    def __getitem__(self, key: str) -> np.ndarray | MemmapArray:
        if not isinstance(key, str):
            raise TypeError("'key' must be a string")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized; add some data first")
        return self._buf.get(key)

    def __setitem__(self, key: str, value: np.ndarray | MemmapArray) -> None:
        if not isinstance(value, (np.ndarray, MemmapArray)):
            raise ValueError(f"value must be np.ndarray or MemmapArray, got {type(value)}")
        if value.shape[:2] != (self._buffer_size, self._n_envs):
            raise RuntimeError(
                f"'value' must be [buffer_size, n_envs, ...]; got shape {value.shape}"
            )
        if self._memmap:
            filename = value.filename if isinstance(value, MemmapArray) else Path(self._memmap_dir) / f"{key}.memmap"
            self._buf[key] = MemmapArray.from_array(value, filename=filename, mode=self._memmap_mode)
        else:
            self._buf[key] = np.copy(np.asarray(value))


class SequentialReplayBuffer(ReplayBuffer):
    """Contiguous-sequence sampling → ``[n_samples, sequence_length, batch_size, ...]``
    (reference buffers.py:363-526); each sequence comes from a single env and never
    straddles the write head."""

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        batch_dim = batch_size * n_samples
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(
                f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0"
            )
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer; call add() first")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(
                f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}"
            )
        if self._full and sequence_length > len(self):
            raise ValueError(
                f"The sequence length ({sequence_length}) is greater than the buffer size ({len(self)})"
            )
        if self._full:
            first_range_end = self._pos - sequence_length + 1
            second_range_end = (
                self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            )
            valid = np.concatenate(
                [np.arange(0, max(first_range_end, 0)), np.arange(self._pos, second_range_end)]
            ).astype(np.intp)
            start_idxes = valid[self._rng.integers(0, len(valid), size=(batch_dim,))]
        else:
            start_idxes = self._rng.integers(0, self._pos - sequence_length + 1, size=(batch_dim,), dtype=np.intp)
        chunk = np.arange(sequence_length, dtype=np.intp)[None, :]
        idxes = (start_idxes[:, None] + chunk) % self._buffer_size
        return self._get_sequence_samples(
            idxes, batch_size, n_samples, sequence_length, sample_next_obs=sample_next_obs, clone=clone
        )

    def _get_sequence_samples(
        self,
        batch_idxes: np.ndarray,
        batch_size: int,
        n_samples: int,
        sequence_length: int,
        sample_next_obs: bool = False,
        clone: bool = False,
    ) -> Dict[str, np.ndarray]:
        flat_batch_idxes = batch_idxes.reshape(-1)
        n_rows = batch_size * n_samples
        if self._n_envs == 1:
            env_idxes = np.zeros((n_rows * sequence_length,), dtype=np.intp)
        else:
            env_idxes = self._rng.integers(0, self._n_envs, size=(n_rows,), dtype=np.intp)
            env_idxes = np.repeat(env_idxes, sequence_length)
        flat = flat_batch_idxes * self._n_envs + env_idxes
        # the fancy gather materializes fresh rows, so `clone` needs no extra copy
        # (the swapaxes result is a view of the gathered copy, not of the ring)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            v2 = np.reshape(np.asarray(v), (-1, *v.shape[2:]))
            picked = v2[flat]
            batched = picked.reshape(n_samples, batch_size, sequence_length, *picked.shape[1:])
            out[k] = np.swapaxes(batched, 1, 2)
            if sample_next_obs and k in self._obs_keys:
                picked_next = np.asarray(v)[(flat_batch_idxes + 1) % self._buffer_size, env_idxes]
                batched_next = picked_next.reshape(
                    n_samples, batch_size, sequence_length, *picked_next.shape[1:]
                )
                out[f"next_{k}"] = np.swapaxes(batched_next, 1, 2)
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per env with ragged cursors (reference buffers.py:529-743):
    needed when per-env episode alignment matters (Dreamer-V3)."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: str | os.PathLike | None = None,
        memmap_mode: str = "r+",
        buffer_cls: Type[ReplayBuffer] = ReplayBuffer,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap:
            if memmap_mode not in _VALID_MEMMAP_MODES:
                raise ValueError(f"memmap_mode must be one of {_VALID_MEMMAP_MODES}")
            if memmap_dir is None:
                raise ValueError("The buffer is memory-mapped but 'memmap_dir' is None")
            memmap_dir = Path(memmap_dir)
            memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: List[ReplayBuffer] = [
            buffer_cls(
                buffer_size=buffer_size,
                n_envs=1,
                obs_keys=obs_keys,
                memmap=memmap,
                memmap_dir=memmap_dir / f"env_{i}" if memmap else None,
                memmap_mode=memmap_mode,
                **kwargs,
            )
            for i in range(n_envs)
        ]
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._rng: np.random.Generator = np.random.default_rng()
        self._concat_along_axis = buffer_cls.batch_axis

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return tuple(self._buf)

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> Sequence[bool]:
        return tuple(b.full for b in self._buf)

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> Sequence[bool]:
        return tuple(b.empty for b in self._buf)

    @property
    def is_memmap(self) -> Sequence[bool]:
        return tuple(b.is_memmap for b in self._buf)

    def __len__(self) -> int:
        return self._buffer_size

    def seed(self, seed: Optional[int]) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def add(
        self,
        data: "ReplayBuffer" | Dict[str, np.ndarray],
        indices: Optional[Sequence[int]] = None,
        validate_args: bool = False,
    ) -> None:
        if isinstance(data, ReplayBuffer):
            data = data.buffer
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != _first(data).shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must equal the second dim of "
                f"'data' ({_first(data).shape[1]})"
            )
        for data_idx, env_idx in enumerate(indices):
            env_data = {k: v[:, data_idx : data_idx + 1] for k, v in data.items()}
            self._buf[env_idx].add(env_data, validate_args=validate_args)

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(
                f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0"
            )
        bs_per_buf = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)))
        per_buf = [
            b.sample(batch_size=bs, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs)
            for b, bs in zip(self._buf, bs_per_buf)
            if bs > 0
        ]
        # sub-samples are already fresh gathers: a single-env draw needs no copy at
        # all, and multi-env draws concatenate once per key into a preallocated dst
        if len(per_buf) == 1:
            return per_buf[0]
        axis = self._concat_along_axis
        out: Dict[str, np.ndarray] = {}
        for k in per_buf[0]:
            parts = [s[k] for s in per_buf]
            shape = list(parts[0].shape)
            shape[axis] = sum(p.shape[axis] for p in parts)
            dst = np.empty(shape, dtype=parts[0].dtype)
            np.concatenate(parts, axis=axis, out=dst)
            out[k] = dst
        return out

    def sample_tensors(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        dtype: Any = None,
        device: Any = "cpu",
        from_numpy: bool = False,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        samples = self.sample(
            batch_size=batch_size, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs
        )
        return {k: get_tensor(v, dtype=dtype, device=device) for k, v in samples.items()}


def memmap_arrays(rb: Any) -> List[MemmapArray]:
    """The disk-backed arrays of a ``ReplayBuffer`` or an ``EnvIndependentReplayBuffer``."""
    buffers = rb.buffer if isinstance(rb, EnvIndependentReplayBuffer) else (rb,)
    return [v for b in buffers for v in b.buffer.values() if isinstance(v, MemmapArray)]
