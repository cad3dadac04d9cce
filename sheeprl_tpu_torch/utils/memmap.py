"""Memory-mapped numpy arrays with file ownership and spawn-safe pickling (a
copy of ``sheeprl_tpu/utils/memmap.py``; numpy only).

A disk-backed array container that can cross process boundaries (pickled as
metadata, re-opened on the other side without taking ownership), so replay
buffers larger than RAM can back the host side of the input pipeline.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_VALID_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


class MemmapArray(np.lib.mixins.NDArrayOperatorsMixin):
    def __init__(
        self,
        shape: int | Tuple[int, ...],
        dtype: Any = None,
        mode: str = "r+",
        reset: bool = False,
        filename: str | os.PathLike | None = None,
    ):
        if mode not in _VALID_MODES:
            raise ValueError(f"mode must be one of {_VALID_MODES}, got {mode!r}")
        if filename is None:
            fd, path = tempfile.mkstemp(".memmap")
            os.close(fd)
            self._filename = Path(path).resolve()
        else:
            path = Path(filename).resolve()
            if path.exists():
                warnings.warn(
                    "The specified filename already exists; modifications may be reflected.",
                    category=UserWarning,
                )
            path.parent.mkdir(parents=True, exist_ok=True)
            path.touch(exist_ok=True)
            self._filename = path
        self._dtype = np.dtype(dtype) if dtype is not None else None
        self._shape = tuple(shape) if not isinstance(shape, int) else (shape,)
        self._mode = mode
        self._array: np.memmap | None = np.memmap(
            filename=self._filename, dtype=self._dtype, shape=self._shape, mode=self._mode
        )
        if reset:
            self._array[:] = 0
        self._has_ownership = True

    # -- properties -----------------------------------------------------------------

    @property
    def filename(self) -> Path:
        return self._filename

    @property
    def dtype(self) -> Any:
        return self._dtype

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    @property
    def array(self) -> np.memmap:
        if self._array is None:
            self._array = np.memmap(
                filename=self._filename, dtype=self._dtype, shape=self._shape, mode=self._mode
            )
        return self._array

    @array.setter
    def array(self, value: np.ndarray | "MemmapArray") -> None:
        if isinstance(value, MemmapArray):
            # ownership transfer: point at the other file, stealing ownership
            if os.path.abspath(value.filename) != os.path.abspath(self._filename):
                self.__del__()
                self._filename = value.filename
                self._dtype = value.dtype
                self._shape = value.shape
                self._mode = value.mode
                self._array = None
            value.has_ownership = False
            self._has_ownership = True
        else:
            value = np.asarray(value)
            if value.shape != self._shape:
                raise ValueError(f"shape mismatch: {value.shape} vs {self._shape}")
            self.array[:] = value

    # -- construction ----------------------------------------------------------------

    @classmethod
    def from_array(
        cls,
        array: np.ndarray | "MemmapArray",
        mode: str = "r+",
        filename: str | os.PathLike | None = None,
    ) -> "MemmapArray":
        is_memmap = isinstance(array, MemmapArray)
        source = array.array if is_memmap else np.asarray(array)
        same_file = (
            is_memmap
            and filename is not None
            and os.path.abspath(filename) == os.path.abspath(array.filename)
        )
        out = cls(shape=source.shape, dtype=source.dtype, mode=mode, filename=filename)
        if same_file:
            array.has_ownership = False
        else:
            out.array[:] = source[:]
            out.array.flush()
        return out

    # -- numpy interop ---------------------------------------------------------------

    def __array__(self, dtype: Any = None) -> np.ndarray:
        arr = self.array
        return np.asarray(arr, dtype=dtype) if dtype is not None else np.asarray(arr)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(np.asarray(i.array) if isinstance(i, MemmapArray) else i for i in inputs)
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __len__(self) -> int:
        return self._shape[0]

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    def reshape(self, *shape: int) -> np.ndarray:
        return self.array.reshape(*shape)

    def flush(self) -> None:
        if self._array is not None:
            self._array.flush()

    # -- pickling across process boundaries (spawn-safe) -----------------------------

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_array"] = None
        # the receiving process must never delete the file
        state["_has_ownership"] = False
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def __del__(self) -> None:
        try:
            if getattr(self, "_has_ownership", False) and self._array is not None:
                self._array.flush()
            if getattr(self, "_has_ownership", False) and getattr(self, "_filename", None) is not None:
                self._array = None
                if os.path.isfile(self._filename):
                    os.unlink(self._filename)
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, mode={self._mode}, filename={self._filename})"
