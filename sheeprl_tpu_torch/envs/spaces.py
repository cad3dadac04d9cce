"""Small observation/action space classes (the subset of ``gymnasium.spaces`` the
port's environments use: shapes, dtypes, bounds), so the serving path needs no
gymnasium."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


class Space:
    shape: Tuple[int, ...] = ()
    dtype: np.dtype = np.dtype(np.float32)


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32) -> None:
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete(Space):
    def __init__(self, n: int) -> None:
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    def __init__(self, nvec: Sequence[int]) -> None:
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = tuple(self.nvec.shape)
        self.dtype = np.dtype(np.int64)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Dict(Space):
    def __init__(self, spaces: Dict[str, Space]) -> None:
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __setitem__(self, key: str, space: Space) -> None:
        self.spaces[key] = space

    def keys(self) -> Iterable[str]:
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        return f"Dict({self.spaces})"
