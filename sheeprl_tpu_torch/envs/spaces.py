"""Small observation/action space classes (the subset of ``gymnasium.spaces`` the
port's environments use: shapes, dtypes, bounds, uniform sampling), so the port
needs no gymnasium."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


class Space:
    shape: Tuple[int, ...] = ()
    dtype: np.dtype = np.dtype(np.float32)

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError(f"{type(self).__name__}.sample")


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32) -> None:
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """Uniform over the bounds (both must be finite)."""
        return rng.uniform(self.low, self.high).astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Discrete(Space):
    def __init__(self, n: int) -> None:
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def sample(self, rng: np.random.Generator) -> np.int64:
        return np.int64(rng.integers(self.n))

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    def __init__(self, nvec: Sequence[int]) -> None:
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = tuple(self.nvec.shape)
        self.dtype = np.dtype(np.int64)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.integers(self.nvec).astype(self.dtype)

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


def action_space_dims(action_space: Space) -> Tuple[Tuple[int, ...], bool]:
    """(actions_dim, is_continuous) of a Box / Discrete / MultiDiscrete space."""
    if isinstance(action_space, Box):
        return tuple(int(s) for s in action_space.shape), True
    if isinstance(action_space, MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec.tolist()), False
    if isinstance(action_space, Discrete):
        return (int(action_space.n),), False
    raise NotImplementedError(f"action space {action_space!r} is not supported")


def env_actions(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """A policy's concatenated actions as the env takes them: continuous
    values as they are, one index per one-hot block otherwise."""
    if is_continuous:
        return actions
    splits = np.cumsum(actions_dim)[:-1]
    return np.stack([b.argmax(-1) for b in np.split(actions, splits, axis=-1)], axis=-1)
