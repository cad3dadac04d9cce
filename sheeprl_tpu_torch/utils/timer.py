"""Named-span timing that drives the ``Time/sps_*`` throughput metrics (port of
``sheeprl_tpu/utils/timer.py``).

``timer(name)`` is a context manager and decorator backed by a class-level
registry of accumulating timers; :meth:`timer.to_dict` reduces them at log
time into ``Time/sps_train`` and ``Time/sps_env_interaction``.

The clock is the host's. A span that wraps work on the card measures that
work only where the span's body waits for the card before it exits, and no
span here adds a synchronisation of its own: it ends where the JAX package's
span ends, after the same blocking read. In the port that read is, for
Dreamer-V3's ``Time/train_time``, the host copy of the step's metrics in
``DV3Trainer.train``; for PPO's and A2C's ``Time/train_time``, the copy of the
updated weights into the host-side acting agent at the end of the train
phase (the JAX loops block on the same copy, ``ActPlacement.view``).
``Time/env_interaction_time`` holds host work only (acting runs on the host).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Any, ClassVar, Dict, Optional


class timer(ContextDecorator):
    disabled: ClassVar[bool] = False
    timers: ClassVar[Dict[str, "timer"]] = {}

    def __new__(cls, name: str, **kwargs: Any) -> "timer":
        if name not in cls.timers:
            inst = super().__new__(cls)
            inst._init(name)
            cls.timers[name] = inst
        return cls.timers[name]

    def _init(self, name: str) -> None:
        self.name = name
        self._total = 0.0
        self._count = 0
        self._start: Optional[float] = None

    def __init__(self, name: str, **kwargs: Any) -> None:
        # __new__ keeps the registry; kwargs are accepted as the JAX package does
        pass

    def __enter__(self) -> "timer":
        if not timer.disabled:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if not timer.disabled and self._start is not None:
            self._total += time.perf_counter() - self._start
            self._count += 1
            self._start = None
        return False

    def compute(self) -> float:
        return self._total

    def reset(self) -> None:
        """Zero the totals. A span in flight keeps its start, so its exit still
        counts it into the new window."""
        self._total = 0.0
        self._count = 0

    @classmethod
    def to_dict(cls, reset: bool = True) -> Dict[str, float]:
        out = {name: t.compute() for name, t in cls.timers.items() if t._count > 0}
        if reset:
            for t in cls.timers.values():
                t.reset()
        return out
