"""Metric aggregation (port of ``sheeprl_tpu/utils/metric.py``).

Named metrics with ``update`` / ``compute`` / ``reset``, a class-level
``disabled`` switch set from ``metric.log_level``, NaN dropping on compute,
and the same reductions as the JAX package: an array's value is its mean.

A value may be a tensor on the card. ``update`` then keeps the tensor (its
mean, still on the card) without waiting for it, and ``compute`` turns every
tensor a :class:`MetricAggregator` holds into host floats with one stacked
copy. Host values (Python or numpy numbers) are folded in at once.

The port runs one process, so ``sync_on_compute`` has nothing to sum over:
every value is this process's own, and :class:`RankIndependentMetricAggregator`
returns a list of one rank's metrics.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def _to_float(value: Any) -> float:
    """A host value's scalar: numbers as they are, arrays by their mean."""
    if isinstance(value, (int, float)):
        return float(value)
    arr = np.asarray(value)
    if arr.size == 0:
        return math.nan
    return float(arr.mean())


def _materialize(metrics: Iterable["Metric"]) -> None:
    """Fold the tensors ``metrics`` hold into host floats: one copy for all."""
    metrics = [m for m in metrics if m._pending]
    if not metrics:
        return
    pending = [t for m in metrics for t in m._pending]
    values = torch.stack([t.to(pending[0].device) for t in pending]).cpu().tolist()
    start = 0
    for m in metrics:
        n = len(m._pending)
        m._pending = []
        for v in values[start : start + n]:
            m._fold(float(v))
        start += n


class Metric:
    """update(value) / compute() -> float / reset(); subclasses fold host floats."""

    def __init__(self, sync_on_compute: bool = False, **_: Any) -> None:
        self.sync_on_compute = sync_on_compute
        self._pending: List[torch.Tensor] = []

    def update(self, value: Any) -> None:
        if isinstance(value, torch.Tensor):
            if value.numel() == 0:
                self._fold(math.nan)
            else:
                self._pending.append(value.detach().float().mean())
        else:
            self._fold(_to_float(value))

    def compute(self) -> float:
        _materialize([self])
        return self._value()

    def reset(self) -> None:
        self._pending = []
        self._clear()

    def _fold(self, v: float) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def _value(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def _clear(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class MeanMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **kwargs: Any) -> None:
        super().__init__(sync_on_compute=sync_on_compute, **kwargs)
        self._clear()

    def _fold(self, v: float) -> None:
        if not math.isnan(v):
            self._total += v
            self._count += 1

    def _value(self) -> float:
        return self._total / self._count if self._count else math.nan

    def _clear(self) -> None:
        self._total = 0.0
        self._count = 0


class SumMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **kwargs: Any) -> None:
        super().__init__(sync_on_compute=sync_on_compute, **kwargs)
        self._clear()

    def _fold(self, v: float) -> None:
        if not math.isnan(v):
            self._total += v

    def _value(self) -> float:
        return self._total

    def _clear(self) -> None:
        self._total = 0.0


class MaxMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **kwargs: Any) -> None:
        super().__init__(sync_on_compute=sync_on_compute, **kwargs)
        self._clear()

    def _fold(self, v: float) -> None:
        if not math.isnan(v):
            self._max = max(self._max, v)

    def _value(self) -> float:
        return self._max if self._max != -math.inf else math.nan

    def _clear(self) -> None:
        self._max = -math.inf


class LastValueMetric(Metric):
    def __init__(self, sync_on_compute: bool = False, **kwargs: Any) -> None:
        super().__init__(sync_on_compute=sync_on_compute, **kwargs)
        self._clear()

    def update(self, value: Any) -> None:
        self._pending = []  # only the newest value counts
        super().update(value)

    def _fold(self, v: float) -> None:
        self._last = v

    def _value(self) -> float:
        return self._last

    def _clear(self) -> None:
        self._last = math.nan


class MetricAggregator:
    """Name -> Metric, with a class-level disable switch and NaN-dropping compute."""

    disabled: bool = False

    def __init__(self, metrics: Optional[Dict[str, Any]] = None, raise_on_missing: bool = False) -> None:
        self.metrics: Dict[str, Metric] = {}
        for name, metric in dict(metrics or {}).items():
            if isinstance(metric, dict) and "_target_" in metric:
                from sheeprl_tpu_torch.config import instantiate

                metric = instantiate(dict(metric))
            self.metrics[name] = metric
        self.raise_on_missing = raise_on_missing

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        metric = self.metrics.get(name)
        if metric is None:
            if self.raise_on_missing:
                raise KeyError(name)
            return
        metric.update(value)

    def compute(self) -> Dict[str, float]:
        if self.disabled:
            return {}
        _materialize(self.metrics.values())
        out: Dict[str, float] = {}
        for name, metric in self.metrics.items():
            value = metric.compute()
            if not math.isnan(value):
                out[name] = value
        return out

    def reset(self) -> None:
        for metric in self.metrics.values():
            metric.reset()


class RankIndependentMetricAggregator:
    """Per-rank metrics, gathered at compute: one rank's here."""

    def __init__(self, metrics: Dict[str, Metric]) -> None:
        self.aggregator = MetricAggregator(metrics)

    def update(self, name: str, value: Any) -> None:
        self.aggregator.update(name, value)

    def compute(self) -> List[Dict[str, float]]:
        return [self.aggregator.compute()]

    def reset(self) -> None:
        self.aggregator.reset()
