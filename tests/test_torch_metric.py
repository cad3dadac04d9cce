"""The port's metric plane against the JAX package's: the aggregator, the
timer and the TensorBoard event file.

The aggregator gets the same updates on both sides (host numbers, numpy
arrays, NaNs, and on the port's side the same values as tensors) and must
compute the same dict; the event file must read back through TensorBoard's
own ``EventAccumulator``, every tag, step and value.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from sheeprl_tpu.utils import metric as jax_metric
from sheeprl_tpu_torch.utils import metric

KINDS = ["MeanMetric", "SumMetric", "MaxMetric", "LastValueMetric"]


def _updates(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        if i % 5 == 3:
            out.append(float("nan"))
        elif i % 3 == 0:
            out.append(rng.standard_normal((3, 2)).astype(np.float32))
        else:
            out.append(float(rng.standard_normal()))
    return out


@pytest.mark.parametrize("as_tensor", [False, True], ids=["host", "tensor"])
def test_aggregator_computes_like_the_jax_one(as_tensor):
    """Same updates, same computed dict. Tolerance 1e-6 relative: a tensor's
    mean is taken in float32 on the port's side, numpy's mean of the same
    float32 array in float32 on the JAX side (summed in another order)."""
    ours = metric.MetricAggregator({k: getattr(metric, k)() for k in KINDS})
    theirs = jax_metric.MetricAggregator({k: getattr(jax_metric, k)() for k in KINDS})
    for step, value in enumerate(_updates(0)):
        for k in KINDS:
            theirs.update(k, value)
            ours.update(k, torch.as_tensor(value) if as_tensor else value)
        if step in (5, 11):
            a, b = ours.compute(), theirs.compute()
            assert sorted(a) == sorted(b)
            for k in b:
                assert math.isclose(a[k], b[k], rel_tol=1e-6, abs_tol=1e-7), (k, a[k], b[k])
    ours.reset()
    theirs.reset()
    assert ours.compute() == theirs.compute() == {"SumMetric": 0.0}


def test_aggregator_switches_and_missing_names():
    agg = metric.MetricAggregator({"a": metric.MeanMetric()}, raise_on_missing=True)
    with pytest.raises(KeyError):
        agg.update("b", 1.0)
    loose = metric.MetricAggregator({"a": metric.MeanMetric()})
    loose.update("b", 1.0)  # dropped
    assert "b" not in loose.compute()
    try:
        metric.MetricAggregator.disabled = True
        loose.update("a", 3.0)
        assert loose.compute() == {}
    finally:
        metric.MetricAggregator.disabled = False
    loose.update("a", 3.0)
    assert loose.compute() == {"a": 3.0}
    ranked = metric.RankIndependentMetricAggregator({"a": metric.SumMetric()})
    ranked.update("a", 2.0)
    ranked.update("a", torch.tensor([1.0, 3.0]))
    assert ranked.compute() == [{"a": 4.0}]


def test_tensor_updates_wait_for_compute(monkeypatch):
    """Tensor values stay tensors until compute, which folds them all with one
    stacked copy (the values of every metric in one tensor)."""
    agg = metric.MetricAggregator({"m": metric.MeanMetric(), "s": metric.SumMetric(), "l": metric.LastValueMetric()})
    for v in (1.0, 2.0, 4.0):
        for k in ("m", "s", "l"):
            agg.update(k, torch.tensor(v))
    assert all(len(m._pending) for k, m in agg.metrics.items() if k != "l")
    assert len(agg.metrics["l"]._pending) == 1  # only the newest counts
    stacked = []
    real_stack = torch.stack

    def counting_stack(tensors, *args, **kwargs):
        stacked.append(len(tensors))
        return real_stack(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "stack", counting_stack)
    out = agg.compute()
    monkeypatch.undo()
    assert stacked == [7]
    assert out == {"m": 7.0 / 3.0, "s": 7.0, "l": 4.0}


def test_timer_registry_and_reset():
    from sheeprl_tpu_torch.utils.timer import timer

    timer.to_dict(reset=True)
    with timer("Test/a"):
        pass
    with timer("Test/a"):
        pass

    @timer("Test/b")
    def work():
        return 1

    work()
    assert timer("Test/a") is timer.timers["Test/a"] and timer("Test/a")._count == 2
    out = timer.to_dict(reset=False)
    assert out["Test/a"] >= 0 and "Test/b" in out
    timer.to_dict(reset=True)
    assert "Test/a" not in timer.to_dict()
    try:
        timer.disabled = True
        with timer("Test/c"):
            pass
        assert "Test/c" not in timer.to_dict()
    finally:
        timer.disabled = False


def test_event_file_reads_back_through_tensorboard(tmp_path):
    """Every tag, step and value the logger writes, read by TensorBoard's
    EventAccumulator (values are float32 in the file: exact for these)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.utils.logger import TensorBoardLogger, crc32c

    # the CRC-32C check values of RFC 3720 (B.4) and the usual "123456789"
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    logger = TensorBoardLogger(root_dir=str(tmp_path), name="run")
    written = {}
    for step in (0, 5, 128, 70000):
        metrics = {"Loss/policy_loss": step / 8.0 - 3.25, "Time/sps_train": 1000.5 + step, "Rewards/rew_avg": 22.0}
        logger.log_metrics(metrics, step)
        for k, v in metrics.items():
            written.setdefault(k, []).append((step, v))
    logger.log_metrics({"bad": "not a number"}, 1)
    logger.finalize()
    assert logger.log_dir == str(tmp_path / "run" / "version_0")
    ea = EventAccumulator(logger.log_dir)
    ea.Reload()
    assert sorted(ea.Tags()["scalars"]) == sorted(written)
    for tag, points in written.items():
        assert [(e.step, e.value) for e in ea.Scalars(tag)] == points
