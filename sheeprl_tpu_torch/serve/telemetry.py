"""Serving telemetry: the run-telemetry contract, spoken by an inference server.

Port of ``sheeprl_tpu/serve/telemetry.py``: the same events, fields, cadence and
in-loop diagnosis, so the JAX package's ``watch``, ``diagnose``, ``slo`` and
``compare`` read a port's stream. What differs in the port:

- ``compile`` counts the port's kernel-library builds (``nvcc``) and loads
  (``ops/_build.py::build_snapshot``), with their seconds; the port compiles
  no XLA program, and no XLA count is reported;
- ``hbm`` is the CUDA caching allocator's ``allocated_bytes.all`` current and
  peak (``obs/telemetry.py::device_memory``), null on the CPU;
- ``platform``/``device_kind`` are ``gpu`` and the card's name (or ``cpu``);
- the trajectory counters stay 0: trajectory capture is not yet ported.

Nothing here synchronizes the card: a tick's ``step_seconds`` is measured by
the server around a step that ends in its own host copy of the actions.

A serving run writes the same ``telemetry.jsonl`` stream a training run does
(``start`` / ``window`` / ``health`` / ``summary`` events with the stream
identity triple — ``obs/jsonl.py``), so the whole consumer stack works
on it unchanged: ``sheeprl.py watch`` follows it live and exits on its summary,
``sheeprl.py diagnose`` runs the detector catalog over it (including the
serving-specific detectors — occupancy_collapse, latency_regression,
slot_starvation), ``compare``/``bench-diff`` match it by fingerprint.

What differs is the payload: a serving window's unit of progress is one
*served session step* (``sps`` = served slot-steps/sec — the number ``watch``
renders), and each window carries a ``serve`` block:

- ``latency_ms``: p50/p99/mean request latency (submit → action delivered),
- ``occupancy``: mean fraction of slots doing useful work per tick,
- ``sessions``: active / started / finished / **shed** counters + sessions/sec
  and the window's ``shed_rate`` (shed / offered — the overload-protection
  number the ``shed_rate`` detector judges),
- ``queue_depth``: sessions waiting for a free slot (slot starvation signal),
- ``deadline_missed``: requests dropped pre-tick past ``serve.deadline_ms``,
- ``weights``: the hot-reload state — serving ``version``, cumulative
  ``reloads``, ``failures`` (torn/invalid candidates rejected), and the newest
  ``available`` version the reloader has seen (version > available never
  happens; available > version sustained = a stalled reload),
- ``degraded``: whether the widened coalescing window is active,
- ``ticks`` and ``state_bytes`` (the O(S) device session-state footprint),
- ``versions``: the per-weight-version split — latency percentiles, session
  lifecycle counts, deadline misses, and trajectory-plane episode returns keyed
  by the serving weight version active when each request completed (swaps land
  between ticks — ``PolicyServer._loop`` applies pending params at tick START —
  so per-tick attribution is exact). The summary carries the cumulative split;
  the ``promotion`` verdict event (emitted once a hot-reloaded version
  accumulates enough post-swap samples to judge against its predecessor) is the
  hook the canary router gates on,
- ``returns``: window aggregate of captured episode returns (mean / count),
- ``slo``: the error-budget block (``obs/slo.py``) — when objectives are
  declared, every window feeds the in-loop burn-rate evaluator and the stateful
  alert engine (``obs/alerts.py``); transitions land as ``alert`` events and
  critical firing alerts escalate through the existing ``health`` path.

Lifecycle events of the robustness plane (schema-registered in
``obs/schema.py``): ``reload`` (status=applied/rejected/stale with the version
bookkeeping), ``drain`` (status=begin/end with shed/aborted counts), and the
``fault`` events the serving fault plan emits.

Phase attribution reuses the training schema with two serving phases:
``serve_step`` (device program wall time) and ``serve_wait`` (idle, waiting for
client requests) — so ``diagnose``'s unattributed-time invariant holds on a
mostly-idle server too.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from sheeprl_tpu_torch.obs.jsonl import JsonlEventSink
from sheeprl_tpu_torch.obs.telemetry import _rss_bytes, device_memory, rss_peak_bytes
from sheeprl_tpu_torch.ops._build import build_snapshot as compile_snapshot

__all__ = ["ServingTelemetry"]

_HISTORY_CAP = 512
_LATENCY_RESERVOIR = 65536  # bounded overall-latency sample for the summary
_VERSION_RESERVOIR = 8192  # bounded per-version latency sample (promotion spread)
_RETURN_RESERVOIR = 1024  # bounded per-version episode-return sample


def _percentiles(samples) -> Optional[Dict[str, float]]:
    if not len(samples):
        return None
    arr = np.asarray(samples, dtype=np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "mean": round(float(arr.mean()), 3),
        "max": round(float(arr.max()), 3),
    }


def _spread(samples) -> float:
    """Half the p10–p90 span — the noise floor the promotion verdict and the
    version_regression detector require a latency delta to clear."""
    if len(samples) < 2:
        return 0.0
    arr = np.asarray(samples, dtype=np.float64)
    return round(float(np.percentile(arr, 90) - np.percentile(arr, 10)) / 2.0, 3)


def _device_identity(fabric: Any):
    """(platform, device kind) of the serving device, in the JAX package's
    words: ``gpu`` and the card's name, or ``cpu`` and ``cpu``."""
    device = getattr(fabric, "device", None)
    if device is None:
        return None, None
    platform = "gpu" if device.type == "cuda" else str(device.type)
    return platform, str(getattr(fabric, "device_name", platform))


def _slo_cfg_of(cfg: Any) -> Optional[Dict[str, Any]]:
    """``metric.telemetry.slo`` out of whatever config shape the caller holds
    (composed serve cfg, hydra DictConfig, a bare test stub) — None when the
    group is absent; never raises."""
    try:
        metric = cfg.get("metric") if hasattr(cfg, "get") else getattr(cfg, "metric", None)
        telemetry = (
            metric.get("telemetry") if hasattr(metric, "get") else getattr(metric, "telemetry", None)
        )
        slo = (
            telemetry.get("slo")
            if hasattr(telemetry, "get")
            else getattr(telemetry, "slo", None)
        )
        return dict(slo) if slo is not None else None
    except Exception:
        return None


class ServingTelemetry:
    """JSONL stream + live diagnosis for one serving run. The server calls
    :meth:`observe_tick` once per batch tick and :meth:`close` at shutdown;
    windows are emitted every ``every`` served steps."""

    def __init__(
        self,
        fabric: Any,
        cfg: Any,
        log_dir: Optional[str],
        *,
        enabled: bool = True,
        every: int = 256,
        serve_info: Optional[Dict[str, Any]] = None,
        jsonl_path: Optional[str] = None,
        diagnosis: bool = True,
        http_port: Optional[int] = None,
        http_host: str = "127.0.0.1",
        attempt: int = 0,
        rank: int = 0,
        slo: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.every = max(int(every), 1)
        self.diagnosis = bool(diagnosis)
        self._device = getattr(fabric, "device", None)
        self._sink: Optional[JsonlEventSink] = None
        self._history: List[Dict[str, Any]] = []
        self._last_diagnosis_key: Any = None
        # opt-in Prometheus endpoint (metric.telemetry.http_port): the serving
        # window gauges — latency p99, occupancy, sessions/sec, queue depth —
        # scrapeable in place while the server runs; None = no socket at all
        self.metrics_endpoint = None
        if self.enabled and http_port is not None:
            from sheeprl_tpu_torch.obs.metrics_http import build_endpoint

            self.metrics_endpoint = build_endpoint(
                {"http_port": http_port, "http_host": http_host},
                labels={"role": "serve", "algo": str(getattr(cfg.algo, "name", "?"))},
            )

        # cumulative counters
        self._steps = 0
        self._ticks = 0
        self._sessions_started = 0
        self._sessions_finished = 0
        self._sessions_shed = 0
        self._sessions_drained = 0
        self._deadline_missed = 0
        self._sessions_active = 0
        self._queue_depth = 0
        self._state_bytes: Optional[int] = None
        self._peak_hbm = 0
        # robustness-plane state (hot reload / degraded mode / drain)
        self._weight_version = 0
        self._weight_available = 0
        self._reloads = 0
        self._reload_failures = 0
        self._degraded = False
        self._draining = False
        self._drain_info: Optional[Dict[str, Any]] = None
        # per-weight-version split: cumulative + per-window accumulators keyed
        # by the version active when each request completed. Latency reservoirs
        # are bounded (a long-lived version must not grow without bound) —
        # enough samples for stable p50/p99 and the promotion verdict's spread.
        self._versions: Dict[int, Dict[str, Any]] = {}
        self._win_versions: Dict[int, Dict[str, Any]] = {}
        # episode returns by version arrive from the trajectory-ingest plane's
        # client threads — their own maps under _traj_lock, like the counters
        self._ver_returns: Dict[int, deque] = {}
        self._win_ver_returns: Dict[int, List[float]] = {}
        self._win_returns: List[float] = []
        # promotion verdicts: each applied reload anchors a pending judgment
        # (new version vs its predecessor), judged at window cadence once the
        # new version has accumulated enough post-swap samples
        self._pending_promotions: List[Dict[str, Any]] = []
        # SLO plane: objectives resolved from metric.telemetry.slo (catalog
        # defaults + config overrides + per-run slo.yaml), evaluated in-loop
        # at window cadence by the SAME machinery `sheeprl.py slo` replays
        slo_cfg = slo if slo is not None else _slo_cfg_of(cfg)
        self._promotion_min_samples = max(int((slo_cfg or {}).get("promotion_samples") or 32), 1)
        self._slo_evaluator: Any = None
        self._alert_engine: Any = None
        if self.enabled:
            from sheeprl_tpu_torch.obs.alerts import AlertEngine
            from sheeprl_tpu_torch.obs.slo import SloEvaluator, load_objectives

            objectives = load_objectives(slo_cfg, run_dir=log_dir)
            if objectives:
                self._slo_evaluator = SloEvaluator(objectives)
                self._alert_engine = AlertEngine(objectives)
        # trajectory-capture counters (the live flywheel's serve-side ingest:
        # captured = finished sessions that produced transitions, dropped =
        # shed by the bounded ingest queue — the explicit overflow policy)
        self._traj_captured = 0
        self._traj_ingested = 0
        self._traj_dropped = 0
        self._traj_rows = 0
        self._traj_lock = threading.Lock()
        # optional dataflow-lineage provider (ActorDataflow): snapshotted per
        # window so serve windows carry the same role="actor" dataflow block a
        # service-gang actor's do — diagnose/trace consume them unchanged
        self._dataflow: Any = None

        # window accumulators
        self._window_idx = 0
        self._win_steps = 0
        self._win_ticks = 0
        self._win_occupancy_sum = 0.0
        self._win_latencies: List[float] = []
        self._win_step_seconds = 0.0
        self._win_wait_seconds = 0.0
        self._win_queue_sum = 0
        self._win_sessions_started = 0
        self._win_sessions_finished = 0
        self._win_sessions_shed = 0
        self._win_sessions_drained = 0
        self._win_deadline_missed = 0
        self._win_traj_captured = 0
        self._win_traj_ingested = 0
        self._win_traj_dropped = 0
        self._win_traj_rows = 0
        self._all_latencies: deque = deque(maxlen=_LATENCY_RESERVOIR)

        self._start_time = time.perf_counter()
        self._anchor_time = self._start_time
        self._compile_base = {"count": 0, "seconds": 0.0}
        self._compile_last = {"count": 0, "seconds": 0.0}

        if not self.enabled:
            return
        self._compile_base = compile_snapshot()
        self._compile_last = dict(self._compile_base)
        path = jsonl_path or (
            os.path.join(log_dir, "telemetry.jsonl") if log_dir else "telemetry.jsonl"
        )
        self._sink = JsonlEventSink(path, rank=int(rank), attempt=int(attempt))
        from sheeprl_tpu_torch.obs.fingerprint import run_fingerprint

        platform, device_kind = _device_identity(fabric)
        try:
            fingerprint: Optional[Dict[str, Any]] = run_fingerprint(cfg, fabric)
            fingerprint.update(backend=platform, device_kind=device_kind, device_count=1)
        except Exception:
            fingerprint = None
        from sheeprl_tpu_torch.obs.schema import SCHEMA_VERSION

        start_event = dict(
            schema=SCHEMA_VERSION,
            platform=platform,
            device_kind=device_kind,
            world_size=1,
            every=self.every,
            compile_warmup_steps=0,
            serve=dict(serve_info or {}),
            fingerprint=fingerprint,
        )
        self._append_history("start", start_event)
        self._sink.emit("start", step=None, **start_event)

    # -- per-tick hook -------------------------------------------------------------

    def observe_tick(
        self,
        *,
        batch: int,
        slots: int,
        active: int,
        queue_depth: int,
        step_seconds: float,
        wait_seconds: float,
        latencies_ms: Optional[List[float]] = None,
        started: int = 0,
        finished: int = 0,
        shed: int = 0,
        deadline_missed: int = 0,
        state_bytes: Optional[int] = None,
        weight_version: Optional[int] = None,
        degraded: Optional[bool] = None,
    ) -> None:
        """One server tick: ``batch`` sessions stepped out of ``slots`` total
        (``active`` attached), after ``wait_seconds`` of coalescing/idle wait
        and ``step_seconds`` of device program wall time. ``shed`` /
        ``deadline_missed`` are the inter-tick overload-protection deltas;
        ``weight_version``/``degraded`` snapshot the robustness-plane state."""
        if not self.enabled:
            return
        self._ticks += 1
        self._steps += int(batch)
        self._sessions_started += int(started)
        self._sessions_finished += int(finished)
        self._sessions_shed += int(shed)
        self._deadline_missed += int(deadline_missed)
        self._sessions_active = int(active)
        self._queue_depth = int(queue_depth)
        if state_bytes is not None:
            self._state_bytes = int(state_bytes)
        if weight_version is not None:
            self._weight_version = int(weight_version)
        if degraded is not None:
            self._degraded = bool(degraded)

        self._win_ticks += 1
        self._win_steps += int(batch)
        self._win_occupancy_sum += float(batch) / max(int(slots), 1)
        self._win_step_seconds += float(step_seconds)
        self._win_wait_seconds += float(wait_seconds)
        self._win_queue_sum += int(queue_depth)
        self._win_sessions_started += int(started)
        self._win_sessions_finished += int(finished)
        self._win_sessions_shed += int(shed)
        self._win_deadline_missed += int(deadline_missed)
        if latencies_ms:
            self._win_latencies.extend(float(v) for v in latencies_ms)
            self._all_latencies.extend(float(v) for v in latencies_ms)
        # per-version attribution: swaps apply between ticks, so everything
        # this tick carried belongs to the version now serving
        if batch or started or finished or shed or deadline_missed or latencies_ms:
            cum = self._version_slot(self._versions, self._weight_version)
            win = self._version_slot(self._win_versions, self._weight_version)
            for acc in (cum, win):
                acc["steps"] += int(batch)
                acc["started"] += int(started)
                acc["finished"] += int(finished)
                acc["shed"] += int(shed)
                acc["deadline_missed"] += int(deadline_missed)
            if latencies_ms:
                cum["latencies"].extend(float(v) for v in latencies_ms)
                win["latencies"].extend(float(v) for v in latencies_ms)

        if self._win_steps >= self.every:
            self._emit_window()

    def observe_sessions(
        self,
        started: int = 0,
        finished: int = 0,
        shed: int = 0,
        deadline_missed: int = 0,
    ) -> None:
        """Fold session lifecycle deltas that never rode a tick (sessions
        closing after the LAST batch tick — e.g. every session finishing its
        fixed-length episode on the same final step, or requests expiring
        between the final tick and shutdown) into the counters, so the
        summary's ``sessions_finished``/``deadline_missed`` are exact, not
        tick-sampled. The server calls this once from ``close()``."""
        if not self.enabled:
            return
        self._sessions_started += int(started)
        self._sessions_finished += int(finished)
        self._sessions_shed += int(shed)
        self._deadline_missed += int(deadline_missed)
        self._win_sessions_started += int(started)
        self._win_sessions_finished += int(finished)
        self._win_sessions_shed += int(shed)
        self._win_deadline_missed += int(deadline_missed)
        if started or finished or shed or deadline_missed:
            for acc in (
                self._version_slot(self._versions, self._weight_version),
                self._version_slot(self._win_versions, self._weight_version),
            ):
                acc["started"] += int(started)
                acc["finished"] += int(finished)
                acc["shed"] += int(shed)
                acc["deadline_missed"] += int(deadline_missed)

    @staticmethod
    def _version_slot(table: Dict[int, Dict[str, Any]], version: int) -> Dict[str, Any]:
        slot = table.get(int(version))
        if slot is None:
            slot = {
                "steps": 0,
                "started": 0,
                "finished": 0,
                "shed": 0,
                "deadline_missed": 0,
                "latencies": deque(maxlen=_VERSION_RESERVOIR),
            }
            table[int(version)] = slot
        return slot

    def observe_episode(
        self, return_: float, *, version: Optional[int] = None
    ) -> None:
        """One captured episode's return, attributed to the weight version that
        served it (the trajectory-ingest plane calls this from client threads
        at session close — hence the lock). Feeds the window's ``serve.returns``
        aggregate, the per-version split, and the promotion verdict's
        return-regression check."""
        if not self.enabled:
            return
        ver = int(version if version is not None else self._weight_version)
        with self._traj_lock:
            returns = self._ver_returns.get(ver)
            if returns is None:
                returns = self._ver_returns[ver] = deque(maxlen=_RETURN_RESERVOIR)
            returns.append(float(return_))
            self._win_ver_returns.setdefault(ver, []).append(float(return_))
            self._win_returns.append(float(return_))

    def observe_trajectories(
        self,
        *,
        captured: int = 0,
        ingested: int = 0,
        dropped: int = 0,
        rows: int = 0,
    ) -> None:
        """Trajectory-capture deltas from the ingest plane (client/worker
        threads — hence the lock): ``captured`` finished sessions offered,
        ``ingested`` shipped into the experience writer, ``dropped`` shed by
        the bounded queue, ``rows`` transitions shipped."""
        if not self.enabled:
            return
        with self._traj_lock:
            self._traj_captured += int(captured)
            self._traj_ingested += int(ingested)
            self._traj_dropped += int(dropped)
            self._traj_rows += int(rows)
            self._win_traj_captured += int(captured)
            self._win_traj_ingested += int(ingested)
            self._win_traj_dropped += int(dropped)
            self._win_traj_rows += int(rows)

    def attach_dataflow(self, provider: Any) -> None:
        """Attach a dataflow-lineage provider (``ActorDataflow``): every window
        carries its ``dataflow_snapshot()`` — the block diagnose's
        weight_staleness detector and trace's ingest→sample / publish→refresh
        flows consume, identical to a service-gang actor stream's."""
        self._dataflow = provider

    def _dataflow_block(self) -> Optional[Dict[str, Any]]:
        if self._dataflow is None:
            return None
        try:
            return self._dataflow.dataflow_snapshot()
        except Exception:
            return None

    # -- robustness-plane hooks ----------------------------------------------------

    def emit_event(self, event: str, step: Optional[int] = None, **fields: Any) -> None:
        """Raw schema-registered event passthrough (the serving fault plan's
        ``fault`` events ride this, exactly like a training loop's)."""
        if self.enabled and self._sink is not None:
            self._sink.emit(event, step=step if step is not None else self._steps, **fields)

    def observe_reload(
        self,
        *,
        version: Optional[int] = None,
        available: Optional[int] = None,
        failed: bool = False,
        reason: Optional[str] = None,
        source: Optional[str] = None,
        quiet: bool = False,
        timings: Optional[Dict[str, float]] = None,
    ) -> None:
        """Hot-reload bookkeeping: an applied swap (``version``), a newer
        candidate observed (``available``), or a rejected/torn candidate
        (``failed`` + ``reason``). Applied/rejected land as ``reload`` events;
        the rolling state rides every window's ``serve.weights`` block.
        ``quiet`` counts a failure into the gauges without an event — the
        reload thread's dedupe for a persistently failing source. ``timings``
        (the swap's staging and apply milliseconds) ride the applied event."""
        if not self.enabled:
            return
        if available is not None:
            self._weight_available = max(self._weight_available, int(available))
        if failed:
            self._reload_failures += 1
            if quiet:
                return
            self.emit_event(
                "reload",
                status="rejected",
                version=self._weight_version,
                available=self._weight_available,
                reason=str(reason or "invalid checkpoint"),
                **({"source": source} if source else {}),
            )
            return
        if version is not None:
            baseline = self._weight_version
            self._weight_version = int(version)
            self._weight_available = max(self._weight_available, int(version))
            self._reloads += 1
            # anchor a promotion judgment: once the new version accumulates
            # enough post-swap samples, _emit_window compares it against the
            # version it replaced and emits the one-shot `promotion` verdict
            if int(version) != baseline:
                self._pending_promotions.append(
                    {"version": int(version), "baseline": int(baseline)}
                )
            self.emit_event(
                "reload",
                status="applied",
                version=int(version),
                reloads=self._reloads,
                **({"source": source} if source else {}),
                **(timings or {}),
            )

    def observe_degraded(self, enabled: bool) -> None:
        """Degraded-mode transition: the widened coalescing window engaged (or
        cleared) — a health event so `watch` and operators see it live."""
        if not self.enabled:
            return
        self._degraded = bool(enabled)
        self.emit_event(
            "health",
            status="degraded" if enabled else "degraded_cleared",
        )

    def observe_drain(
        self,
        *,
        phase: str,
        shed: int = 0,
        aborted: int = 0,
        grace_s: Optional[float] = None,
    ) -> None:
        """Drain lifecycle: ``begin`` (admissions stopped, queued sessions
        shed) and ``end`` (grace expired / table empty; ``aborted`` sessions
        were still in flight). The summary's ``serve.drain`` block carries the
        final accounting."""
        if not self.enabled:
            return
        if shed:
            # drain-shed sessions were already counted ``started`` at
            # admission — fold them into their own counter, NOT the overload
            # shed that feeds shed_rate's offered denominator (offered =
            # started + shed would double-count them, and a clean wind-down
            # is not the overload signal the shed_rate detector judges)
            self._sessions_drained += int(shed)
            self._win_sessions_drained += int(shed)
        if phase == "begin":
            self._draining = True
            self._drain_info = {"shed": int(shed)}
        else:
            info = self._drain_info or {}
            info.update({"aborted": int(aborted)})
            if grace_s is not None:
                info["grace_s"] = float(grace_s)
            self._drain_info = info
        self.emit_event(
            "drain",
            status=str(phase),
            shed=int(shed),
            aborted=int(aborted),
            **({"grace_s": float(grace_s)} if grace_s is not None else {}),
        )

    # -- window / summary ----------------------------------------------------------

    def _versions_block(
        self,
        table: Dict[int, Dict[str, Any]],
        returns: Dict[int, Any],
    ) -> Optional[Dict[str, Any]]:
        """The per-weight-version split (string keys — JSON object keys), only
        for versions that actually served or returned something."""
        out: Dict[str, Any] = {}
        for ver in sorted(set(table) | set(returns)):
            acc = table.get(ver)
            ver_returns = returns.get(ver)
            if not (acc and acc["steps"]) and not ver_returns:
                continue
            entry: Dict[str, Any] = {}
            if acc:
                entry.update(
                    {
                        "steps": acc["steps"],
                        "latency_ms": _percentiles(acc["latencies"]),
                        "sessions": {
                            "started": acc["started"],
                            "finished": acc["finished"],
                            "shed": acc["shed"],
                        },
                        "deadline_missed": acc["deadline_missed"],
                    }
                )
            if ver_returns:
                entry["returns"] = {
                    "mean": round(float(np.mean(ver_returns)), 4),
                    "n": len(ver_returns),
                }
            out[str(ver)] = entry
        return out or None

    def _serve_block(self, wall: float) -> Dict[str, Any]:
        ticks = max(self._win_ticks, 1)
        with self._traj_lock:
            win_ver_returns = {k: list(v) for k, v in self._win_ver_returns.items()}
            win_returns = list(self._win_returns)
        versions = self._versions_block(self._win_versions, win_ver_returns)
        # shed_rate: shed / offered, where offered = sessions that ASKED for
        # admission this window (started already excludes the shed ones)
        offered = self._win_sessions_started + self._win_sessions_shed
        return {
            **({"versions": versions} if versions else {}),
            **(
                {
                    "returns": {
                        "mean": round(float(np.mean(win_returns)), 4),
                        "n": len(win_returns),
                    }
                }
                if win_returns
                else {}
            ),
            "latency_ms": _percentiles(self._win_latencies),
            "occupancy": round(self._win_occupancy_sum / ticks, 4),
            "sessions": {
                "active": self._sessions_active,
                "started": self._win_sessions_started,
                "finished": self._win_sessions_finished,
                "shed": self._win_sessions_shed,
                "drained": self._win_sessions_drained,
                "per_sec": round(self._win_sessions_finished / wall, 3) if wall > 0 else None,
            },
            "shed_rate": round(self._win_sessions_shed / offered, 4) if offered else 0.0,
            "deadline_missed": self._win_deadline_missed,
            "queue_depth": round(self._win_queue_sum / ticks, 2),
            "weights": {
                "version": self._weight_version,
                "available": self._weight_available,
                "reloads": self._reloads,
                "failures": self._reload_failures,
            },
            "degraded": self._degraded,
            "trajectories": {
                "captured": self._win_traj_captured,
                "ingested": self._win_traj_ingested,
                "dropped": self._win_traj_dropped,
                "rows": self._win_traj_rows,
            },
            "ticks": self._win_ticks,
            "state_bytes": self._state_bytes,
        }

    def _emit_window(self, final: bool = False) -> None:
        now = time.perf_counter()
        wall = max(now - self._anchor_time, 1e-9)
        steps = self._win_steps
        if steps == 0 and final:
            return

        snap = compile_snapshot()
        window_compiles = snap["count"] - self._compile_last["count"]
        window_compile_seconds = snap["seconds"] - self._compile_last["seconds"]
        self._compile_last = dict(snap)

        hbm = device_memory(self._device) if self._device is not None else None
        if hbm and hbm.get("peak_bytes"):
            self._peak_hbm = max(self._peak_hbm, hbm["peak_bytes"])

        # tile the ROUNDED wall exactly: rounding each phase independently can
        # overshoot a sub-millisecond window by a whole 1e-4 quantum (observed:
        # sum 0.0019 vs wall 0.0018 on a fast CPU tick), which breaks the
        # sum(phases) ≈ wall invariant consumers assert — so clamp each rounded
        # phase into the rounded remainder and derive `other` from it
        wall_r = round(wall, 4)
        step_r = min(round(min(self._win_step_seconds, wall), 4), wall_r)
        wait_r = min(round(self._win_wait_seconds, 4), round(wall_r - step_r, 4))
        phases = {
            "serve_step": step_r,
            "serve_wait": max(wait_r, 0.0),
            "other": round(max(wall_r - step_r - max(wait_r, 0.0), 0.0), 4),
        }

        window_event: Dict[str, Any] = dict(
            step=self._steps,
            window=self._window_idx,
            final=bool(final),
            steps=steps,
            wall_seconds=round(wall, 4),
            sps=round(steps / wall, 3),
            serve=self._serve_block(wall),
            phases=phases,
            hbm=hbm,
            rss_bytes=_rss_bytes(),
            rss_peak_bytes=rss_peak_bytes(),
            compile={
                "count": snap["count"] - self._compile_base["count"],
                "seconds": round(snap["seconds"] - self._compile_base["seconds"], 3),
                "window_count": window_compiles,
                "window_seconds": round(window_compile_seconds, 3),
            },
        )
        dataflow = self._dataflow_block()
        if dataflow is not None:
            window_event["dataflow"] = dataflow
        # the in-loop SLO plane: feed THIS window to the burn-rate evaluator,
        # attach the budget block the window carries, and advance the alert
        # engine — identical machinery to `sheeprl.py slo`'s offline replay
        alert_transitions: List[Dict[str, Any]] = []
        slo_snapshot: Dict[str, Any] = {}
        if self._slo_evaluator is not None:
            self._slo_evaluator.observe_window(window_event)
            slo_block = self._slo_evaluator.slo_block()
            if slo_block is not None:
                window_event["slo"] = slo_block
            slo_snapshot = self._slo_evaluator.snapshot()
            alert_transitions = self._alert_engine.evaluate(slo_snapshot)
        self._append_history("window", window_event)
        if self._sink is not None:
            self._sink.emit("window", **window_event)
        # emit through the sink directly: the final window runs after close()
        # already flipped `enabled` off, and its transitions must still land
        for transition in alert_transitions:
            if self._sink is None:
                break
            self._sink.emit("alert", step=self._steps, **transition)
            # critical alerts escalate through the existing health path, so
            # every consumer already watching health sees them without growing
            # an alert-specific ear
            if transition["status"] == "firing" and transition.get("severity") == "critical":
                self._sink.emit(
                    "health",
                    step=self._steps,
                    status="alert",
                    findings=[
                        {
                            "detector": f"slo:{transition['name']}",
                            "severity": "critical",
                            "summary": (
                                f"SLO alert {transition['name']} firing "
                                f"(budget remaining {transition.get('budget_remaining')})"
                            ),
                            "suggestion": "see `sheeprl.py slo` for the budget breakdown",
                        }
                    ],
                )
        self._judge_promotions()
        if self.metrics_endpoint is not None:
            serve_block = window_event["serve"]
            lat = serve_block.get("latency_ms") or {}
            sessions = serve_block.get("sessions") or {}
            gauges = dict(
                {
                    "Perf/sps": window_event["sps"],
                    "Serve/latency_p50_ms": lat.get("p50"),
                    "Serve/latency_p99_ms": lat.get("p99"),
                    "Serve/occupancy": serve_block.get("occupancy"),
                    "Serve/sessions_active": sessions.get("active"),
                    "Serve/sessions_per_sec": sessions.get("per_sec"),
                    "Serve/sessions_shed": sessions.get("shed"),
                    "Serve/shed_rate": serve_block.get("shed_rate"),
                    "Serve/deadline_missed": serve_block.get("deadline_missed"),
                    "Serve/queue_depth": serve_block.get("queue_depth"),
                    "Serve/state_bytes": serve_block.get("state_bytes"),
                    "Serve/weight_version": (serve_block.get("weights") or {}).get("version"),
                    "Serve/reloads": (serve_block.get("weights") or {}).get("reloads"),
                    "Serve/reload_failures": (serve_block.get("weights") or {}).get("failures"),
                    "Serve/degraded": 1.0 if serve_block.get("degraded") else 0.0,
                    "Serve/trajectories_captured": (serve_block.get("trajectories") or {}).get(
                        "captured"
                    ),
                    "Serve/trajectories_dropped": (serve_block.get("trajectories") or {}).get(
                        "dropped"
                    ),
                    "Serve/draining": 1.0 if self._draining else 0.0,
                    "Compile/count": (window_event.get("compile") or {}).get("count"),
                }
            )
            # per-objective budget gauges + ALERTS-style firing gauges: the
            # single replace=True push keeps resolved alerts from lingering
            worst_remaining = None
            for name, stats in slo_snapshot.items():
                if not stats.get("samples"):
                    continue
                remaining = stats.get("budget_remaining")
                gauges[f"Slo/budget_remaining/{name}"] = remaining
                gauges[f"Slo/burn_fast/{name}"] = stats.get("burn_fast")
                if worst_remaining is None or remaining < worst_remaining:
                    worst_remaining = remaining
            if worst_remaining is not None:
                gauges["Slo/worst_budget_remaining"] = worst_remaining
            if self._alert_engine is not None:
                firing = self._alert_engine.firing()
                gauges["Alerts/firing"] = len(firing)
                for name in firing:
                    gauges[f"Alerts/firing/{name}"] = 1.0
            for ver, entry in (serve_block.get("versions") or {}).items():
                ver_lat = entry.get("latency_ms") or {}
                gauges[f"Serve/versions/v{ver}/latency_p50_ms"] = ver_lat.get("p50")
                gauges[f"Serve/versions/v{ver}/latency_p99_ms"] = ver_lat.get("p99")
                gauges[f"Serve/versions/v{ver}/steps"] = entry.get("steps")
                if entry.get("returns"):
                    gauges[f"Serve/versions/v{ver}/return_mean"] = entry["returns"].get("mean")
            self.metrics_endpoint.update(gauges)
        if self.diagnosis:
            self._run_live_diagnosis()

        self._window_idx += 1
        self._win_steps = 0
        self._win_ticks = 0
        self._win_occupancy_sum = 0.0
        self._win_latencies = []
        self._win_step_seconds = 0.0
        self._win_wait_seconds = 0.0
        self._win_queue_sum = 0
        self._win_sessions_started = 0
        self._win_sessions_finished = 0
        self._win_sessions_shed = 0
        self._win_sessions_drained = 0
        self._win_deadline_missed = 0
        self._win_versions = {}
        with self._traj_lock:
            self._win_traj_captured = 0
            self._win_traj_ingested = 0
            self._win_traj_dropped = 0
            self._win_traj_rows = 0
            self._win_ver_returns = {}
            self._win_returns = []
        self._anchor_time = now

    def _judge_promotions(self) -> None:
        """Judge pending reload promotions that accumulated enough post-swap
        samples: the new version regresses when its latency p50 sits beyond
        BOTH versions' spread above the baseline's, or its episode-return mean
        falls beyond both spreads below — one one-shot `promotion` event per
        applied version, the gate the canary router consumes."""
        if not self._pending_promotions:
            return
        still_pending: List[Dict[str, Any]] = []
        for pending in self._pending_promotions:
            version, baseline = pending["version"], pending["baseline"]
            acc = self._versions.get(version)
            samples = acc["steps"] if acc else 0
            if samples < self._promotion_min_samples:
                still_pending.append(pending)
                continue
            base = self._versions.get(baseline)
            with self._traj_lock:
                ver_returns = list(self._ver_returns.get(version) or ())
                base_returns = list(self._ver_returns.get(baseline) or ())
            fields: Dict[str, Any] = {
                "version": version,
                "baseline": baseline,
                "samples": samples,
            }
            regressions = []
            if acc and len(acc["latencies"]):
                lat = _percentiles(acc["latencies"]) or {}
                fields["latency_p50_ms"] = lat.get("p50")
                if base is not None and len(base["latencies"]):
                    base_lat = _percentiles(base["latencies"]) or {}
                    noise = _spread(acc["latencies"]) + _spread(base["latencies"])
                    fields["baseline_latency_p50_ms"] = base_lat.get("p50")
                    fields["latency_spread_ms"] = round(noise, 3)
                    if lat.get("p50", 0.0) > (base_lat.get("p50") or 0.0) + noise:
                        regressions.append("latency")
            if len(ver_returns) >= 4 and len(base_returns) >= 4:
                noise = _spread(ver_returns) + _spread(base_returns)
                mean = float(np.mean(ver_returns))
                base_mean = float(np.mean(base_returns))
                fields["return_mean"] = round(mean, 4)
                fields["baseline_return_mean"] = round(base_mean, 4)
                fields["return_spread"] = round(noise, 4)
                if mean < base_mean - noise:
                    regressions.append("return")
            if base is None or not len(base["latencies"]):
                fields["reason"] = "no baseline samples"
            elif regressions:
                fields["reason"] = "+".join(regressions) + " beyond both versions' spread"
            if self._sink is not None:
                self._sink.emit(
                    "promotion",
                    step=self._steps,
                    status="verdict",
                    verdict="regressed" if regressions else "promote",
                    **fields,
                )
        self._pending_promotions = still_pending

    def close(self, clean_exit: bool = True) -> None:
        """Flush the last partial window and the run summary; idempotent."""
        if not self.enabled:
            return
        self.enabled = False
        if self._win_steps > 0:
            self._emit_window(final=True)
        if self.metrics_endpoint is not None:
            self.metrics_endpoint.close()
            self.metrics_endpoint = None
        if self._sink is None:
            return
        wall = time.perf_counter() - self._start_time
        snap = compile_snapshot()
        hbm = device_memory(self._device) if self._device is not None else None
        peak_hbm = max(self._peak_hbm, (hbm or {}).get("peak_bytes", 0)) or None
        dataflow = self._dataflow_block()
        with self._traj_lock:
            ver_returns = {k: list(v) for k, v in self._ver_returns.items()}
        versions = self._versions_block(self._versions, ver_returns)
        slo_block = (
            self._slo_evaluator.slo_block() if self._slo_evaluator is not None else None
        )
        self._sink.emit(
            "summary",
            step=self._steps,
            **({"dataflow": dataflow} if dataflow is not None else {}),
            **({"slo": slo_block} if slo_block is not None else {}),
            clean_exit=bool(clean_exit),
            windows=self._window_idx,
            total_steps=self._steps,
            wall_seconds=round(wall, 3),
            sps=round(self._steps / wall, 3) if wall > 0 else None,
            serve={
                "latency_ms": _percentiles(self._all_latencies),
                "sessions_started": self._sessions_started,
                "sessions_finished": self._sessions_finished,
                "sessions_shed": self._sessions_shed,
                "sessions_drained": self._sessions_drained,
                "shed_rate": (
                    round(
                        self._sessions_shed
                        / (self._sessions_started + self._sessions_shed),
                        4,
                    )
                    if (self._sessions_started + self._sessions_shed)
                    else 0.0
                ),
                "deadline_missed": self._deadline_missed,
                "sessions_per_sec": round(self._sessions_finished / wall, 3)
                if wall > 0
                else None,
                "weights": {
                    "version": self._weight_version,
                    "available": self._weight_available,
                    "reloads": self._reloads,
                    "failures": self._reload_failures,
                },
                **({"versions": versions} if versions else {}),
                **({"drain": self._drain_info} if self._drain_info else {}),
                "trajectories": {
                    "captured": self._traj_captured,
                    "ingested": self._traj_ingested,
                    "dropped": self._traj_dropped,
                    "rows": self._traj_rows,
                },
                "ticks": self._ticks,
                "state_bytes": self._state_bytes,
            },
            compile={
                "count": snap["count"] - self._compile_base["count"],
                "seconds": round(snap["seconds"] - self._compile_base["seconds"], 3),
            },
            hbm_peak_bytes=peak_hbm,
            rss_peak_bytes=rss_peak_bytes(),
            health="ok",
        )
        self._sink.close()
        self._sink = None

    # -- internals -----------------------------------------------------------------

    def _append_history(self, event: str, payload: Dict[str, Any]) -> None:
        self._history.append({"event": event, "time": round(time.time(), 3), **payload})
        if len(self._history) > _HISTORY_CAP:
            del self._history[: len(self._history) - _HISTORY_CAP]

    def _run_live_diagnosis(self) -> None:
        from sheeprl_tpu_torch.obs.diagnose import run_detectors

        findings = run_detectors(self._history)
        key = tuple(sorted((f["detector"], f["severity"]) for f in findings))
        if findings and key != self._last_diagnosis_key and self._sink is not None:
            self._sink.emit(
                "health",
                step=self._steps,
                status="diagnosis",
                findings=[
                    {k: f[k] for k in ("detector", "severity", "summary", "suggestion")}
                    for f in findings
                ],
            )
        self._last_diagnosis_key = key
