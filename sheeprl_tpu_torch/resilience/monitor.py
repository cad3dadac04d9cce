"""The per-run resilience facade every training loop drives (port of
``sheeprl_tpu/resilience/monitor.py``).

One instance per run (:func:`build_resilience`, from the ``resilience`` config
group), four hooks, each a cheap no-op when the feature is off:

- ``step(policy_step)``: once an iteration. Feeds the progress watchdog, fires
  a due injected fault, steps the coordinator of a multi-process run (and
  raises ``RankFailureError`` for a dead peer), and emits the one-shot
  ``preempt`` event. Host integers only: it reads no device value.
- ``preempt_requested()``: the poll the loops fold into their checkpoint
  condition (the emergency checkpoint) and their ``break``; in a
  multi-process run the gang's agreed verdict.
- ``observe_checkpoint(ckpt_path, policy_step, preempted)``: after each
  checkpoint write: a ``checkpoint`` event and a watchdog feed.
- ``finalize(policy_step)``: at the loop's end, gating the final test: stops
  the watchdog and the coordinator, emits ``preempt_exit``, returns whether
  the run was preempted.

The port's training loops have no telemetry stream yet, so the events go to a
lazy ``telemetry.jsonl`` sink (``obs/jsonl.py``): critical events (preempt,
stall, fault, rank death) always open it, every lifecycle event does when the
supervisor is on, and an uneventful run leaves no file.
``metric.telemetry.jsonl_path`` pins it (the supervisors pin the run base's,
so that every attempt writes one ordered stream); a peer process writes
``telemetry.rank{r}.jsonl`` beside it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

from sheeprl_tpu_torch.obs.jsonl import JsonlEventSink
from sheeprl_tpu_torch.resilience import signals
from sheeprl_tpu_torch.resilience.distributed import build_coordinator
from sheeprl_tpu_torch.resilience.faults import build_fault_plan
from sheeprl_tpu_torch.resilience.watchdog import ProgressWatchdog, stop_all_watchdogs


class NullResilience:
    """The disabled facade: the loops never branch on whether resilience is on."""

    enabled = False

    def step(self, policy_step: int) -> None:
        pass

    def preempt_requested(self) -> bool:
        return False

    def observe_checkpoint(self, ckpt_path: str, policy_step: int, preempted: Optional[bool] = None) -> None:
        pass

    def finalize(self, policy_step: Optional[int] = None) -> bool:
        return False


class _Sink:
    """The lazy JSONL sink of a facade: opened by the first event it takes."""

    def __init__(self, path: Optional[str], rank: int, attempt: int, enabled: bool) -> None:
        self.path = path
        self.rank = rank
        self.attempt = attempt
        self.enabled = enabled and path is not None
        self.lock = threading.Lock()
        self.sink: Optional[JsonlEventSink] = None

    def emit(self, event: str, step: Optional[int] = None, **fields: Any) -> None:
        with self.lock:
            if self.sink is None:
                if not self.enabled:
                    return
                try:
                    self.sink = JsonlEventSink(self.path, rank=self.rank, attempt=self.attempt)
                except OSError:
                    return
            self.sink.emit(event, step=step, **fields)

    def close(self) -> None:
        with self.lock:
            if self.sink is not None:
                self.sink.close()
                self.sink = None


def _telemetry_cfg(cfg: Any) -> Any:
    return (cfg.get("metric") or {}).get("telemetry") or {}


class PeerResilience(NullResilience):
    """The facade of a process other than rank 0 (a decoupled learner
    process): heartbeats and peer-failure detection through the coordinator
    (a dead peer raises ``RankFailureError`` from :meth:`step`), faults aimed
    at its rank, and its local SIGTERM published as a request, so that the
    player's coordinator turns it into the agreed stop step. Critical events
    go to ``telemetry.rank{r}.jsonl``."""

    enabled = True

    def __init__(self, cfg: Any, log_dir: Optional[str] = None, rank: int = 1) -> None:
        rcfg = cfg.get("resilience") or {}
        tcfg = _telemetry_cfg(cfg)
        self._rank = int(rank)
        self._fault = build_fault_plan(rcfg, process_rank=self._rank)
        self._preempt_seen = False
        self._sink = _Sink(_rank_stream_path(tcfg.get("jsonl_path"), log_dir, self._rank), self._rank,
                           int(tcfg.get("attempt") or 0), bool(tcfg.get("jsonl", True)))
        self._coord = build_coordinator(cfg, rank=self._rank, emit=self._emit_critical)

    def step(self, policy_step: int) -> None:
        if self._fault is not None:
            self._fault.maybe_fire(policy_step, self._emit_critical)
        local = signals.local_preemption_requested()
        if local and not self._preempt_seen:
            self._preempt_seen = True
            self._emit_critical("preempt", step=policy_step, signum=signals.preempt_signum(), rank=self._rank)
        if self._coord is not None:
            self._coord.step(policy_step, local_preempt=local)
            self._coord.check_abort()  # a dead peer: tear down, do not hang

    def preempt_requested(self) -> bool:
        if self._coord is not None:
            return self._coord.preempt_requested()
        return signals.preemption_requested()

    def finalize(self, policy_step: Optional[int] = None) -> bool:
        preempted = self.preempt_requested() or signals.preemption_requested()
        if self._coord is not None:
            self._coord.close()
            self._coord = None
        self._sink.close()
        return preempted

    def _emit_critical(self, event: str, step: Optional[int] = None, critical: bool = True, **fields: Any) -> None:
        self._sink.emit(event, step=step, **fields)


def _rank_stream_path(jsonl_path: Any, log_dir: Optional[str], rank: int) -> Optional[str]:
    """A peer's own stream, ``telemetry.rank{r}.jsonl`` beside the primary one
    (never the primary file: its sequence counter is per process)."""
    if jsonl_path:
        root, ext = os.path.splitext(str(jsonl_path))
        return f"{root}.rank{rank}{ext or '.jsonl'}"
    if log_dir:
        return os.path.join(str(log_dir), f"telemetry.rank{rank}.jsonl")
    return None


class ResilienceMonitor:
    """Rank 0's facade; see the module docstring for its hooks. Build it with
    :func:`build_resilience`."""

    enabled = True

    def __init__(self, cfg: Any, log_dir: Optional[str], rank: int = 0) -> None:
        # an earlier in-process attempt that died on an exception path never
        # ran finalize(): stop its watchdog first (an orphaned abort-mode one
        # would os._exit the healthy restarted run)
        stop_all_watchdogs()
        rcfg = cfg.get("resilience") or {}
        tcfg = _telemetry_cfg(cfg)
        self._rank = int(rank)
        self._fault = build_fault_plan(rcfg, process_rank=self._rank)
        self._preempt_seen = False
        path = str(tcfg.get("jsonl_path") or (f"{log_dir}/telemetry.jsonl" if log_dir else "telemetry.jsonl"))
        self._sink = _Sink(path, self._rank, int(tcfg.get("attempt") or 0), bool(tcfg.get("jsonl", True)))
        # with the supervisor on every lifecycle event is recorded; otherwise
        # only critical events open the sink
        self._eager = bool((rcfg.get("supervisor") or {}).get("enabled", False))

        wcfg = rcfg.get("watchdog") or {}
        self.watchdog: Optional[ProgressWatchdog] = None
        if bool(wcfg.get("enabled", False)):
            self.watchdog = ProgressWatchdog(
                float(wcfg.get("timeout") or 300.0),
                lambda event, **fields: self._emit(event, critical=True, **fields),
                abort=bool(wcfg.get("abort", False)),
                grace=float(wcfg.get("grace") or 30.0),
            ).start()

        # a multi-process run gets the control plane (None for one process)
        self._coord = build_coordinator(cfg, rank=self._rank, emit=lambda event, **f: self._emit(event, **f))

        if (cfg.get("checkpoint") or {}).get("resume_from"):
            self._emit("resume", resume_from=str(cfg.checkpoint.resume_from))

    def step(self, policy_step: int) -> None:
        if self.watchdog is not None:
            self.watchdog.feed(policy_step)
        if self._fault is not None:
            self._fault.maybe_fire(policy_step, self._emit_critical)
        local = signals.local_preemption_requested()
        if self._coord is not None:
            self._coord.step(policy_step, local_preempt=local)
            self._coord.check_abort()  # a dead peer: a coordinated teardown, not a hang
        if not self._preempt_seen and (local or (self._coord is not None and self._coord.decision() is not None)):
            self._preempt_seen = True
            decision = self._coord.decision() if self._coord is not None else None
            self._emit(
                "preempt",
                step=policy_step,
                signum=signals.preempt_signum(),
                critical=True,
                **({"stop_step": decision["stop_step"], "requested_by": decision.get("requested_by")}
                   if decision else {}),
            )
            print(
                f"[sheeprl-resilience] preemption requested at policy step {policy_step}: "
                + (f"all ranks take the emergency checkpoint at step >= {decision['stop_step']}"
                   if decision else "writing emergency checkpoint and shutting down"),
                flush=True,
            )

    def preempt_requested(self) -> bool:
        # multi-process: the agreed decision, never the local flag alone
        if self._coord is not None:
            return self._coord.preempt_requested()
        return signals.preemption_requested()

    def observe_checkpoint(self, ckpt_path: str, policy_step: int, preempted: Optional[bool] = None) -> None:
        # the loops pass the snapshot that gated this save: re-polling would
        # call a periodic save "preempt" when the signal lands mid-write
        preempt = signals.preemption_requested() if preempted is None else bool(preempted)
        self._emit("checkpoint", step=policy_step, path=str(ckpt_path), reason="preempt" if preempt else "periodic",
                   critical=preempt)
        if self.watchdog is not None:
            self.watchdog.feed(policy_step)

    def finalize(self, policy_step: Optional[int] = None) -> bool:
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        # the agreed decision counts when the signal landed on a peer only
        preempted = signals.preemption_requested() or (self._coord is not None and self._coord.decision() is not None)
        if self._coord is not None:
            self._coord.close()
            self._coord = None
        if preempted:
            self._emit(
                "preempt_exit",
                step=policy_step,
                exit_code=signals.PREEMPTED_EXIT_CODE,
                grace_spent_seconds=signals.preempt_age_seconds(),
                critical=True,
            )
        self._sink.close()
        return preempted

    def _emit_critical(self, event: str, **fields: Any) -> None:
        self._emit(event, critical=True, **fields)

    def _emit(self, event: str, step: Optional[int] = None, critical: bool = False, **fields: Any) -> None:
        if self._sink.sink is None and not (self._eager or critical):
            return
        self._sink.emit(event, step=step, **fields)


def build_resilience(cfg: Any, log_dir: Optional[str] = None, rank: Optional[int] = None):
    """The run's facade from the ``resilience`` config group: the full
    :class:`ResilienceMonitor` on rank 0 (events, faults, the watchdog, the
    preempt agreement's lead), :class:`PeerResilience` on every other rank
    (``rank`` defaults to this process's). :class:`NullResilience` when every
    feature is off, and the loops then behave as before."""
    from sheeprl_tpu_torch.parallel import distributed

    rcfg = cfg.get("resilience") or {}
    handler = bool(rcfg.get("handler", True))
    rank = distributed.process_index() if rank is None else int(rank)
    multi_process = distributed.process_count() > 1
    if rank != 0:
        fault_on = build_fault_plan(rcfg, process_rank=rank) is not None
        # rank 0 runs the failure monitor in a multi-process run, so every
        # peer must heartbeat (a silent peer would be declared dead)
        if not (handler or fault_on or multi_process):
            return NullResilience()
        return PeerResilience(cfg, log_dir, rank=rank)
    fault_on = build_fault_plan(rcfg, process_rank=0) is not None
    watchdog_on = bool((rcfg.get("watchdog") or {}).get("enabled", False))
    supervised = bool((rcfg.get("supervisor") or {}).get("enabled", False))
    if not (handler or fault_on or watchdog_on or supervised or multi_process):
        return NullResilience()
    return ResilienceMonitor(cfg, log_dir, rank=0)
