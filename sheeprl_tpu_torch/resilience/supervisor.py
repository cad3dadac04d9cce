"""Run supervisor: bounded auto-restart with checkpoint auto-resume (port of
``sheeprl_tpu/resilience/supervisor.py``).

``resilience.supervisor.enabled`` runs the launch under :func:`supervise`. On a
crash, or a cooperative preemption with ``restart_on_preempt``, it resolves
the newest valid checkpoint of the run (``discovery.py``), rebuilds the
attempt's config through the CLI's resume merge with that checkpoint as
``resume_from``, sleeps an exponential backoff and runs the loop again in the
same process. The restarts are bounded by ``max_restarts``: past the budget a
crash re-raises and a preemption exits with the preempted code. Every decision
lands as a ``restart``/``giveup``/``supervisor`` event in the run base's
``telemetry.jsonl``, which every attempt shares (the supervisor pins
``metric.telemetry.jsonl_path`` there).

A run of more than one process is restarted as a whole by the gang supervisor
(``distributed.py::supervise_gang``): restarting one role in its process would
put the channels out of step, so here the supervisor steps aside with a
warning.
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Callable, Optional

from sheeprl_tpu_torch.config import dotdict
from sheeprl_tpu_torch.obs.jsonl import JsonlEventSink
from sheeprl_tpu_torch.resilience import faults, signals
from sheeprl_tpu_torch.resilience.discovery import find_latest_checkpoint
from sheeprl_tpu_torch.resilience.restart_policy import RestartPolicy, run_restart_policy
from sheeprl_tpu_torch.resilience.watchdog import stop_all_watchdogs


def supervisor_enabled(cfg: Any) -> bool:
    return bool(((cfg.get("resilience") or {}).get("supervisor") or {}).get("enabled", False))


def _strip_fired_fault(cfg: dotdict) -> None:
    """A fault that already fired must not ride into the retry's config (the
    run's saved config, merged back on resume, still carries it)."""
    if faults.has_fired():
        fault = (cfg.get("resilience") or {}).get("fault")
        if fault:
            fault["kind"] = None


def supervise(
    cfg: dotdict,
    run_fn: Callable[[dotdict], Any],
    resume_merge: Callable[[dotdict], dotdict],
    argv_cfg: Optional[dotdict] = None,
) -> str:
    """Run ``run_fn(cfg)`` under restart supervision. Returns ``"completed"``
    or ``"preempted"``; a crash past the restart budget re-raises.

    ``argv_cfg`` is the launch's config before any resume merge: a retry is
    rebuilt from it and merged with its checkpoint through ``resume_merge``
    (which the CLI closes over the typed overrides), so that a value typed on
    the command line survives every attempt."""
    from sheeprl_tpu_torch.parallel import distributed
    from sheeprl_tpu_torch.utils.logger import run_base_dir

    if distributed.process_count() > 1:
        warnings.warn(
            "resilience.supervisor: a run of more than one process is restarted as a whole by the gang "
            "supervisor (resilience.distributed.gang.processes); in-process supervision is off for this run "
            "(the preemption handler and the emergency checkpoint still apply)"
        )
        run_fn(cfg)
        return "preempted" if signals.preemption_requested() else "completed"

    policy = RestartPolicy.from_cfg(cfg.resilience.supervisor)

    run_base = run_base_dir(cfg)
    # one stream across attempts; metric.telemetry.jsonl=false turns it off
    cfg.metric.setdefault("telemetry", dotdict({}))
    jsonl_enabled = bool(cfg.metric.telemetry.get("jsonl", True))
    if jsonl_enabled and not cfg.metric.telemetry.get("jsonl_path"):
        cfg.metric.telemetry.jsonl_path = str(run_base / "telemetry.jsonl")

    sink: Optional[JsonlEventSink] = None

    def emit(event: str, **fields: Any) -> None:
        nonlocal sink
        if not jsonl_enabled:
            return
        if sink is None:
            try:
                sink = JsonlEventSink(cfg.metric.telemetry.jsonl_path)
            except OSError:
                return
        # stamped with the attempt the event decides about
        fields.setdefault("attempt", policy.attempt)
        sink.emit(event, **fields)

    # a retry is rebuilt from the argv config, not the resolved one (which a
    # resumed launch already merged with the old run's config)
    original = dotdict(copy.deepcopy((argv_cfg if argv_cfg is not None else cfg).as_dict()))
    # the resume fallback is the resolved path (the argv value may be "latest")
    fallback_resume = cfg.checkpoint.get("resume_from") or None
    state: dict = {"current": cfg, "resume_from": None}

    def run_attempt(attempt: int):
        if attempt > 0:
            retry = dotdict(copy.deepcopy(original.as_dict()))
            _strip_fired_fault(retry)
            resume_from = state["resume_from"]
            if resume_from is not None:
                retry.checkpoint.resume_from = resume_from
                retry = resume_merge(retry)
            else:
                retry.checkpoint.resume_from = None  # a crash before any checkpoint: start over
            # every event the retry writes carries its attempt (after the
            # merge: `metric` is not resumable, so this sticks)
            retry.metric.setdefault("telemetry", dotdict({}))
            retry.metric.telemetry.attempt = attempt
            if jsonl_enabled:
                retry.metric.telemetry.jsonl_path = cfg.metric.telemetry.jsonl_path
            state["current"] = retry
        error: Optional[BaseException] = None
        try:
            run_fn(state["current"])
        except Exception as e:  # SystemExit and KeyboardInterrupt propagate
            error = e
            # the exception skipped the loop's finalize(): an abort-mode
            # watchdog in its grace countdown would kill the next attempt
            stop_all_watchdogs()
        preempted = signals.preemption_requested() and error is None
        if error is None and not preempted:
            return "completed", {}
        return ("crash" if error is not None else "preempt"), {"error": error}

    def restart_fields(attempt, outcome, info):
        # nothing in this run yet (a crash before the first checkpoint) falls
        # back to the checkpoint the launch itself resumed from
        state["resume_from"] = find_latest_checkpoint(str(run_base)) or fallback_resume
        error = info.get("error")
        return {"resume_from": state["resume_from"], "error": repr(error)[:500] if error is not None else None}

    def giveup_fields(info):
        error = info.get("error")
        return {"error": repr(error) if error is not None else None}

    def on_giveup(outcome, info):
        if info.get("error") is not None:
            raise info["error"]
        return "preempted"

    try:
        return run_restart_policy(
            policy, run_attempt, emit, restart_fields=restart_fields, giveup_fields=giveup_fields, on_giveup=on_giveup
        )
    finally:
        if sink is not None:
            sink.close()
