"""The shared restart/backoff/giveup policy loop of both supervisors.

Copy of ``sheeprl_tpu/resilience/restart_policy.py`` kept by the port (which
imports nothing of the JAX package). In the port only the serve supervisor
(``serve/main.py``) drives it; the training supervisor is not yet ported.

``resilience/supervisor.py`` (in-process, single-process topologies) and
``resilience/distributed.py``'s ``supervise_gang`` (multi-process gangs) used to
each carry their own copy of the same state machine: check for a preemption
that landed BETWEEN attempts, run an attempt, classify its outcome
(``completed`` / ``preempt`` / ``crash``), decide return-vs-retry under
``restart_on_preempt``, count attempts against ``max_restarts``, emit the
``restart`` / ``giveup`` / ``supervisor`` events, and sleep the exponential
backoff. Only the attempt MECHANICS differ (re-enter ``run_fn`` with a rebuilt
config vs respawn a process gang), so the policy loop lives here once and the
callers plug in callbacks:

- ``run_attempt(attempt) -> (outcome, info)`` — run one attempt; ``info`` is
  an opaque dict threaded to the field callbacks (error object, dead ranks...).
- ``restart_fields(attempt, outcome, info) -> dict`` — extra fields for the
  ``restart`` event (resume path, error repr, dead ranks).
- ``giveup_fields(info) -> dict`` — extra fields for the ``giveup`` event.
- ``on_giveup(outcome, info)`` — terminal action once the budget is exhausted:
  re-raise the stored error / raise ``GangFailureError`` on a crash, return
  ``"preempted"`` on a preemption.

``policy.attempt`` is the LIVE attempt counter: the callers' ``emit`` wrappers
read it to stamp their own events (spawn, attempt_exit) with the attempt they
describe, exactly as their old nonlocal counters did.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

from sheeprl_tpu_torch.resilience import signals

__all__ = ["RestartPolicy", "run_restart_policy"]


@dataclass
class RestartPolicy:
    """The ``resilience.supervisor`` policy knobs plus the live attempt counter."""

    max_restarts: int = 3
    backoff: float = 1.0
    backoff_cap: float = 60.0
    restart_on_preempt: bool = True
    attempt: int = 0

    @classmethod
    def from_cfg(cls, scfg: Mapping[str, Any]) -> "RestartPolicy":
        get = scfg.get if hasattr(scfg, "get") else (lambda k, d=None: d)
        return cls(
            max_restarts=int(get("max_restarts", 3)),
            backoff=float(get("backoff", 1.0)),
            backoff_cap=float(get("backoff_cap", 60.0)),
            restart_on_preempt=bool(get("restart_on_preempt", True)),
        )

    def backoff_delay(self) -> float:
        """Exponential backoff for the CURRENT (already-incremented) attempt."""
        if self.backoff <= 0:
            return 0.0
        return min(self.backoff * (2.0 ** (self.attempt - 1)), self.backoff_cap)


def run_restart_policy(
    policy: RestartPolicy,
    run_attempt: Callable[[int], Tuple[str, Dict[str, Any]]],
    emit: Callable[..., None],
    *,
    restart_fields: Callable[[int, str, Dict[str, Any]], Dict[str, Any]],
    giveup_fields: Callable[[Dict[str, Any]], Dict[str, Any]],
    on_giveup: Callable[[str, Dict[str, Any]], str],
) -> str:
    """Drive attempts under ``policy`` until completed / preempted / budget
    exhausted. Returns ``"completed"`` or ``"preempted"``; ``on_giveup`` may
    raise instead of returning (the crash-budget path)."""
    while True:
        # a SIGTERM that landed BETWEEN attempts (teardown, backoff sleep) is a
        # real reclaim: blindly resetting it would relaunch a full attempt on a
        # dying node — honor the same policy as an in-run preemption
        if signals.preemption_requested() and not policy.restart_on_preempt:
            emit(
                "supervisor",
                status="preempted",
                attempts=policy.attempt,
                between_attempts=True,
            )
            return "preempted"
        signals.reset_preemption()

        outcome, info = run_attempt(policy.attempt)
        if outcome == "completed":
            if policy.attempt > 0:
                emit("supervisor", status="completed", attempts=policy.attempt)
            return "completed"
        if outcome == "preempt" and not policy.restart_on_preempt:
            emit("supervisor", status="preempted", attempts=policy.attempt)
            return "preempted"

        policy.attempt += 1
        if policy.attempt > policy.max_restarts:
            emit(
                "giveup",
                reason=outcome,
                attempts=policy.attempt - 1,
                max_restarts=policy.max_restarts,
                **giveup_fields(info),
            )
            return on_giveup(outcome, info)

        delay = policy.backoff_delay()
        emit(
            "restart",
            attempt=policy.attempt,
            reason=outcome,
            backoff_seconds=round(delay, 3),
            **restart_fields(policy.attempt, outcome, info),
        )
        if delay > 0:
            time.sleep(delay)
