"""Stateful alert engine over SLO burn-rate snapshots.

Copy of ``sheeprl_tpu/obs/alerts.py`` kept by the port (which imports
nothing of the JAX package).

``obs/slo.py`` turns telemetry windows into per-objective budget accounting;
this module adds the operational state machine on top: each objective owns one
alert that moves ``inactive → pending → firing → resolved`` as its burn rates
cross and clear the alert condition. The same engine runs in two places —
in-loop (``ServingTelemetry``/``RunTelemetry`` call :meth:`AlertEngine.evaluate`
once per emitted window and turn the returned transitions into schema-registered
``alert`` events on the telemetry stream) and offline (``sheeprl.py slo``
replays a recorded stream through an identical engine) — one shared catalog, so
the two can never drift apart.

Alert condition and hysteresis
------------------------------
An objective breaches when BOTH burn rates reach 1.0: the fast window
(``window // 6`` most recent telemetry windows) proves the breach is happening
*now*, the slow window (the full compliance window) proves enough budget is
actually being consumed to matter — the standard multi-window burn-rate rule,
scaled to telemetry-window cadence instead of wall time because that is the
unit the producers emit at. A breached objective enters ``pending`` and must
stay breached for ``for`` consecutive evaluations (the objective's
``for_windows`` hysteresis) before it escalates to ``firing`` — one bad window
pages nobody. When the condition clears: a pending alert silently deactivates
(it never fired), a firing alert emits ``resolved`` and deactivates.

Transitions are plain dicts shaped like the ``alert`` event payload
(status/name/objective/severity/burn rates/budget); the caller owns emission
so the engine stays side-effect free and replayable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

__all__ = ["AlertEngine", "BURN_THRESHOLD"]

# both burn rates must reach this for the alert condition; 1.0 = consuming
# budget exactly as fast as the objective allows
BURN_THRESHOLD = 1.0


class AlertEngine:
    """One alert per objective, evaluated against successive snapshots."""

    def __init__(self, objectives: Sequence[Any]) -> None:
        self._spec = {o.name: o for o in objectives}
        # name -> {"state": inactive|pending|firing, "streak": consecutive
        # breached evaluations, "since_samples": snapshot samples at entry}
        self._states: Dict[str, Dict[str, Any]] = {
            name: {"state": "inactive", "streak": 0} for name in self._spec
        }

    def __bool__(self) -> bool:
        return bool(self._spec)

    def states(self) -> Dict[str, Dict[str, Any]]:
        return {name: dict(state) for name, state in self._states.items()}

    def firing(self) -> Dict[str, Dict[str, Any]]:
        """Currently-firing alerts: name -> {severity, streak}."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, state in self._states.items():
            if state["state"] == "firing":
                out[name] = {
                    "severity": self._spec[name].severity,
                    "streak": state["streak"],
                }
        return out

    def evaluate(self, snapshot: Mapping[str, Mapping[str, Any]]) -> List[Dict[str, Any]]:
        """Advance every alert one evaluation using a ``SloEvaluator.snapshot()``
        and return the transitions (alert-event payloads) this step produced.
        Objectives absent from the snapshot, or present without samples, hold
        their state — a window without the signal is no evidence either way."""
        transitions: List[Dict[str, Any]] = []
        for name, objective in self._spec.items():
            stats = snapshot.get(name)
            if not stats or not stats.get("samples"):
                continue
            breached = (
                float(stats.get("burn_fast") or 0.0) >= BURN_THRESHOLD
                and float(stats.get("burn_slow") or 0.0) >= BURN_THRESHOLD
            )
            state = self._states[name]
            payload = {
                "name": name,
                "objective": name,
                "severity": objective.severity,
                "value": stats.get("value"),
                "target": objective.target,
                "budget_remaining": stats.get("budget_remaining"),
                "burn_fast": stats.get("burn_fast"),
                "burn_slow": stats.get("burn_slow"),
                "for_windows": objective.for_windows,
            }
            if breached:
                state["streak"] += 1
                if state["state"] == "inactive":
                    state["state"] = "pending"
                    state["streak"] = 1
                    transitions.append({"status": "pending", **payload})
                if state["state"] == "pending" and state["streak"] >= objective.for_windows:
                    state["state"] = "firing"
                    transitions.append({"status": "firing", **payload})
            else:
                if state["state"] == "firing":
                    transitions.append({"status": "resolved", **payload})
                state["state"] = "inactive"
                state["streak"] = 0
        return transitions
