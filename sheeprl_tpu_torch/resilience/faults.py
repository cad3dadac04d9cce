"""Deterministic, config-driven fault injection for the serve verb (port of the
serving part of ``sheeprl_tpu/resilience/faults.py``).

``resilience.fault={kind, at_policy_step, factor}`` injects exactly one fault
when the server's tick loop has served ``at_policy_step`` session steps (the
served steps are the policy-step axis of a serving run):

- ``crash``         — raise :class:`InjectedFaultError` from the tick loop: the
                      server dies, its sessions are lost, and the serve
                      supervisor (``serve.supervisor.enabled``) restarts it;
- ``sigterm``       — record a preemption request, as the SIGTERM handler
                      does: the drain watcher drains and the verb exits 75;
- ``env_step``      — the next ``env.step`` of any session raises (the env
                      fault wrapper ``envs/wrappers.py::InjectedEnvFault``);
- ``slow_tick``     — every tick after the trigger sleeps ``factor``
                      milliseconds (default 32): a degraded device;
- ``session_flood`` — ``factor`` synthetic sessions storm admission at once;
- ``reload_torn``   — the hot-reload source tears its next candidate on disk
                      before reading it: integrity validation must reject it.

The training-only kinds (``ckpt_kill``, ``lr_spike``) and the multi-rank kinds
(``kill_rank``, ``stale_heartbeat``, ``channel_drop``) are refused by name with
``NotImplementedError``: the port has no training fault hook and runs one
process. Every fault fires at most once per process: the serve supervisor
restarts in the same process, and a restarted attempt replaying served steps
below ``at_policy_step`` must not fire it again.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from sheeprl_tpu_torch.resilience import signals

FAULT_KINDS = (
    "crash",
    "sigterm",
    "env_step",
    "ckpt_kill",
    "lr_spike",
    "kill_rank",
    "stale_heartbeat",
    "channel_drop",
    "slow_tick",
    "session_flood",
    "reload_torn",
)
PORTED_KINDS = ("crash", "sigterm", "env_step", "slow_tick", "session_flood", "reload_torn")

DEFAULT_FACTOR = 32.0


class InjectedFaultError(RuntimeError):
    """The deterministic stand-in for a hard crash."""


_lock = threading.Lock()
_fired: Dict[tuple, int] = {}  # (kind, at_policy_step) -> served step it fired at
_env_fault_armed = threading.Event()
_slow_tick_seconds = [0.0]  # permanent per-tick stall once slow_tick fired
_session_flood: list = [None]  # one-shot burst size
_reload_torn_armed = threading.Event()


def normalize_fault_cfg(resilience_cfg: Any) -> Optional[Dict[str, Any]]:
    """``{kind, at, rank, factor}`` from ``cfg.resilience.fault``, or None when
    off. Raises ``ValueError`` on an unknown kind and ``NotImplementedError``
    on a kind the port does not drive."""
    fault = (resilience_cfg or {}).get("fault") or {}
    kind = fault.get("kind")
    if kind is None or str(kind).lower() in ("none", "null", "off", "false"):
        return None
    kind = str(kind).lower()
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown resilience.fault.kind {kind!r}; available: none, " + ", ".join(FAULT_KINDS))
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"resilience.fault.kind={kind}: not yet ported to sheeprl_tpu_torch (the serve verb drives "
            f"{', '.join(PORTED_KINDS)})"
        )
    rank = fault.get("rank")
    if rank is not None and int(rank) != 0:
        raise NotImplementedError(
            f"resilience.fault.rank={rank}: the port runs one process (rank 0); multi-rank faults are not yet ported"
        )
    return {
        "kind": kind,
        "at": int(fault.get("at_policy_step") or 0),
        "rank": 0,
        "factor": float(fault.get("factor") or DEFAULT_FACTOR),
    }


def reset_faults() -> None:
    """Forget fired faults and disarm pending ones (test isolation)."""
    with _lock:
        _fired.clear()
        _session_flood[0] = None
    _env_fault_armed.clear()
    _slow_tick_seconds[0] = 0.0
    _reload_torn_armed.clear()


def slow_tick_seconds() -> float:
    """The armed per-tick stall (``slow_tick``) in seconds; 0 when off. Not
    one-shot: a degraded device stays degraded."""
    return _slow_tick_seconds[0]


def consume_session_flood() -> Optional[int]:
    """One-shot: the armed ``session_flood`` burst size, or None."""
    with _lock:
        count = _session_flood[0]
        _session_flood[0] = None
    return count


def consume_reload_torn() -> bool:
    """One-shot: True exactly once after ``reload_torn`` fired."""
    if _reload_torn_armed.is_set():
        _reload_torn_armed.clear()
        return True
    return False


def consume_env_fault() -> bool:
    """One-shot poll the env fault wrapper runs per ``step()``."""
    if _env_fault_armed.is_set():
        _env_fault_armed.clear()
        return True
    return False


class FaultPlan:
    """The armed fault the server's tick loop drives with its served-step count."""

    def __init__(self, kind: str, at_policy_step: int, rank: int = 0, factor: float = DEFAULT_FACTOR) -> None:
        self.kind = kind
        self.at = int(at_policy_step)
        self.rank = rank
        self.factor = float(factor)

    def maybe_fire(self, policy_step: int, emit: Callable[..., None]) -> None:
        if policy_step < self.at:
            return
        key = (self.kind, self.at)
        with _lock:
            if key in _fired:
                return
            _fired[key] = int(policy_step)
        emit(
            "fault",
            step=policy_step,
            kind=self.kind,
            at_policy_step=self.at,
            rank=self.rank,
            **({"factor": self.factor} if self.kind in ("slow_tick", "session_flood") else {}),
        )
        if self.kind == "crash":
            raise InjectedFaultError(f"resilience.fault=crash: injected hard crash at policy step {policy_step}")
        if self.kind == "sigterm":
            signals.request_preemption()
        elif self.kind == "env_step":
            _env_fault_armed.set()
        elif self.kind == "slow_tick":
            _slow_tick_seconds[0] = max(self.factor, 0.0) / 1000.0  # factor is milliseconds
        elif self.kind == "session_flood":
            with _lock:
                _session_flood[0] = max(int(self.factor), 1)
        elif self.kind == "reload_torn":
            _reload_torn_armed.set()


def build_fault_plan(resilience_cfg: Any) -> Optional[FaultPlan]:
    """The armed plan of ``cfg.resilience``, or None."""
    spec = normalize_fault_cfg(resilience_cfg)
    if spec is None:
        return None
    return FaultPlan(spec["kind"], spec["at"], rank=spec["rank"], factor=spec["factor"])
