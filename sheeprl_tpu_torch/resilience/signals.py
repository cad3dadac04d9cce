"""Cooperative SIGTERM/SIGINT handling (port of
``sheeprl_tpu/resilience/signals.py``): the handler only records the request;
the training loops poll it at iteration boundaries (through the resilience
facade, ``resilience/monitor.py``) and write an emergency checkpoint before
they exit, and the serve verb's drain watcher acts on it. A second signal
exits at once.

Two flags: the process's own signal (:func:`local_preemption_requested`, what
a rank publishes to the gang's coordinator) and the gang's agreement
(:func:`mark_preempted`, set by the coordinator when a peer's signal decided a
stop). :func:`preemption_requested` is either.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional, Tuple

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL: drained cleanly, reschedule
# a watchdog's abort that the main thread never unwound (resilience/watchdog.py)
WATCHDOG_EXIT_CODE = 76
# a healthy rank that tore itself down because a PEER was declared dead
# (resilience/distributed.py::RankFailureError): the gang supervisor does not
# blame this rank for the attempt's death
RANK_FAILED_EXIT_CODE = 77

_DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


class _State:
    def __init__(self) -> None:
        self.requested = threading.Event()
        self.gang = threading.Event()
        self.signum: Optional[int] = None
        self.received_at: Optional[float] = None
        self.previous: Dict[int, object] = {}


_state = _State()


def _handler(signum, frame) -> None:
    if _state.requested.is_set():
        os._exit(128 + signum)
    _record(signum)


def _record(signum: int) -> None:
    _state.signum = int(signum)
    _state.received_at = time.monotonic()
    _state.requested.set()


def install_preemption_handler(signums: Tuple[int, ...] = _DEFAULT_SIGNALS) -> bool:
    """Install the handler (main thread only). Returns whether it was installed."""
    if threading.current_thread() is not threading.main_thread():
        return False
    for signum in signums:
        _state.previous[signum] = signal.signal(signum, _handler)
    return True


def uninstall_preemption_handler() -> None:
    for signum, previous in _state.previous.items():
        signal.signal(signum, previous)
    _state.previous.clear()
    reset_preemption()


def preemption_requested() -> bool:
    """This process's own signal, or the gang's agreement to stop."""
    return _state.requested.is_set() or _state.gang.is_set()


def local_preemption_requested() -> bool:
    """Strictly this process's own signal: what a rank publishes to the
    coordinator (the gang's agreement is what it reads back)."""
    return _state.requested.is_set()


def mark_preempted() -> None:
    """Record the gang's agreement to stop (the coordinator only)."""
    _state.gang.set()


def preempt_signum() -> Optional[int]:
    return _state.signum if _state.requested.is_set() else None


def preempt_age_seconds() -> Optional[float]:
    """Seconds since this process's signal landed (None when there was none)."""
    if not _state.requested.is_set() or _state.received_at is None:
        return None
    return time.monotonic() - _state.received_at


def request_preemption(signum: Optional[int] = None) -> None:
    """Record a preemption request without a signal (faults, tests, worker
    threads)."""
    _record(signal.SIGTERM if signum is None else signum)


def reset_preemption() -> None:
    """Clear both flags (the supervisors call this between attempts)."""
    _state.requested.clear()
    _state.gang.clear()
    _state.signum = None
    _state.received_at = None
