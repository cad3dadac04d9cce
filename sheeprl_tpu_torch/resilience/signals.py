"""Cooperative SIGTERM/SIGINT handling for the serve verb (port of the part of
``sheeprl_tpu/resilience/signals.py`` serving uses): the handler only records
the request; the server's drain watcher acts on it. A second signal exits at
once."""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Tuple

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL: drained cleanly, reschedule

_DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


class _State:
    def __init__(self) -> None:
        self.requested = threading.Event()
        self.previous: Dict[int, object] = {}


_state = _State()


def _handler(signum, frame) -> None:
    if _state.requested.is_set():
        os._exit(128 + signum)
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
    _state.requested.clear()


def preemption_requested() -> bool:
    return _state.requested.is_set()


def request_preemption() -> None:
    """Record a preemption request without a signal (tests, worker threads)."""
    _state.requested.set()


def reset_preemption() -> None:
    _state.requested.clear()
