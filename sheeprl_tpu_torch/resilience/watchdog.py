"""Progress watchdog: detect a silently hung run and make the hang observable
(port of ``sheeprl_tpu/resilience/watchdog.py``).

A training loop can stall without dying — an env deadlocks, a device call
hangs, a wait blocks forever on a dead peer — and nothing in the loop
notices: the process sits between ``checkpoint.every`` boundaries
burning reserved accelerator time. The watchdog is a daemon thread fed by the
loops' existing per-iteration cadence (the same hook that drives
``telemetry.step``). When no feed arrives for ``timeout`` seconds it dumps every
thread's stack as a ``health`` event into ``telemetry.jsonl`` (the one artifact
a post-mortem can always read) and, with ``abort=true``, escalates: first an
async :class:`WatchdogError` raised in the main thread (catches Python-level
stalls, unwinds through the normal teardown, and the supervisor treats it as a
crash), then — if the main thread is stuck in native code and never sees it —
``os._exit`` with :data:`~sheeprl_tpu_torch.resilience.signals.WATCHDOG_EXIT_CODE`
after a grace period, which an *external* supervisor treats as a crash.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from sheeprl_tpu_torch.resilience.signals import WATCHDOG_EXIT_CODE


class WatchdogError(RuntimeError):
    """Raised asynchronously in the main thread on a stalled run (abort mode)."""


def dump_all_stacks() -> Dict[str, str]:
    """``{thread name: formatted stack}`` for every live thread — the payload of
    the stall event, and on its own a useful debugging helper."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: Dict[str, str] = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, f"thread-{ident}")
        stacks[label] = "".join(traceback.format_stack(frame))
    return stacks


def _async_raise_main(exc_type) -> bool:
    """Schedule ``exc_type`` in the main thread at its next bytecode boundary."""
    import ctypes

    main = threading.main_thread()
    if main.ident is None:
        return False
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(main.ident), ctypes.py_object(exc_type)
    )
    return res == 1


# Live watchdogs (registered by start(), deregistered by stop()). An exception
# unwinding out of a training loop skips monitor.finalize() — the only in-loop
# stop site — so whoever handles the crash (the supervisor between attempts, a
# fresh monitor in the next in-process run) must stop stale instances: with
# abort=true an orphaned watchdog's grace countdown would os._exit(76) the
# healthy restarted run.
_active: list = []
_active_lock = threading.Lock()


def stop_all_watchdogs() -> None:
    """Stop every live watchdog (crash-path cleanup; idempotent)."""
    with _active_lock:
        stale = list(_active)
    for dog in stale:
        dog.stop()


class _PauseAll:
    """Context manager suspending stall detection in every live watchdog — used
    around checkpoint writes, whose duration (a large replay buffer's write can
    exceed any sane stall timeout) is progress, not a hang."""

    def __enter__(self):
        with _active_lock:
            self._dogs = list(_active)
        for dog in self._dogs:
            dog.pause()
        return self

    def __exit__(self, *exc):
        for dog in self._dogs:
            dog.resume()
        return False


def watchdogs_paused() -> _PauseAll:
    return _PauseAll()


class ProgressWatchdog:
    """Daemon-thread stall detector. ``feed()`` from the loop's iteration hook;
    one stall event per episode (re-arms on the next feed)."""

    def __init__(
        self,
        timeout: float,
        emit: Callable[..., None],
        *,
        abort: bool = False,
        grace: float = 30.0,
        _exit: Callable[[int], None] = os._exit,
    ) -> None:
        self.timeout = float(timeout)
        self.abort = bool(abort)
        self.grace = float(grace)
        self._emit = emit
        self._exit = _exit
        self._last_feed = time.monotonic()
        self._last_step: Optional[int] = None
        self._tripped = False
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> "ProgressWatchdog":
        if self._thread is None:
            self._last_feed = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name="sheeprl-watchdog", daemon=True
            )
            self._thread.start()
            with _active_lock:
                _active.append(self)
        return self

    def feed(self, policy_step: Optional[int] = None) -> None:
        self._last_feed = time.monotonic()
        if policy_step is not None:
            self._last_step = int(policy_step)
        self._tripped = False  # progress resumed: re-arm

    def pause(self) -> None:
        """Suspend stall detection (a blocking-but-healthy phase, e.g. a long
        synchronous checkpoint write)."""
        self._paused = True

    def resume(self) -> None:
        self.feed()  # the paused span counts as progress, not silence
        self._paused = False

    def stop(self) -> None:
        self._stop.set()
        with _active_lock:
            if self in _active:
                _active.remove(self)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- internals ---------------------------------------------------------------

    def _run(self) -> None:
        poll = max(min(self.timeout / 4.0, 5.0), 0.05)
        while not self._stop.wait(poll):
            if self._paused:
                continue
            stalled_for = time.monotonic() - self._last_feed
            if stalled_for < self.timeout or self._tripped:
                continue
            self._tripped = True
            self.stall_count += 1
            try:
                self._emit(
                    "health",
                    step=self._last_step,
                    status="stalled",
                    stall_seconds=round(stalled_for, 1),
                    timeout=self.timeout,
                    abort=self.abort,
                    stacks=dump_all_stacks(),
                )
            except Exception:
                pass
            if not self.abort:
                continue
            _async_raise_main(WatchdogError)
            # grace period for the async exception to unwind the main thread
            # (feed/stop means it recovered or is tearing down); a main thread
            # pinned inside native code never reaches a bytecode boundary, so
            # escalate to a hard exit an external supervisor restarts
            deadline = time.monotonic() + self.grace
            while time.monotonic() < deadline:
                # a pause during the countdown means the main thread reached a
                # checkpoint write — it is alive; never _exit mid-write
                if (
                    self._stop.wait(0.1)
                    or self._paused
                    or time.monotonic() - self._last_feed < self.timeout
                ):
                    break
            else:
                self._exit(WATCHDOG_EXIT_CODE)
