"""Continuous-batching policy server over the slot table (port of
``sheeprl_tpu/serve/server.py``).

Concurrent sessions (client threads) submit observations; one tick loop
coalesces whatever is pending into one fixed-shape batched step over the slot
table (``serve/slots.py``) and fans the actions back out:

- **admission**: a new session waits in the queue until a slot frees up, then
  ``attach`` initializes its carry between steps;
- **coalescing**: a tick fires as soon as every attached session has a pending
  request, or ``max_batch_wait_ms`` after the first pending request;
- **masking**: sessions that did not submit this tick keep their carry bit-exact;
- **eviction**: closing a session frees its slot at once;
- **overload shedding**: ``max_queue`` bounds the admission queue, a session past
  it gets :class:`ServerOverloaded` with a ``retry_after_s`` hint;
- **deadlines**: ``deadline_ms`` bounds each request; a request still pending
  past it is dropped before the tick (:class:`DeadlineExceeded`, carry intact);
- **degraded mode**: under sustained saturation the coalescing window widens by
  ``degraded_wait_factor`` and narrows again when saturation clears;
- **graceful drain**: :meth:`PolicyServer.begin_drain` stops admissions, in-flight
  sessions finish within a grace window, then the server closes;
- **hot weight reload**: :meth:`PolicyServer.update_params` hands over candidate
  weights already staged on the device (``serve/reload.py``); the tick loop
  copies them into the serving module's parameters in place, between ticks and
  under the lock, so the step, the carries, the generators and the slot map
  stay as they were. Every tick is counted under the weight version it served;
- **exploration slots**: the lowest ``round(explore_fraction * slots)`` slots
  add Gaussian noise to their delivered actions on the host, drawn from a
  ``numpy`` generator seeded with the session's seed, as the JAX server does;
  the step itself, and so every other slot's action, is unchanged;
- **fault injection**: the armed ``resilience.fault`` plan fires at its served
  step from the tick loop (``resilience/faults.py``).

The serving telemetry (``serve/telemetry.py``) observes every tick, reload,
drain and degraded-mode transition when one is attached. The server also keeps
plain counters (:attr:`PolicyServer.stats`): ticks by weight version, served
steps and each tick's step time. Trajectory capture (the JAX server's
``trajectories=``) is refused with ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from sheeprl_tpu_torch.resilience import faults
from sheeprl_tpu_torch.serve.policy import ServePolicy
from sheeprl_tpu_torch.serve.slots import SlotTable

__all__ = ["DeadlineExceeded", "PolicyServer", "ServeSession", "ServerClosed", "ServerOverloaded"]

DEGRADED_ENTER_TICKS = 8
DEGRADED_EXIT_TICKS = 8
DEFAULT_DEGRADED_WAIT_FACTOR = 4.0


class ServerClosed(RuntimeError):
    """The server shut down (or crashed) while a session was waiting on it; a
    crash's root cause rides as ``__cause__``."""


class ServerOverloaded(RuntimeError):
    """Admission was shed: the table is full and so is the bounded queue."""

    def __init__(self, message: str, retry_after_s: float) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(RuntimeError):
    """The request was still pending when its ``deadline_ms`` expired; it was
    dropped before the tick and the session carry is untouched."""


class ServeStats:
    """Counters of one server's tick loop (written by the tick loop only)."""

    # ticks whose step time the latency percentiles cover (the most recent)
    WINDOW = 65536

    def __init__(self) -> None:
        self.ticks = 0
        self.steps = 0
        self.step_ms: deque = deque(maxlen=self.WINDOW)  # device-step time per tick
        self.ticks_by_version: Dict[int, int] = {}

    def observe(self, batch: int, step_ms: float, version: int = 0) -> None:
        self.ticks += 1
        self.steps += batch
        self.step_ms.append(step_ms)
        self.ticks_by_version[version] = self.ticks_by_version.get(version, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        ms = np.asarray(self.step_ms, dtype=np.float64)
        return {
            "ticks": self.ticks,
            "steps": self.steps,
            "tick_ms_p50": float(np.percentile(ms, 50)) if ms.size else None,
            "tick_ms_p99": float(np.percentile(ms, 99)) if ms.size else None,
            "tick_ms_max": float(ms.max()) if ms.size else None,
            "mean_batch": self.steps / self.ticks if self.ticks else None,
            "ticks_by_version": {str(v): n for v, n in sorted(self.ticks_by_version.items())},
        }


class ServeSession:
    """Client handle for one policy session, driven by one thread."""

    def __init__(self, server: "PolicyServer", seed: int) -> None:
        self._server = server
        self.seed = int(seed)
        self.slot: Optional[int] = None
        self.steps = 0
        self._obs: Optional[Dict[str, np.ndarray]] = None
        self._action: Optional[np.ndarray] = None
        self._submit_time = 0.0
        self._attached_time = 0.0
        self._deadline: Optional[float] = None
        self._deadline_missed = False
        self._event = threading.Event()
        self._closed = False
        # explore-slot noise: seeded from the SESSION seed at attach, advanced
        # once per delivered action (None on a greedy slot)
        self._noise_rng: Optional[np.random.Generator] = None

    def step(self, obs: Dict[str, np.ndarray], timeout: Optional[float] = None) -> np.ndarray:
        """Submit one observation; block until the batched step returns this
        session's action."""
        if self._closed:
            raise ServerClosed("session is closed")
        self._server._submit(self, obs)
        if not self._event.wait(timeout if timeout is not None else self._server.request_timeout):
            raise TimeoutError(f"serve session (slot {self.slot}) timed out waiting for an action")
        if self._deadline_missed:
            raise DeadlineExceeded(
                f"request exceeded its {self._server.deadline_ms:.0f}ms deadline before "
                "the tick — dropped pre-batch, session state untouched; retry"
            )
        if self._server._error is not None:
            raise ServerClosed(f"policy server died: {self._server._error!r}") from self._server._error
        if self._action is None:
            raise ServerClosed("policy server shut down mid-request")
        self.steps += 1
        return self._action

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._server._release(self)


class PolicyServer:
    """The batching inference server. Use as a context manager (or
    :meth:`start` / :meth:`close`); clients call :meth:`open_session`."""

    def __init__(
        self,
        policy: ServePolicy,
        *,
        slots: int = 4,
        max_batch_wait_ms: float = 2.0,
        base_seed: int = 0,
        request_timeout: float = 120.0,
        max_queue: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        degraded_wait_factor: float = DEFAULT_DEGRADED_WAIT_FACTOR,
        telemetry: Any = None,
        fault_plan: Any = None,
        trajectories: Any = None,
        explore_fraction: float = 0.0,
        explore_noise: float = 0.3,
    ) -> None:
        if trajectories is not None:
            raise NotImplementedError(
                "trajectory capture (PolicyServer(trajectories=...)) is not yet ported to sheeprl_tpu_torch: "
                "it rides the fleet experience plane"
            )
        self.policy = policy
        self.table = SlotTable(policy, slots, base_seed=base_seed)
        self.max_batch_wait_ms = float(max_batch_wait_ms)
        self.request_timeout = float(request_timeout)
        self.max_queue = None if max_queue is None else max(int(max_queue), 0)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.degraded_wait_factor = max(float(degraded_wait_factor), 1.0)
        self.telemetry = telemetry
        self.fault_plan = fault_plan
        self.explore_slots = int(round(max(min(float(explore_fraction), 1.0), 0.0) * int(slots)))
        self.explore_noise = float(explore_noise)
        self.stats = ServeStats()

        self._cond = threading.Condition()
        self._admission: deque = deque()
        self._sessions: Dict[int, ServeSession] = {}
        # session lifecycle deltas since the last tick (for the telemetry)
        self._started_delta = 0
        self._finished_delta = 0
        self._shed_delta = 0
        self._deadline_delta = 0
        self._closing = False
        self._closed = False
        self._draining = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # hot reload: staged weights wait here until the tick loop swaps them in
        self._pending_params: Optional[tuple] = None
        self.weight_version = 0
        self.reloads = 0
        self.last_swap: Optional[Dict[str, float]] = None
        self.degraded = False
        self._saturated_ticks = 0
        self._healthy_ticks = 0
        self._finish_times: deque = deque(maxlen=64)
        self._obs_buf = {k: spec.zeros(self.table.num_slots) for k, spec in policy.obs_spec.items()}

    # -- lifecycle -----------------------------------------------------------------

    def start(self) -> "PolicyServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="sheeprl-serve", daemon=True)
            self._thread.start()
        return self

    def close(self, clean_exit: bool = True) -> None:
        with self._cond:
            # a crashed tick loop has set _closing already: the close tail
            # (join, client wake-up, telemetry summary) still runs once
            if self._closed:
                return
            self._closed = True
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        for session in list(self._sessions.values()) + list(self._admission):
            session._event.set()
        if self.telemetry is not None:
            # fold lifecycle deltas no tick observed, then finish the stream
            with self._cond:
                started, finished = self._started_delta, self._finished_delta
                shed, deadline_missed = self._shed_delta, self._deadline_delta
                self._started_delta = self._finished_delta = self._shed_delta = self._deadline_delta = 0
            if started or finished or shed or deadline_missed:
                self.telemetry.observe_sessions(
                    started=started, finished=finished, shed=shed, deadline_missed=deadline_missed
                )
            self.telemetry.close(clean_exit=clean_exit and self._error is None)

    def begin_drain(self) -> None:
        """Stop admissions: new sessions are rejected, queued ones shed, attached
        ones keep being served. Idempotent."""
        with self._cond:
            if self._draining or self._closing:
                return
            self._draining = True
            queued = list(self._admission)
            self._admission.clear()
            for session in queued:
                session._event.set()
            self._cond.notify_all()
        if self.telemetry is not None:
            self.telemetry.observe_drain(phase="begin", shed=len(queued))

    def drain(self, grace_s: float = 10.0, clean_exit: bool = True) -> Dict[str, int]:
        """:meth:`begin_drain`, wait up to ``grace_s`` for in-flight sessions,
        then :meth:`close`. Returns ``{aborted}``."""
        self.begin_drain()
        deadline = time.monotonic() + max(float(grace_s), 0.0)
        while time.monotonic() < deadline:
            with self._cond:
                if not self._sessions:
                    break
            time.sleep(0.02)
        with self._cond:
            aborted = len(self._sessions)
        if self.telemetry is not None:
            self.telemetry.observe_drain(phase="end", aborted=aborted, grace_s=float(grace_s))
        self.close(clean_exit=clean_exit)
        return {"aborted": aborted}

    @property
    def draining(self) -> bool:
        return self._draining

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(clean_exit=exc_type is None)

    # -- hot weight reload ---------------------------------------------------------

    def update_params(self, staged: Any, version: int) -> None:
        """Hand over weights staged on the serving device (a
        :class:`~sheeprl_tpu_torch.serve.reload.StagedWeights` the reloader has
        validated against the serving module's layout); the tick loop swaps
        them in between ticks."""
        with self._cond:
            if self._closing:
                raise ServerClosed("server is shutting down")
            self._pending_params = (staged, int(version))
            self._cond.notify_all()

    def _apply_pending_params_locked(self) -> Optional[int]:
        """Swap staged weights in (tick loop only, under the lock, between
        ticks): an in-place copy into the serving module's parameters on the
        tick's stream, which first waits for the staging copies. The previous
        tick ended in a host copy of its actions, so no launch still reads the
        old weights; the next tick's launches follow the copy in stream order,
        so none reads a half-copied tensor. Returns the new version."""
        if self._pending_params is None:
            return None
        staged, version = self._pending_params
        self._pending_params = None
        t0 = time.perf_counter()
        staged.apply(self.policy.module)
        self.last_swap = {"stage_ms": staged.stage_ms, "apply_ms": (time.perf_counter() - t0) * 1000.0}
        self.weight_version = version
        self.reloads += 1
        self._cond.notify_all()  # callers may wait on the condition for a version
        return version

    # -- client API ----------------------------------------------------------------

    def open_session(self, seed: Optional[int] = None) -> ServeSession:
        """Create a session; it attaches as soon as a slot frees up. Raises
        :class:`ServerClosed` once closing or draining, :class:`ServerOverloaded`
        when the bounded admission queue is full."""
        with self._cond:
            if self._closing or self._error is not None:
                raise ServerClosed("server is shutting down") from self._error
            if self._draining:
                raise ServerClosed("server is draining — not admitting new sessions")
            # count the queue's claim on free slots: the tick loop has not yet
            # admitted queued sessions, so every free slot may already be spoken for
            if (
                self.max_queue is not None
                and len(self._admission) >= self.max_queue + self.table.free_slots
            ):
                self._shed_delta += 1
                retry = self._retry_after_locked()
                raise ServerOverloaded(
                    f"admission queue is full ({len(self._admission)} waiting >= "
                    f"max_queue {self.max_queue} beyond free capacity) — retry in ~{retry:.2f}s",
                    retry_after_s=retry,
                )
            session = ServeSession(self, seed if seed is not None else len(self._sessions))
            self._admission.append(session)
            self._started_delta += 1
            self._cond.notify_all()
            return session

    def _retry_after_locked(self) -> float:
        times = list(self._finish_times)
        waiting = len(self._admission) + 1
        if len(times) >= 2 and times[-1] > times[0]:
            per_finish = (times[-1] - times[0]) / (len(times) - 1)
            return min(max(per_finish * waiting, 0.01), 60.0)
        return min(max(self.max_batch_wait_ms / 1000.0, 0.01) * waiting, 60.0)

    @property
    def active_sessions(self) -> int:
        with self._cond:
            return len(self._sessions)

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._admission)

    # -- session plumbing ----------------------------------------------------------

    def _submit(self, session: ServeSession, obs: Dict[str, np.ndarray]) -> None:
        with self._cond:
            if self._closing or self._error is not None:
                raise ServerClosed("server is shutting down") from self._error
            session._obs = obs
            session._action = None
            session._deadline_missed = False
            session._submit_time = time.perf_counter()
            session._deadline = (
                session._submit_time + self.deadline_ms / 1000.0 if self.deadline_ms is not None else None
            )
            session._event.clear()
            self._cond.notify_all()

    def _release(self, session: ServeSession) -> None:
        with self._cond:
            if session.slot is not None:
                self._sessions.pop(session.slot, None)
                self.table.evict(session.slot)
                session.slot = None
                self._finished_delta += 1
                self._finish_times.append(time.monotonic())
            elif session in self._admission:
                self._admission.remove(session)
                self._finished_delta += 1
            session._event.set()
            self._cond.notify_all()

    # -- tick loop -----------------------------------------------------------------

    def _admit_locked(self) -> Dict[int, int]:
        attached: Dict[int, int] = {}
        while self._admission:
            slot = self.table.try_admit(self._admission[0])
            if slot is None:
                break
            session = self._admission.popleft()
            session.slot = slot
            session._attached_time = time.perf_counter()
            self._sessions[slot] = session
            attached[slot] = session.seed
            # the explore split is a property of the SLOT, the noise stream
            # one of the SESSION: invisible to every co-batched greedy session
            session._noise_rng = np.random.default_rng(session.seed) if slot < self.explore_slots else None
        return attached

    def _pending_locked(self) -> List[ServeSession]:
        return [s for s in self._sessions.values() if s._obs is not None]

    def _expire_deadlines_locked(self, now: float) -> None:
        if self.deadline_ms is None:
            return
        for session in self._sessions.values():
            if session._obs is not None and session._deadline is not None and now > session._deadline:
                session._obs = None
                session._deadline_missed = True
                session._event.set()
                self._deadline_delta += 1

    def _update_degraded_locked(self, saturated: bool) -> Optional[bool]:
        """Degraded-mode hysteresis; returns the new mode on a transition."""
        if saturated:
            self._saturated_ticks += 1
            self._healthy_ticks = 0
            if not self.degraded and self._saturated_ticks >= DEGRADED_ENTER_TICKS:
                self.degraded = True
                return True
        else:
            self._healthy_ticks += 1
            self._saturated_ticks = 0
            if self.degraded and self._healthy_ticks >= DEGRADED_EXIT_TICKS:
                self.degraded = False
                return False
        return None

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as exc:  # deliver the failure, never hang clients
            self._error = exc
            with self._cond:
                self._closing = True
                for session in list(self._sessions.values()) + list(self._admission):
                    session._event.set()
                self._cond.notify_all()

    def _emit_fault_event(self, *args: Any, **fields: Any) -> None:
        if self.telemetry is not None:
            self.telemetry.emit_event(*args, **fields)

    def _maybe_fire_fault(self, steps: int) -> None:
        """The armed fault plan fires once at its served step."""
        if self.fault_plan is None:
            return
        self.fault_plan.maybe_fire(steps, self._emit_fault_event)
        flood = faults.consume_session_flood()
        if flood:
            self._spawn_flood(flood)

    def _spawn_flood(self, count: int) -> None:
        """``session_flood``: ``count`` synthetic clients storm admission at
        once; shed ones count in the telemetry, admitted ones run a few
        zero-observation steps and leave."""

        def _client(i: int) -> None:
            try:
                session = self.open_session(seed=100_000 + i)
                obs = {k: spec.zeros(1)[0] for k, spec in self.policy.obs_spec.items()}
                for _ in range(4):
                    session.step(obs)
                session.close()
            except (ServerClosed, ServerOverloaded, DeadlineExceeded, TimeoutError):
                pass

        for i in range(count):
            threading.Thread(target=_client, args=(i,), name=f"sheeprl-flood-{i}", daemon=True).start()

    def _loop(self) -> None:
        base_wait_budget = self.max_batch_wait_ms / 1000.0
        total_steps = 0
        while True:
            wait_started = time.perf_counter()
            with self._cond:
                if self._closing:
                    return
                swapped = self._apply_pending_params_locked()
                attached = self._admit_locked()
            if swapped is not None and self.telemetry is not None:
                self.telemetry.observe_reload(version=swapped, timings=self.last_swap)
            if attached:
                self.table.attach(attached)
            wait_budget = base_wait_budget * (self.degraded_wait_factor if self.degraded else 1.0)

            # coalescing wait: fire when every attached session is pending, or
            # wait_budget after the FIRST pending request arrived
            with self._cond:
                while not self._closing:
                    now = time.perf_counter()
                    self._expire_deadlines_locked(now)
                    pending = self._pending_locked()
                    if pending:
                        oldest = min(s._submit_time for s in pending)
                        remaining = wait_budget - (now - oldest)
                        if len(pending) == len(self._sessions) or remaining <= 0:
                            break
                        deadlines = [s._deadline - now for s in pending if s._deadline is not None]
                        if deadlines:
                            remaining = min(remaining, max(min(deadlines), 0.0))
                    if self._admission and self.table.free_slots:
                        break  # admit first, then come back for the batch
                    if self._pending_params is not None:
                        break  # an idle server swaps now, not at the next request
                    self._cond.wait(remaining if pending else 0.05)
                if self._closing:
                    return
                self._expire_deadlines_locked(time.perf_counter())
                pending = self._pending_locked()
                if not pending:
                    continue
                batch = [(s.slot, s) for s in pending]
                active = len(self._sessions)
                queue_depth = len(self._admission)
                started, finished = self._started_delta, self._finished_delta
                shed, deadline_missed = self._shed_delta, self._deadline_delta
                self._started_delta = self._finished_delta = self._shed_delta = self._deadline_delta = 0
                saturated = shed > 0 or (queue_depth > 0 and not self.table.free_slots)
                transition = self._update_degraded_locked(saturated)
            wait_seconds = time.perf_counter() - wait_started
            if transition is not None and self.telemetry is not None:
                self.telemetry.observe_degraded(transition)

            total_steps += len(batch)
            self._maybe_fire_fault(total_steps)
            slow = faults.slow_tick_seconds()
            if slow > 0:
                time.sleep(slow)  # injected device degradation: every tick pays it

            mask = np.zeros((self.table.num_slots,), np.bool_)
            for slot, session in batch:
                mask[slot] = True
                for k, buf in self._obs_buf.items():
                    buf[slot] = np.asarray(session._obs[k], dtype=buf.dtype).reshape(buf.shape[1:])
            t0 = time.perf_counter()
            actions = self.table.step(self._obs_buf, mask)
            step_seconds = time.perf_counter() - t0
            self.stats.observe(len(batch), step_seconds * 1000.0, self.weight_version)

            now = time.perf_counter()
            latencies = []
            for slot, session in batch:
                session._obs = None
                action = np.array(actions[slot])
                if session._noise_rng is not None:
                    # host-side Gaussian exploration after the batched step,
                    # unclipped (the env adapter owns the action bounds)
                    action = (action + session._noise_rng.normal(0.0, self.explore_noise, action.shape)).astype(
                        action.dtype
                    )
                session._action = action
                # a queued session's first request starts its clock at attach
                latencies.append((now - max(session._submit_time, session._attached_time)) * 1000.0)
                session._event.set()

            if self.telemetry is not None:
                self.telemetry.observe_tick(
                    batch=len(batch),
                    slots=self.table.num_slots,
                    active=active,
                    queue_depth=queue_depth,
                    step_seconds=step_seconds,
                    wait_seconds=wait_seconds,
                    latencies_ms=latencies,
                    started=started,
                    finished=finished,
                    shed=shed,
                    deadline_missed=deadline_missed,
                    state_bytes=self.table.state_bytes(),
                    weight_version=self.weight_version,
                    degraded=self.degraded,
                )
