"""Deterministic, config-driven fault injection (port of
``sheeprl_tpu/resilience/faults.py``).

``resilience.fault={kind, at_policy_step, rank, factor}`` injects exactly one
fault when the process's step axis reaches ``at_policy_step``: a training
loop's policy steps, a learner process's own axis (``parallel/decoupled.py``),
or the serve verb's served steps. ``rank`` names the target process of a
multi-process run (default 0, the driving rank); the other processes arm
nothing.

Training (the loops drive ``maybe_fire`` through ``resilience/monitor.py``):

- ``crash``           — raise :class:`InjectedFaultError`: a hard crash;
- ``sigterm``         — record a preemption request, as the SIGTERM handler
                        does: emergency checkpoint, exit 75;
- ``ckpt_kill``       — raise from inside the next checkpoint write, after the
                        temporary file is written and before its rename
                        (``utils/checkpoint.py``): recovery must skip the torn
                        artifact;
- ``lr_spike``        — before the next train round, scale every floating
                        parameter of the trainer by ``factor`` (default 32):
                        one grossly mis-scaled update;
- ``kill_rank``       — SIGKILL this process: a dead peer with no cleanup;
- ``stale_heartbeat`` — stop publishing heartbeats while the process runs on:
                        a zombie rank;
- ``channel_drop``    — the target's next channel ``put`` advances its
                        sequence and writes no payload: the receiver's bounded
                        wait must end it.

``env_step`` (the next ``env.step`` raises, ``envs/wrappers.py``) runs in
serving only: the training envs have no ``RestartOnException`` yet.

Serving (the server's tick loop drives ``maybe_fire`` with served steps):
``crash``, ``sigterm`` and ``env_step`` as above, and

- ``slow_tick``     — every tick after the trigger sleeps ``factor``
                      milliseconds (default 32): a degraded device;
- ``session_flood`` — ``factor`` synthetic sessions storm admission at once;
- ``reload_torn``   — the hot-reload source tears its next candidate on disk
                      before reading it: integrity validation must reject it.

Every fault fires at most once per process: the in-process supervisors restart
in the same process, and a restarted attempt replaying steps below
``at_policy_step`` must not fire it again. The supervisors also strip the fault
from a retry's config.
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
TRAINING_KINDS = ("crash", "sigterm", "ckpt_kill", "lr_spike", "kill_rank", "stale_heartbeat", "channel_drop")
SERVING_KINDS = ("crash", "sigterm", "env_step", "slow_tick", "session_flood", "reload_torn")

DEFAULT_FACTOR = 32.0


class InjectedFaultError(RuntimeError):
    """The deterministic stand-in for a hard crash."""


_lock = threading.Lock()
_fired: Dict[tuple, int] = {}  # (kind, at_policy_step) -> step it fired at
_env_fault_armed = threading.Event()
_heartbeat_stale = threading.Event()
_channel_drop_armed = threading.Event()
_learn_fault_factor: list = [None]  # armed lr_spike scale, consumed by the next train round
_slow_tick_seconds = [0.0]  # permanent per-tick stall once slow_tick fired
_session_flood: list = [None]  # one-shot burst size
_reload_torn_armed = threading.Event()


def normalize_fault_cfg(resilience_cfg: Any, scope: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """``{kind, at, rank, factor}`` from ``cfg.resilience.fault``, or None when
    off (``rank`` None means the driving rank 0). Raises ``ValueError`` on an
    unknown kind, and ``NotImplementedError`` on a kind the ``scope``
    (``"training"`` or ``"serving"``) does not drive in the port."""
    fault = (resilience_cfg or {}).get("fault") or {}
    kind = fault.get("kind")
    if kind is None or str(kind).lower() in ("none", "null", "off", "false"):
        return None
    kind = str(kind).lower()
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown resilience.fault.kind {kind!r}; available: none, " + ", ".join(FAULT_KINDS))
    if scope == "serving" and kind not in SERVING_KINDS:
        raise NotImplementedError(
            f"resilience.fault.kind={kind}: not yet ported to the serve verb of sheeprl_tpu_torch (it drives "
            f"{', '.join(SERVING_KINDS)}; the training loops drive {', '.join(TRAINING_KINDS)})"
        )
    if scope == "training" and kind not in TRAINING_KINDS:
        why = (
            "the training envs have no RestartOnException wrapper yet"
            if kind == "env_step"
            else "it is a serving fault"
        )
        raise NotImplementedError(
            f"resilience.fault.kind={kind} in training: not yet ported to sheeprl_tpu_torch ({why}); "
            f"training drives {', '.join(TRAINING_KINDS)}"
        )
    rank = fault.get("rank")
    return {
        "kind": kind,
        "at": int(fault.get("at_policy_step") or 0),
        "rank": None if rank is None else int(rank),
        "factor": float(fault.get("factor") or DEFAULT_FACTOR),
    }


def has_fired() -> bool:
    with _lock:
        return bool(_fired)


def reset_faults() -> None:
    """Forget fired faults and disarm pending ones (test isolation)."""
    with _lock:
        _fired.clear()
        _session_flood[0] = None
        _learn_fault_factor[0] = None
    _env_fault_armed.clear()
    _heartbeat_stale.clear()
    _channel_drop_armed.clear()
    _slow_tick_seconds[0] = 0.0
    _reload_torn_armed.clear()
    from sheeprl_tpu_torch.parallel import distributed
    from sheeprl_tpu_torch.utils import checkpoint

    if checkpoint._fault_hook is _ckpt_kill_hook:
        checkpoint._fault_hook = None
    if distributed._channel_drop_hook is _consume_channel_drop:
        distributed._channel_drop_hook = None


def heartbeat_stalled() -> bool:
    """Whether ``stale_heartbeat`` silenced this process's heartbeat writer
    (permanent once fired: a zombie does not recover)."""
    return _heartbeat_stale.is_set()


def _consume_channel_drop() -> bool:
    """One-shot poll a channel's source runs per ``put``
    (``parallel/distributed.py``'s ``_channel_drop_hook``)."""
    if _channel_drop_armed.is_set():
        _channel_drop_armed.clear()
        return True
    return False


def consume_learn_fault() -> Optional[float]:
    """One-shot: the armed ``lr_spike`` factor, or None. Consuming disarms it:
    the spike is one mis-scaled update, not a lasting corruption."""
    with _lock:
        factor = _learn_fault_factor[0]
        _learn_fault_factor[0] = None
    return factor


def apply_armed_learn_fault(target: Any) -> bool:
    """Apply a pending ``lr_spike`` to ``target`` (a module, or an iterable of
    modules and tensors): every floating parameter is scaled in place by the
    armed factor, in its own dtype. Identity when nothing is armed, so the
    trainers call it before every train round. Returns whether it scaled."""
    factor = consume_learn_fault()
    if factor is None:
        return False
    import torch

    def tensors(obj: Any):
        if isinstance(obj, torch.nn.Module):
            yield from obj.parameters()
        elif torch.is_tensor(obj):
            yield obj
        else:
            for item in obj:
                yield from tensors(item)

    seen = set()
    with torch.no_grad():
        for t in tensors(target):
            if id(t) in seen or not t.is_floating_point():
                continue
            seen.add(id(t))
            t.mul_(torch.tensor(factor, dtype=t.dtype, device=t.device))
    return True


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


def _ckpt_kill_hook(stage: str, path: str) -> None:
    from sheeprl_tpu_torch.utils import checkpoint

    checkpoint._fault_hook = None  # one shot
    raise InjectedFaultError(
        f"resilience.fault=ckpt_kill: injected kill during checkpoint write (stage={stage}, path={path})"
    )


class FaultPlan:
    """The armed fault a loop (or the server's tick loop) drives with its step
    count. ``maybe_fire`` fires once per process (a process-wide ledger)."""

    def __init__(self, kind: str, at_policy_step: int, rank: Optional[int] = 0,
                 factor: float = DEFAULT_FACTOR) -> None:
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
            **({"factor": self.factor} if self.kind in ("lr_spike", "slow_tick", "session_flood") else {}),
        )
        if self.kind == "crash":
            raise InjectedFaultError(f"resilience.fault=crash: injected hard crash at policy step {policy_step}")
        if self.kind == "sigterm":
            signals.request_preemption()
        elif self.kind == "env_step":
            _env_fault_armed.set()
        elif self.kind == "ckpt_kill":
            from sheeprl_tpu_torch.utils import checkpoint

            checkpoint._fault_hook = _ckpt_kill_hook
        elif self.kind == "lr_spike":
            with _lock:
                _learn_fault_factor[0] = self.factor
        elif self.kind == "kill_rank":
            # a dead peer, not a crashing one: SIGKILL runs no cleanup at all
            import os
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGKILL)
        elif self.kind == "stale_heartbeat":
            _heartbeat_stale.set()
        elif self.kind == "channel_drop":
            from sheeprl_tpu_torch.parallel import distributed

            _channel_drop_armed.set()
            distributed._channel_drop_hook = _consume_channel_drop
        elif self.kind == "slow_tick":
            _slow_tick_seconds[0] = max(self.factor, 0.0) / 1000.0  # factor is milliseconds
        elif self.kind == "session_flood":
            with _lock:
                _session_flood[0] = max(int(self.factor), 1)
        elif self.kind == "reload_torn":
            _reload_torn_armed.set()


def build_fault_plan(resilience_cfg: Any, process_rank: Optional[int] = None) -> Optional[FaultPlan]:
    """The armed plan for THIS process, or None. ``fault.rank`` targets one
    process of a multi-process run (default 0, the driving rank); a process of
    another rank arms nothing."""
    spec = normalize_fault_cfg(resilience_cfg)
    if spec is None:
        return None
    target = 0 if spec["rank"] is None else int(spec["rank"])
    if process_rank is not None and target != int(process_rank):
        return None
    return FaultPlan(spec["kind"], spec["at"], rank=target, factor=spec["factor"])
