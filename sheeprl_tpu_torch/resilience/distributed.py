"""The channel hooks of the multi-process runs (port of
``RankFailureError``, ``channel_abort_check`` and ``channel_options`` of
``sheeprl_tpu/resilience/distributed.py``).

The JAX package's coordinator (heartbeats, preemption agreement, manifests,
``supervise_gang``) is not ported yet, so :func:`channel_abort_check` has no
verdict to read and returns: a bounded channel wait then ends on its own
timeout or on a peer's failure marker only.
"""

from __future__ import annotations

from typing import Any, Dict


class RankFailureError(RuntimeError):
    """A peer process of this run was declared dead. Raised from bounded
    channel waits so that no process blocks forever on a dead peer."""


def channel_abort_check() -> None:
    """The ``abort_check`` bounded channel waits run between slices: raises
    :class:`RankFailureError` once a peer is declared dead. Without a
    coordinator (not ported yet) nothing declares one."""


def channel_options(cfg: Any) -> Dict[str, Any]:
    """Keyword arguments of :class:`~sheeprl_tpu_torch.parallel.distributed.BroadcastChannel`
    from ``resilience.distributed.channel`` (``timeout`` and ``poll``, in
    seconds), with the abort hook."""
    ccfg = (((cfg.get("resilience") or {}).get("distributed") or {}).get("channel")) or {}
    return {
        "timeout_s": float(ccfg.get("timeout") or 1800.0),
        "poll_s": float(ccfg.get("poll") or 30.0),
        "abort_check": channel_abort_check,
    }
