"""Host and device memory gauges of the telemetry windows (port of
``_rss_bytes``, ``rss_peak_bytes`` and ``device_memory`` of
``sheeprl_tpu/obs/telemetry.py``; the run telemetry of the training loops is
not yet ported)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _rss_bytes() -> Optional[int]:
    """Current resident set size of this process (Linux /proc, cheap)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return None


def rss_peak_bytes() -> Optional[int]:
    """Peak RSS (``ru_maxrss`` is KiB on Linux)."""
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return None


def device_memory(device: Any) -> Optional[Dict[str, int]]:
    """``{bytes_in_use, peak_bytes}`` of a CUDA device from the caching
    allocator's ``torch.cuda.memory_stats`` (``allocated_bytes.all.current``
    and ``.peak``), with ``num_allocs`` and the card's ``bytes_limit``; None
    for the CPU, as the JAX function gives for a host. Reading the allocator's
    counters does not synchronize the card."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:
        return None
    if not stats or "allocated_bytes.all.current" not in stats:
        return None
    out = {
        "bytes_in_use": int(stats["allocated_bytes.all.current"]),
        "peak_bytes": int(stats["allocated_bytes.all.peak"]),
    }
    if "allocation.all.allocated" in stats:
        out["num_allocs"] = int(stats["allocation.all.allocated"])
    try:
        out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    except Exception:
        pass
    return out
