"""Replay blocks on the device (port of the inline path and the device route
of ``sheeprl_tpu/data/prefetch.py``).

``buffer.prefetch.enabled=false`` is the only host path ported: one
``rb.sample`` call on the loop's thread, the host cast (image keys stay
uint8, the rest float32), then one copy to the device
(:func:`sample_to_device`). The prefetch thread is not yet ported; the CLI
refuses ``enabled=true`` for the host replay loops.

:func:`make_replay_sampler` with ``backend="device"`` returns the replay ring
on the device (``data/device_ring.py``), ``rb`` its durability twin; it
ignores the ``prefetch`` group, as the JAX route does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch


def sample_to_device(
    rb: Any, n_samples: int, *, uint8_keys: Sequence[str], device: Any, **sample_kwargs: Any
) -> Dict[str, torch.Tensor]:
    """``rb.sample(n_samples, **sample_kwargs)`` as tensors on ``device``: image
    keys (and their ``next_`` twins) stay uint8, everything else is float32."""
    device = torch.device(device)
    block = rb.sample(n_samples=n_samples, **sample_kwargs)
    out = {}
    for k, v in block.items():
        image = any(k == u or k.endswith(f"_{u}") for u in uint8_keys)
        t = torch.from_numpy(np.ascontiguousarray(v if image else np.asarray(v, dtype=np.float32)))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def make_replay_sampler(
    rb: Any,
    prefetch_cfg: Optional[Mapping[str, Any]] = None,
    *,
    sample_kwargs: Optional[Mapping[str, Any]] = None,
    transform: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
    uint8_keys: Optional[Sequence[str]] = None,
    backend: str = "local",
    seed: int = 0,
    device: Any = "cpu",
):
    """The replay sampler of ``backend``: ``device`` gives a
    :class:`~sheeprl_tpu_torch.data.device_ring.DeviceRingSampler` on
    ``device`` (``prefetch_cfg`` ignored; host transforms refused). The host
    replay loops sample inline through :func:`sample_to_device`, so the port
    has no sampler object for ``local``."""
    if backend != "device":
        raise NotImplementedError(
            f"buffer.backend={backend!r}: the port's host replay loops sample inline (sample_to_device); "
            "make_replay_sampler builds the device ring only"
        )
    from sheeprl_tpu_torch.data.device_ring import DeviceRingSampler

    if transform is not None or uint8_keys:
        raise ValueError("buffer.backend=device does not support host-side sample transforms")
    return DeviceRingSampler(rb, sample_kwargs, device=device, seed=seed)
