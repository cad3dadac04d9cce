"""Replay blocks on the device (port of the inline path of
``sheeprl_tpu/data/prefetch.py``).

``buffer.prefetch.enabled=false`` is the only path ported: one ``rb.sample``
call on the loop's thread, the host cast (image keys stay uint8, the rest
float32), then one copy to the device. The prefetch thread is not yet ported;
the CLI refuses ``enabled=true``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

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
