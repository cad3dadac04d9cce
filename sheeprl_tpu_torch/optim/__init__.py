"""Optimizers from the config tree's torch-style keys (port of the part of
``sheeprl_tpu/optim/__init__.py`` Dreamer-V3 uses).

``adam`` is ``optax.adam`` (``torch.optim.Adam``) without weight decay and
``optax.adamw`` (``torch.optim.AdamW``, decoupled decay) with it; both compute
the same update. :func:`clip_grad_global_norm_` is
``optax.clip_by_global_norm``: above the threshold every gradient is scaled by
``clip / norm`` (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
instead, a different function).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import torch


def adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-3,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    betas: Sequence[float] = (0.9, 0.999),
    **_: Any,
) -> torch.optim.Optimizer:
    kwargs = dict(lr=float(lr), betas=(float(betas[0]), float(betas[1])), eps=float(eps))
    if weight_decay and weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=float(weight_decay), **kwargs)
    return torch.optim.Adam(params, weight_decay=0.0, **kwargs)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


@torch.no_grad()
def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], clip: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``clip / norm`` when their
    global norm is at or above ``clip`` (``optax.clip_by_global_norm``).
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    if clip is not None and clip > 0:
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        for g in grads:
            g.mul_(scale)
    return norm
