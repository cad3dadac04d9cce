"""Optimizers from the config tree's torch-style keys (port of
``sheeprl_tpu/optim/__init__.py``: ``adam`` and ``rmsprop``).

``adam`` is ``optax.adam`` (``torch.optim.Adam``) without weight decay and
``optax.adamw`` (``torch.optim.AdamW``, decoupled decay) with it; both compute
the same update. ``rmsprop`` is ``optax.rmsprop``, written out here because
``torch.optim.RMSprop`` is another function: optax scales a gradient by
``rsqrt(nu + eps)`` (eps inside the square root), torch divides it by
``sqrt(nu) + eps``; with ``nu`` starting at 0 the two differ most at the
first steps. :func:`clip_grad_global_norm_` is ``optax.clip_by_global_norm``:
above the threshold every gradient is scaled by ``clip / norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead, a
different function). :func:`linear_schedule` and :func:`set_scheduled_lr` are
``optax.linear_schedule`` under ``optax.scale_by_schedule``: the learning rate
of an update is the schedule at the number of updates taken before it, a
count the optimizer's param groups keep (``schedule_count``) so that it rides
in the optimizer's state dict.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

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


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (``eps_in_sqrt=True``, ``initial_scale=0``), with the
    JAX package's ``weight_decay`` added to the gradient first. Per parameter:
    ``nu = decay nu + (1 - decay) g^2``; centered, also ``mu = decay mu + (1 -
    decay) g`` and ``nu - mu^2`` in place of ``nu``; the update is
    ``-lr g rsqrt(nu + eps)``; with momentum it goes through optax's trace,
    ``trace = update + momentum trace``, after the learning rate. The state
    keeps optax's names: ``nu``, ``mu``, ``trace``."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float = 1e-2,
        alpha: float = 0.99,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        momentum: float = 0.0,
        centered: bool = False,
    ) -> None:
        defaults = dict(
            lr=float(lr), alpha=float(alpha), eps=float(eps), weight_decay=float(weight_decay),
            momentum=float(momentum), centered=bool(centered),
        )
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure: Callable = None):
        if closure is not None:
            raise ValueError("RMSprop.step takes no closure")
        for group in self.param_groups:
            decay, eps, lr = group["alpha"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if group["centered"]:
                        state["mu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                if group["centered"]:
                    mu = state["mu"]
                    mu.copy_((1 - decay) * g + decay * mu)
                    update = g * torch.rsqrt(nu - mu * mu + eps) * -lr
                else:
                    update = g * torch.rsqrt(nu + eps) * -lr
                if group["momentum"]:
                    trace = state["trace"]
                    trace.copy_(update + group["momentum"] * trace)
                    update = trace
                p.add_(update)


def rmsprop(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-2,
    alpha: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum: float = 0.0,
    centered: bool = False,
    **_: Any,
) -> RMSprop:
    return RMSprop(params, lr=lr, alpha=alpha, eps=eps, weight_decay=weight_decay, momentum=momentum, centered=centered)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``init`` to ``end`` over ``transition_steps``
    updates, then ``end``."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(init_value)
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def set_scheduled_lr(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]) -> None:
    """Before an update: every group's lr is ``schedule(count)``, ``count`` the
    updates taken before this one, which then counts it."""
    for group in optimizer.param_groups:
        count = int(group.get("schedule_count", 0))
        group["lr"] = schedule(count)
        group["schedule_count"] = count + 1
