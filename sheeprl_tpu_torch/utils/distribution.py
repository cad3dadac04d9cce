"""Probability distributions (port of the classes of ``sheeprl_tpu/utils/distribution.py``
that the Dreamer family uses).

Small stateless classes over tensors, with the JAX package's formulas: the
same log-probs, entropies and modes. Samplers take their noise as an
argument, as the agent's functions do: standard normal noise for ``Normal``,
standard Gumbel noise for the categoricals (Gumbel-max, as
``jax.random.categorical`` samples). Straight-through gradients detach the
sample and add ``probs - probs.detach()``. ``TruncatedNormal`` (the
continuous actor of Dreamer-V1 and V2) samples by the inverse CDF from
uniform noise in [1e-6, 1 - 1e-6], as the JAX class draws it.

In bf16 the math follows JAX's type rules op by op: bf16 with float32 gives
float32, a Python constant takes the array's dtype (``weak_scalar``), and
where a JAX composition rounds to bf16 between its ops the same ops are
composed here (:func:`sigmoid`, :func:`softmax`, :func:`log_softmax`,
:func:`logsumexp`, the two-hot bins, ``logaddexp``) instead of torch's fused
kernels, which work in float32 inside and round once. In float32 the fused
kernels are kept.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.utils import symexp, symlog, weak_scalar

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _sum_rightmost(x: torch.Tensor, ndims: int) -> torch.Tensor:
    if ndims == 0:
        return x
    return x.sum(dim=tuple(range(-ndims, 0)))


def draw_gumbel(
    shape: Sequence[int], generator: Optional[torch.Generator], device, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Standard Gumbel noise in ``dtype`` (drawn in float32, then rounded):
    ``argmax(logits + g)`` is a categorical draw, the sum taken in the
    logits' dtype as ``jax.random.categorical`` takes it."""
    u = torch.rand(tuple(shape), device=device, generator=generator)
    return (-torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))).to(dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: in float32 torch's; otherwise JAX's lowering,
    ``1 / (1 + exp(-x))``, each op rounded to ``x``'s dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: in float32 torch's fused kernel; otherwise JAX's
    ops, each rounded to ``x``'s dtype: ``exp(x - max)`` over its sum."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    unnormalized = torch.exp(x - x.detach().amax(dim=dim, keepdim=True))
    return unnormalized / unnormalized.sum(dim=dim, keepdim=True)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax``: in float32 torch's fused kernel; otherwise
    ``shifted - log(sum(exp(shifted)))`` with ``shifted = x - max``, each op
    rounded to ``x``'s dtype."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim=dim)
    shifted = x - x.detach().amax(dim=dim, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.logsumexp`` over ``dim`` (kept): in float32 torch's fused
    kernel; otherwise ``log(sum(exp(x - max))) + max``, each op rounded."""
    if x.dtype == torch.float32:
        return torch.logsumexp(x, dim=dim, keepdim=True)
    amax = x.detach().amax(dim=dim, keepdim=True)
    return torch.log(torch.exp(x - amax).sum(dim=dim, keepdim=True)) + amax


def _linspace(low: float, high: float, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.linspace(low, high, n, dtype=dtype)``: in float32 torch's; in bf16
    JAX's bf16 arithmetic, ``low * (1 - step) + high * step`` with ``step =
    iota / (n - 1)``, each op rounded to bf16, then ``high``."""
    if dtype == torch.float32 or n < 2:
        return torch.linspace(low, high, n, dtype=dtype, device=device)
    div = torch.full((n - 1,), n - 1, dtype=dtype, device=device)
    step = torch.arange(n - 1, device=device).to(dtype) / div
    out = weak_scalar(low, dtype) * (1 - step) + weak_scalar(high, dtype) * step
    return torch.cat([out, torch.full((1,), high, dtype=dtype, device=device)])


class Distribution:
    """Minimal protocol: mean / mode / sample / log_prob / entropy."""

    @property
    def mean(self) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def mode(self) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def sample(self, noise: torch.Tensor) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def entropy(self) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def stddev(self) -> torch.Tensor:
        return self.scale

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return (self.loc + self.scale * noise).detach()

    def rsample(self, noise: torch.Tensor) -> torch.Tensor:
        """Reparameterised: gradients reach ``loc`` and ``scale``."""
        return self.loc + self.scale * noise

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = torch.square(self.scale)
        half_log_2pi = weak_scalar(_HALF_LOG_2PI, self.scale.dtype)
        return -torch.square(value - self.loc) / (2 * var) - torch.log(self.scale) - half_log_2pi

    def entropy(self) -> torch.Tensor:
        return weak_scalar(0.5 + _HALF_LOG_2PI, self.scale.dtype) + torch.log(self.scale)


class TruncatedNormal(Distribution):
    """Normal truncated to [low, high] (JAX ``TruncatedNormal``). ``rsample``
    takes ``u``, uniform noise in [1e-6, 1 - 1e-6] of ``loc``'s shape, maps it
    through the inverse CDF (``erfinv``) and clips to the bounds."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: float = -1.0, high: float = 1.0):
        self.loc = loc
        self.scale = scale
        self.low = low
        self.high = high
        self._alpha = (low - loc) / scale
        self._beta = (high - loc) / scale
        self._big_phi_alpha = 0.5 * (1 + torch.erf(self._alpha / math.sqrt(2.0)))
        self._big_phi_beta = 0.5 * (1 + torch.erf(self._beta / math.sqrt(2.0)))
        self._z = torch.clamp(self._big_phi_beta - self._big_phi_alpha, min=1e-8)

    @property
    def mean(self) -> torch.Tensor:
        phi_a = torch.exp(-0.5 * torch.square(self._alpha)) / math.sqrt(2 * math.pi)
        phi_b = torch.exp(-0.5 * torch.square(self._beta)) / math.sqrt(2 * math.pi)
        return self.loc + self.scale * (phi_a - phi_b) / self._z

    @property
    def mode(self) -> torch.Tensor:
        return torch.clamp(self.loc, self.low, self.high)

    def rsample(self, u: torch.Tensor) -> torch.Tensor:
        p = self._big_phi_alpha + u * (self._big_phi_beta - self._big_phi_alpha)
        raw = math.sqrt(2.0) * torch.erfinv(2 * p - 1)
        return torch.clamp(self.loc + self.scale * raw, self.low, self.high)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        std_lp = -torch.square((value - self.loc) / self.scale) / 2 - _HALF_LOG_2PI
        return std_lp - torch.log(self.scale) - torch.log(self._z)

    def entropy(self) -> torch.Tensor:
        # the JAX class's surrogate: the untruncated normal's entropy
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)


def draw_truncated_uniform(
    shape: Sequence[int], generator: Optional[torch.Generator], device, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The noise of :meth:`TruncatedNormal.rsample`: uniform in [1e-6, 1 - 1e-6]
    (``jax.random.uniform``'s ``minval``/``maxval`` form)."""
    u = torch.rand(tuple(shape), device=device, generator=generator)
    return (u * (1 - 2e-6) + 1e-6).to(dtype)


class Independent(Distribution):
    """Reinterprets the rightmost batch dims of a base distribution as event dims."""

    def __init__(self, base: Distribution, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.base.sample(noise)

    def rsample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.base.rsample(noise)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _sum_rightmost(self.base.log_prob(value), self.ndims)

    def entropy(self) -> torch.Tensor:
        return _sum_rightmost(self.base.entropy(), self.ndims)


class OneHotCategorical(Distribution):
    """One-hot-valued categorical over the last axis of ``logits``. The
    normalised logits are computed once, when a log-prob or an entropy first
    needs them: sampling, the mode and the probs read the logits as given."""

    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        if logits is None and probs is None:
            raise ValueError("either logits or probs must be given")
        if logits is None:
            logits = torch.log(torch.clamp(probs, min=1e-38))
        self._raw = logits

    @functools.cached_property
    def logits(self) -> torch.Tensor:
        return log_softmax(self._raw, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return softmax(self._raw, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        return F.one_hot(torch.argmax(self._raw, dim=-1), self._raw.shape[-1]).to(self._raw.dtype)

    def sample(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Gumbel-max: ``gumbel`` is standard Gumbel noise of the logits' shape."""
        idx = torch.argmax(self._raw + gumbel, dim=-1)
        return F.one_hot(idx, self._raw.shape[-1]).to(self._raw.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.logits * value, dim=-1)

    def entropy(self) -> torch.Tensor:
        return -torch.sum(self.probs * self.logits, dim=-1)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """Samples carry straight-through gradients with respect to the probs."""

    def rsample(self, gumbel: torch.Tensor) -> torch.Tensor:
        sample = self.sample(gumbel).detach()
        probs = self.probs
        return sample + probs - probs.detach()


class SymlogDistribution(Distribution):
    """-||pred - symlog(x)||^2 surrogate log-prob."""

    def __init__(self, mode: torch.Tensor, dims: int, dist: str = "mse", agg: str = "sum", tol: float = 1e-8):
        self._mode = mode
        self._dims = dims
        self._dist = dist
        self._agg = agg
        self._tol = tol

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(self._mode)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
        if self._dist == "mse":
            distance = torch.square(self._mode - symlog(value))
        elif self._dist == "abs":
            distance = torch.abs(self._mode - symlog(value))
        else:
            raise NotImplementedError(self._dist)
        distance = torch.where(distance < self._tol, torch.zeros_like(distance), distance)
        if self._agg == "mean":
            return -distance.mean(dim=tuple(range(-self._dims, 0)))
        if self._agg == "sum":
            return -_sum_rightmost(distance, self._dims)
        raise NotImplementedError(self._agg)


class MSEDistribution(Distribution):
    """-||pred - x||^2 surrogate log-prob."""

    def __init__(self, mode: torch.Tensor, dims: int, agg: str = "sum"):
        self._mode = mode
        self._dims = dims
        self._agg = agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    @property
    def mean(self) -> torch.Tensor:
        return self._mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
        distance = torch.square(self._mode - value)
        if self._agg == "mean":
            return -distance.mean(dim=tuple(range(-self._dims, 0)))
        if self._agg == "sum":
            return -_sum_rightmost(distance, self._dims)
        raise NotImplementedError(self._agg)


class TwoHotEncodingDistribution(Distribution):
    """Two-hot distribution over symexp-spaced bins: the reward and value head
    of Dreamer-V3."""

    def __init__(
        self,
        logits: torch.Tensor,
        dims: int = 0,
        low: float = -20.0,
        high: float = 20.0,
        transfwd: Callable[[torch.Tensor], torch.Tensor] = symlog,
        transbwd: Callable[[torch.Tensor], torch.Tensor] = symexp,
    ):
        self.logits = logits
        self.dims = dims
        self.bins = _linspace(low, high, logits.shape[-1], logits.dtype, logits.device)
        self.low = low
        self.high = high
        self.transfwd = transfwd
        self.transbwd = transbwd

    @property
    def probs(self) -> torch.Tensor:
        return softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        agg = torch.sum(self.probs * self.bins, dim=-1, keepdim=True)
        if self.dims > 1:
            agg = agg.sum(dim=tuple(range(-self.dims, -1)))
        return self.transbwd(agg)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transfwd(x)
        n_bins = self.bins.shape[-1]
        below = torch.sum((self.bins <= x).to(torch.int64), dim=-1, keepdim=True) - 1
        above = below + 1
        above = torch.clamp(above, max=n_bins - 1)
        below = torch.clamp(below, min=0)
        equal = below == above
        one = torch.ones((), dtype=x.dtype, device=x.device)
        dist_to_below = torch.where(equal, one, torch.abs(self.bins[below] - x))
        dist_to_above = torch.where(equal, one, torch.abs(self.bins[above] - x))
        total = dist_to_below + dist_to_above
        weight_below = dist_to_above / total
        weight_above = dist_to_below / total
        target = (
            F.one_hot(below, n_bins).to(self.logits.dtype) * weight_below[..., None]
            + F.one_hot(above, n_bins).to(self.logits.dtype) * weight_above[..., None]
        )[..., 0, :]
        log_pred = self.logits - logsumexp(self.logits, dim=-1)
        lp = torch.sum(target * log_pred, dim=-1, keepdim=True)
        return _sum_rightmost(lp, self.dims) if self.dims > 0 else lp[..., 0]


class Bernoulli(Distribution):
    def __init__(self, logits: Optional[torch.Tensor] = None, probs: Optional[torch.Tensor] = None):
        if logits is None and probs is None:
            raise ValueError("either logits or probs must be given")
        if logits is None:
            probs = torch.clamp(probs, 1e-7, 1 - 1e-7)
            logits = torch.log(probs) - torch.log1p(-probs)
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return sigmoid(self.logits)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        # -log(1 + exp(-l)) where the value is 1, -log(1 + exp(l)) where it is 0
        x = torch.where(value > 0.5, -self.logits, self.logits)
        if x.dtype == torch.float32:
            return -F.softplus(x)
        # jnp.logaddexp(0, x) in x's dtype, op by op
        return -(torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x))))

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -(p * torch.log(torch.clamp(p, min=1e-8)) + (1 - p) * torch.log(torch.clamp(1 - p, min=1e-8)))


class BernoulliSafeMode(Bernoulli):
    """Bernoulli whose mode never NaNs at p = 0.5: the continue head of Dreamer."""
