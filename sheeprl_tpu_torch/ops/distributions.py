"""Distributions (port of ``sheeprl_tpu/ops/distributions.py``: ``Normal``,
``Independent``, ``TruncatedNormal`` :132-200, ``TanhNormal`` :201-241, ``Categorical`` :243-268,
``OneHotCategorical`` and
``OneHotCategoricalStraightThrough`` :272-336, the Dreamer-V3 heads
``SymlogDistribution``, ``MSEDistribution``, ``TwoHotEncodingDistribution``
and ``Bernoulli`` :338-490, and ``kl_divergence`` :503).

Each sampler takes an explicit ``torch.Generator`` where the JAX package
takes a PRNG key. The two never draw the same numbers from one seed, so the
tests compare the samplers by their frequencies, not draw by draw.
"""

from __future__ import annotations

import math as _math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops.math import symexp, symlog

_LOG_INV_SQRT_2PI = -0.5 * _math.log(2 * _math.pi)
_LOG_SQRT_2PI_E = 0.5 * _math.log(2 * _math.pi * _math.e)


class Normal:
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc, self.scale = torch.broadcast_tensors(loc, scale)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def stddev(self) -> torch.Tensor:
        return self.scale

    def _eps(self, generator: Optional[torch.Generator], sample_shape: Tuple[int, ...]) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        return torch.randn(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        with torch.no_grad():
            return self.loc + self._eps(generator, sample_shape) * self.scale

    def rsample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.loc + self._eps(generator, sample_shape) * self.scale

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        return _LOG_INV_SQRT_2PI - torch.log(self.scale) - 0.5 * z.square()

    def entropy(self) -> torch.Tensor:
        return _LOG_SQRT_2PI_E + torch.log(self.scale)


def _std_normal_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x.square()) / _math.sqrt(2 * _math.pi)


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / _math.sqrt(2.0)))


def _std_normal_icdf(p: torch.Tensor) -> torch.Tensor:
    return _math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)


class TruncatedNormal:
    """The normal ``N(loc, scale)`` truncated to the finite ``[low, high]``
    in closed form (JAX ``ops/distributions.py:132-200``; the Dreamer-V1/V2
    continuous actors): ``rsample`` through the inverse CDF of a uniform
    draw in ``[eps, 1 - eps]``, which ``uniform`` (the caller's noise) can
    replace."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> None:
        self.loc, self.scale, self.low, self.high = loc, scale, low, high

    @property
    def _a(self) -> torch.Tensor:
        return (self.low - self.loc) / self.scale

    @property
    def _b(self) -> torch.Tensor:
        return (self.high - self.loc) / self.scale

    @property
    def _Z(self) -> torch.Tensor:
        eps = torch.finfo(self.loc.dtype).eps
        return torch.clamp_min(_std_normal_cdf(self._b) - _std_normal_cdf(self._a), eps)

    @property
    def mean(self) -> torch.Tensor:
        num = _std_normal_pdf(self._b) - _std_normal_pdf(self._a)
        return self.loc + self.scale * (-num / self._Z)

    @property
    def mode(self) -> torch.Tensor:
        return torch.minimum(torch.maximum(self.loc, self.low), self.high)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        return _LOG_INV_SQRT_2PI - torch.log(self._Z) - 0.5 * z.square() - torch.log(self.scale)

    def icdf(self, p: torch.Tensor) -> torch.Tensor:
        std = _std_normal_icdf(_std_normal_cdf(self._a) + p * self._Z)
        return self.loc + self.scale * std

    def uniform(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """The ``[*sample_shape, *batch]`` uniform draw ``rsample`` maps."""
        shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))
        eps = torch.finfo(self.loc.dtype).eps
        u = torch.rand(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return eps + u * (1 - 2 * eps)

    def rsample(
        self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = (), uniform: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self.icdf(self.uniform(generator, sample_shape) if uniform is None else uniform)

    def sample(
        self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = (), uniform: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(generator, sample_shape, uniform)

    def entropy(self) -> torch.Tensor:
        a, b, Z = self._a, self._b, self._Z
        t1 = (b * _std_normal_pdf(b) - a * _std_normal_pdf(a)) / Z
        return _LOG_SQRT_2PI_E + torch.log(Z) - 0.5 * t1 + torch.log(self.scale)


class Independent:
    """Sums log_prob/entropy over the last ``reinterpreted_batch_ndims`` dims."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1) -> None:
        self.base = base
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

    @property
    def _dims(self) -> Tuple[int, ...]:
        return tuple(range(-self.reinterpreted_batch_ndims, 0))

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.base.sample(generator, sample_shape)

    def rsample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return self.base.rsample(generator, sample_shape)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self.base.log_prob(value).sum(dim=self._dims)

    def entropy(self) -> torch.Tensor:
        return self.base.entropy().sum(dim=self._dims)


class Categorical:
    """Integer-support categorical over the last axis of ``logits``.
    ``sample`` is the Gumbel-max draw of ``jax.random.categorical``
    (``argmax(logits - log(-log(u)))``, ``u`` uniform in ``[tiny, 1)``):
    one ``torch.rand`` of the logits' shape, which a CUDA graph captures
    with its generator."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.logits = logits

    @property
    def log_probs(self) -> torch.Tensor:
        return F.log_softmax(self.logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return self.logits.argmax(-1)

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.logits.shape)
        with torch.no_grad():
            u = torch.rand(shape, generator=generator, device=self.logits.device, dtype=self.logits.dtype)
            tiny = torch.finfo(self.logits.dtype).tiny
            return (self.logits - torch.log(-torch.log(u.clamp_min(tiny)))).argmax(-1)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self.log_probs.gather(-1, value.long().unsqueeze(-1)).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs
        return -(lp.exp() * lp).sum(-1)


class OneHotCategorical:
    """One-hot-coded categorical over the last axis of ``logits``."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.logits = logits

    @property
    def log_probs(self) -> torch.Tensor:
        return F.log_softmax(self.logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        n = self.logits.shape[-1]
        return F.one_hot(self.logits.argmax(-1), n).to(self.logits.dtype)

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        n = self.logits.shape[-1]
        batch = tuple(self.logits.shape[:-1])
        with torch.no_grad():
            flat = self.probs.reshape(-1, n)
            idx = torch.multinomial(flat, _numel(sample_shape), replacement=True, generator=generator)
            # [rows, samples] -> [*sample_shape, *batch]
            idx = idx.t().reshape(*sample_shape, *batch)
            return F.one_hot(idx, n).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return (value * self.log_probs).sum(-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs
        return -(lp.exp() * lp).sum(-1)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """Straight-through reparameterisation: ``sample + (probs - sg(probs))``
    equals the one-hot in the forward pass and carries the gradient of
    ``probs`` in the backward pass. The RSSM latent sampler."""

    def rsample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        samples = self.sample(generator, sample_shape)
        probs = self.probs
        return samples + (probs - probs.detach())


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class TanhNormal:
    """Tanh-squashed Gaussian ``a = tanh(u), u ~ N(loc, scale)``, the
    log-prob corrected in the stable softplus form."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc, self.scale = torch.broadcast_tensors(loc, scale)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    @staticmethod
    def _log_det(u: torch.Tensor) -> torch.Tensor:
        # log|d tanh(u)/du| = log(1 - tanh(u)^2) = 2*(log2 - u - softplus(-2u))
        return 2.0 * (_math.log(2.0) - u - F.softplus(-2.0 * u))

    def rsample_and_log_prob(self, generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        base = Normal(self.loc, self.scale)
        u = base.rsample(generator)
        return torch.tanh(u), base.log_prob(u) - self._log_det(u)

    def rsample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        return torch.tanh(Normal(self.loc, self.scale).rsample(generator, sample_shape))

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(generator, sample_shape)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        u = torch.atanh(value.clamp(-1 + 1e-6, 1 - 1e-6))
        return Normal(self.loc, self.scale).log_prob(u) - self._log_det(u)

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError("TanhNormal has no closed-form entropy")


# --------------------------------------------------------------------------- #
# Dreamer-V3 heads
# --------------------------------------------------------------------------- #


def _neg_dims(dims: int) -> Tuple[int, ...]:
    return tuple(-x for x in range(1, dims + 1))


def _reduce(distance: torch.Tensor, dims: int, agg: str) -> torch.Tensor:
    if agg == "mean":
        return distance.mean(dim=_neg_dims(dims))
    if agg == "sum":
        return distance.sum(dim=_neg_dims(dims))
    raise NotImplementedError(agg)


class SymlogDistribution:
    """``log_prob = -(pred - symlog(x))^2`` summed over the last ``dims``
    axes, distances under ``tol`` zeroed; mean and mode are ``symexp(pred)``
    (the vector decoder's head)."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, dist: str = "mse", agg: str = "sum", tol: float = 1e-8):
        self._mode, self.dims, self.dist, self.agg, self.tol = mode, dims, dist, agg, tol

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(self._mode)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
        if self.dist == "mse":
            distance = (self._mode - symlog(value)).square()
        elif self.dist == "abs":
            distance = (self._mode - symlog(value)).abs()
        else:
            raise NotImplementedError(self.dist)
        distance = torch.where(distance < self.tol, torch.zeros_like(distance), distance)
        return -_reduce(distance, self.dims, self.agg)


class MSEDistribution:
    """Negative squared error as log_prob (the image decoder's head)."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, agg: str = "sum") -> None:
        self._mode, self.dims, self.agg = mode, dims, agg

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    @property
    def mean(self) -> torch.Tensor:
        return self._mode

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
        return -_reduce((self._mode - value).square(), self.dims, self.agg)


class TwoHotEncodingDistribution:
    """Two-hot distribution over a symlog support of ``logits.shape[-1]``
    bins in ``[low, high]`` (the reward and critic heads):
    ``mean = symexp(sum(softmax(logits) * bins))``; ``log_prob`` is the
    cross-entropy against the two-hot encoding of ``symlog(x)``."""

    def __init__(
        self,
        logits: torch.Tensor,
        dims: int = 0,
        low: float = -20.0,
        high: float = 20.0,
        transfwd: Callable[[torch.Tensor], torch.Tensor] = symlog,
        transbwd: Callable[[torch.Tensor], torch.Tensor] = symexp,
    ) -> None:
        self.logits, self.dims, self.low, self.high = logits, dims, low, high
        self.transfwd, self.transbwd = transfwd, transbwd

    @property
    def bins(self) -> torch.Tensor:
        lg = self.logits
        return torch.linspace(self.low, self.high, lg.shape[-1], dtype=lg.dtype, device=lg.device)

    @property
    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, -1)

    def _dims(self) -> Tuple[int, ...]:
        return _neg_dims(self.dims) if self.dims else (-1,)

    @property
    def mean(self) -> torch.Tensor:
        return self.transbwd((self.probs * self.bins).sum(dim=self._dims(), keepdim=True))

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        bins = self.bins
        n = bins.shape[0]
        x = self.transfwd(x)
        below = (bins <= x).to(torch.int64).sum(-1, keepdim=True) - 1
        above = torch.clamp_max(below + 1, n - 1)
        below = torch.clamp_min(below, 0)
        equal = below == above
        one = torch.ones_like(x)
        dist_to_below = torch.where(equal, one, (bins[below] - x).abs())
        dist_to_above = torch.where(equal, one, (bins[above] - x).abs())
        total = dist_to_below + dist_to_above
        weight_below = dist_to_above / total
        weight_above = dist_to_below / total
        target = (
            F.one_hot(below, n).to(self.logits.dtype) * weight_below[..., None]
            + F.one_hot(above, n).to(self.logits.dtype) * weight_above[..., None]
        )[..., 0, :]
        return (target * F.log_softmax(self.logits, -1)).sum(dim=self._dims())


class Bernoulli:
    """Bernoulli over logits with the NaN-free mode ``p > 0.5`` (the
    continue head)."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)

    def sample(self, generator: Optional[torch.Generator] = None, sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.logits.shape)
        u = torch.rand(shape, generator=generator, device=self.logits.device, dtype=self.logits.dtype)
        return (u < self.probs.detach()).to(self.logits.dtype)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        lg = self.logits
        return -torch.clamp_min(lg, 0) + lg * value - torch.log1p(torch.exp(-lg.abs()))

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -(p * F.logsigmoid(self.logits) + (1 - p) * F.logsigmoid(-self.logits))


def kl_divergence(p, q) -> torch.Tensor:
    """KL(p || q) for (Independent of) one-hot categoricals or normals."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        return kl_divergence(p.base, q.base).sum(dim=p._dims)
    if isinstance(p, OneHotCategorical) and isinstance(q, OneHotCategorical):
        p_lp, q_lp = p.log_probs, q.log_probs
        return (p_lp.exp() * (p_lp - q_lp)).sum(-1)
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale).square()
        t1 = ((p.loc - q.loc) / q.scale).square()
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    raise NotImplementedError(f"kl_divergence not defined for {type(p).__name__} x {type(q).__name__}")
