"""Distributions of the acting path (port of
``sheeprl_tpu/ops/distributions.py:57-130,272-336``: ``Normal``,
``Independent``, ``OneHotCategorical`` and
``OneHotCategoricalStraightThrough``).

Each sampler takes an explicit ``torch.Generator`` where the JAX package
takes a PRNG key. The two never draw the same numbers from one seed, so the
tests compare the samplers by their frequencies, not draw by draw.
"""

from __future__ import annotations

import math as _math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
