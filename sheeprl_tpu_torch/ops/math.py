"""Numeric transforms (port of ``sheeprl_tpu/ops/math.py``: ``symlog`` and
``symexp`` :21-29, ``two_hot_encoder``/``two_hot_decoder`` :31-64,
``gae`` :65-104, ``compute_lambda_values`` :107-127, ``normalize`` :183 and the Moments
return normaliser :208-242).

The reverse-time recurrence is a Python loop where the JAX package scans.
The two-hot supports come from ``torch.linspace``, which may put a bin one
ulp away from ``jnp.linspace``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """Inverse of symlog."""
    return torch.sign(x) * torch.expm1(torch.abs(x))


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Two-hot encoding of ``x [..., 1]`` on the odd uniform support
    ``[-support_range, support_range]``; returns ``[..., num_buckets]``."""
    if x.ndim == 0:
        x = x[None]
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    x = x.clamp(-support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    bucket_size = buckets[1] - buckets[0] if num_buckets > 1 else torch.ones((), dtype=x.dtype, device=x.device)
    right_idxs = torch.searchsorted(buckets, x.contiguous(), side="left")
    left_idxs = (right_idxs - 1).clamp(0, num_buckets - 1)
    left_weight = (buckets[right_idxs] - x).abs() / bucket_size
    right_weight = 1.0 - left_weight
    one_hot_left = F.one_hot(left_idxs[..., 0], num_buckets).to(x.dtype)
    one_hot_right = F.one_hot(right_idxs[..., 0], num_buckets).to(x.dtype)
    return one_hot_left * left_weight + one_hot_right * right_weight


def two_hot_decoder(x: torch.Tensor, support_range: int) -> torch.Tensor:
    """Expected value under a two-hot vector: ``[..., num_buckets]`` ->
    ``[..., 1]``."""
    num_buckets = x.shape[-1]
    if num_buckets % 2 == 0:
        raise ValueError("support_size must be odd")
    support = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    return (x * support).sum(-1, keepdim=True)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a time-major ``[T, ...]``
    rollout, where ``dones[t]`` flags the current observation (CleanRL's
    convention): ``delta_t = r_t + gamma * nd_t * V_{t+1} - V_t`` and
    ``A_t = delta_t + gamma * lambda * nd_t * A_{t+1}``, a reverse loop over
    T; ``next_value [...]`` bootstraps the step after ``T - 1``. Returns
    ``(returns, advantages)``."""
    not_dones = 1.0 - dones.to(values.dtype)
    next_values = torch.cat([values[1:], next_value[None]], 0)
    adv = torch.zeros_like(next_value)
    advantages = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * not_dones[t] - values[t]
        adv = delta + gamma * gae_lambda * not_dones[t] * adv
        advantages.append(adv)
    advantages = torch.stack(advantages[::-1])
    return advantages + values, advantages


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(lambda) returns of an imagined rollout, time-major ``[T, ...]``:
    ``R_t = r_t + c_t * [(1 - lambda) * v_t + lambda * R_{t+1}]`` with the
    bootstrap ``R_T = v_{T-1}``."""
    interm = rewards + continues * values * (1 - lmbda)
    carry = values[-1]
    out = []
    for t in reversed(range(rewards.shape[0])):
        carry = interm[t] + continues[t] * lmbda * carry
        out.append(carry)
    return torch.stack(out[::-1])


def normalize(x: torch.Tensor, eps: float = 1e-8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standardise ``x`` by its mean and unbiased std (over ``mask``'s
    positions where given); keeps the shape."""
    if mask is None:
        mean = x.mean()
        std = x.std(correction=1)
    else:
        m = mask.to(x.dtype)
        n = m.sum().clamp_min(1.0)
        mean = (x * m).sum() / n
        var = ((x - mean).square() * m).sum() / (n - 1.0).clamp_min(1.0)
        std = var.sqrt()
    return (x - mean) / (std + eps)


@dataclass
class MomentsState:
    """Percentile-EMA return normaliser state (two fp32 scalars)."""

    low: torch.Tensor
    high: torch.Tensor


def init_moments(device: Optional[torch.device] = None) -> MomentsState:
    return MomentsState(
        low=torch.zeros((), dtype=torch.float32, device=device),
        high=torch.zeros((), dtype=torch.float32, device=device),
    )


def update_moments(
    state: MomentsState,
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1e8,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[MomentsState, Tuple[torch.Tensor, torch.Tensor]]:
    """EMA of the (low, high) percentiles of ``x`` (linear interpolation, as
    ``jnp.quantile``); returns ``(new_state, (low, invscale))``, both out of
    the gradient."""
    x = x.detach().float().flatten()
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state.low + (1 - decay) * low
    new_high = decay * state.high + (1 - decay) * high
    invscale = torch.clamp_min(new_high - new_low, 1.0 / max_)
    return MomentsState(low=new_low, high=new_high), (new_low, invscale)
