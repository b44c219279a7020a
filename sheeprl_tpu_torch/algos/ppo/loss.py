"""PPO losses (port of ``sheeprl_tpu/algos/ppo/loss.py``), each reduced
over the minibatch by ``reduction`` (``mean``, ``sum`` or ``none``)."""

from __future__ import annotations

from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    reduction = reduction.lower()
    if reduction == "none":
        return x
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise ValueError(f"Unrecognized reduction: {reduction}")


def policy_loss(
    new_logprobs: torch.Tensor,
    logprobs: torch.Tensor,
    advantages: torch.Tensor,
    clip_coef: Scalar,
    reduction: str = "mean",
) -> torch.Tensor:
    """The clipped surrogate objective, eq. (7) of the PPO paper."""
    ratio = torch.exp(new_logprobs - logprobs)
    pg_loss1 = advantages * ratio
    pg_loss2 = advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
    return _reduce(-torch.minimum(pg_loss1, pg_loss2), reduction)


def value_loss(
    new_values: torch.Tensor,
    old_values: torch.Tensor,
    returns: torch.Tensor,
    clip_coef: Scalar,
    clip_vloss: bool,
    reduction: str = "mean",
) -> torch.Tensor:
    """Squared error to the returns; with ``clip_vloss`` the new values are
    kept within ``clip_coef`` of the old ones first."""
    if clip_vloss:
        values_pred = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    else:
        values_pred = new_values
    return _reduce((values_pred - returns).square(), reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce(-entropy, reduction)
