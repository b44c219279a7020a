"""SAC losses (port of ``sheeprl_tpu/algos/sac/loss.py``)."""

from __future__ import annotations

import torch


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    """Eq. 7 of the SAC paper."""
    return ((alpha * logprobs) - qf_values).mean()


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor, num_critics: int) -> torch.Tensor:
    """Eq. 5: the sum over the critics of each one's MSE to the shared
    target."""
    return sum(torch.mean(torch.square(qf_values[..., i : i + 1] - next_qf_value)) for i in range(num_critics))


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """Eq. 17."""
    return (-log_alpha * (logprobs + target_entropy)).mean()
