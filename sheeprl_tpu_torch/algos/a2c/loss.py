"""A2C losses (port of ``sheeprl_tpu/algos/a2c/loss.py``), each reduced by
``reduction`` (``sum`` by default, as ``configs/algo/a2c.yaml`` sets)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.ppo.loss import _reduce


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    """The vanilla policy gradient: ``-log pi(a|s) * A``."""
    return _reduce(-logprobs * advantages, reduction)


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    return _reduce((values - returns).square(), reduction)
