"""Numeric transforms (port of ``sheeprl_tpu/ops/math.py:21-29``:
``symlog`` and ``symexp``; the return math comes with the training slice)."""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """Inverse of symlog."""
    return torch.sign(x) * torch.expm1(torch.abs(x))
