"""Minimal observation and action spaces: the parts of gymnasium's ``Box``,
``Discrete`` and ``Dict`` that the port's envs and agent read (gymnasium is
not a dependency of the port)."""

from __future__ import annotations

from typing import Dict as _Dict
from typing import Sequence, Tuple

import numpy as np


class Box:
    def __init__(self, low, high, shape: Sequence[int], dtype=np.float32) -> None:
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)


class Discrete:
    def __init__(self, n: int) -> None:
        self.n = int(n)
        self.shape: Tuple[int, ...] = ()


class Dict:
    def __init__(self, spaces: _Dict[str, Box]) -> None:
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Box:
        return self.spaces[key]


def action_dims(action_space) -> Tuple[Tuple[int, ...], bool]:
    """``(actions_dim, is_continuous)`` for a Box or Discrete action space
    (``sheeprl_tpu/utils/evaluation.py::action_dims``)."""
    if isinstance(action_space, Box):
        return tuple(action_space.shape), True
    if isinstance(action_space, Discrete):
        return (action_space.n,), False
    raise TypeError(f"unsupported action space {action_space!r}")
