"""Minimal observation and action spaces: the parts of gymnasium's ``Box``,
``Discrete``, ``MultiDiscrete`` and ``Dict`` that the port's envs, wrappers, vector envs and
agent read (gymnasium is not a dependency of the port).

Each space keeps a numpy ``Generator``, seeded by :meth:`seed`, for
:meth:`sample`. Draws follow gymnasium's rules (uniform in a bounded float
``Box``, normal where unbounded, exponential where half-bounded, uniform
integers in an integer ``Box``, ``Discrete`` and ``MultiDiscrete``), not
its bit streams.
``Dict`` keeps its keys sorted, as gymnasium's ``Dict`` does for a plain
mapping.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np


class Space:
    """A space with its own numpy ``Generator`` (``np_random``)."""

    shape: Tuple[int, ...] = ()

    def __init__(self, seed: Optional[int] = None) -> None:
        self._np_random: Optional[np.random.Generator] = None
        if seed is not None:
            self.seed(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed(None)
        return self._np_random

    def seed(self, seed: Optional[int] = None) -> Any:
        self._np_random = np.random.default_rng(seed)
        return seed

    def sample(self) -> Any:
        raise NotImplementedError

    def contains(self, x: Any) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32, seed: Optional[int] = None) -> None:
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)
        super().__init__(seed)

    def sample(self) -> np.ndarray:
        if self.dtype.kind in "iu":
            high = self.high.astype(np.int64) + 1
            return self.np_random.integers(self.low.astype(np.int64), high, size=self.shape).astype(self.dtype)
        lo_ok, hi_ok = np.isfinite(self.low), np.isfinite(self.high)
        low = np.where(lo_ok, self.low, 0.0).astype(np.float64)
        high = np.where(hi_ok, self.high, 0.0).astype(np.float64)
        rng = self.np_random
        uniform = rng.uniform(low, np.where(hi_ok, high, 1.0), self.shape)
        exponential, normal = rng.exponential(size=self.shape), rng.normal(size=self.shape)
        out = np.select([lo_ok & hi_ok, lo_ok, hi_ok], [uniform, low + exponential, high - exponential], normal)
        return out.astype(self.dtype)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(
            np.can_cast(x.dtype, self.dtype) and x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high)
        )

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Box)
            and self.shape == other.shape
            and self.dtype == other.dtype
            and np.array_equal(self.low, other.low)
            and np.array_equal(self.high, other.high)
        )

    def __repr__(self) -> str:
        lo, hi = (v.flat[0] if v.size and np.all(v == v.flat[0]) else v for v in (self.low, self.high))
        return f"Box({lo}, {hi}, {self.shape}, {self.dtype})"


class Discrete(Space):
    def __init__(self, n: int, seed: Optional[int] = None) -> None:
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)
        super().__init__(seed)

    def sample(self) -> np.int64:
        return np.int64(self.np_random.integers(self.n))

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(x.shape == () and x.dtype.kind in "iu" and 0 <= int(x) < self.n)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Discrete) and self.n == other.n

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """One ``Discrete(n)`` per entry of ``nvec``, as an int64 vector."""

    def __init__(self, nvec: Sequence[int], seed: Optional[int] = None) -> None:
        self.nvec = np.asarray(nvec, dtype=np.int64)
        if self.nvec.ndim != 1 or (self.nvec <= 0).any():
            raise ValueError(f"MultiDiscrete needs a vector of positive sizes, got {nvec!r}")
        self.shape = tuple(self.nvec.shape)
        self.dtype = np.dtype(np.int64)
        super().__init__(seed)

    def sample(self) -> np.ndarray:
        return self.np_random.integers(0, self.nvec).astype(self.dtype)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(x.shape == self.shape and x.dtype.kind in "iu" and np.all(x >= 0) and np.all(x < self.nvec))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MultiDiscrete) and np.array_equal(self.nvec, other.nvec)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Dict(Space):
    def __init__(self, spaces: Mapping[str, Space], seed: Optional[int] = None) -> None:
        self.spaces = dict(sorted(dict(spaces).items()))
        super().__init__(seed)

    def seed(self, seed: Optional[int] = None) -> Any:
        super().seed(seed)
        # each subspace gets its own stream, derived from this one
        for space, child in zip(self.spaces.values(), np.random.SeedSequence(seed).spawn(len(self.spaces))):
            space.seed(int(child.generate_state(1)[0]))
        return seed

    def sample(self) -> dict:
        return {k: s.sample() for k, s in self.spaces.items()}

    def contains(self, x: Any) -> bool:
        return isinstance(x, Mapping) and set(x) == set(self.spaces) and all(s.contains(x[k]) for k, s in self.spaces.items())

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __setitem__(self, key: str, value: Space) -> None:
        self.spaces[key] = value

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Dict) and self.spaces == other.spaces

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {s}" for k, s in self.spaces.items()) + ")"


def action_dims(action_space) -> Tuple[Tuple[int, ...], bool]:
    """``(actions_dim, is_continuous)`` for a Box, Discrete or MultiDiscrete
    action space (``sheeprl_tpu/utils/evaluation.py::action_dims``): a
    MultiDiscrete space gives one size per sub-action."""
    if isinstance(action_space, Box):
        return tuple(action_space.shape), True
    if isinstance(action_space, Discrete):
        return (action_space.n,), False
    if isinstance(action_space, MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec), False
    raise TypeError(f"unsupported action space {action_space!r}")
