"""Host replay buffers in numpy (port of ``sheeprl_tpu/data/buffers.py``:
``ReplayBuffer`` :79, ``SequentialReplayBuffer`` :308-395 and
``EnvIndependentReplayBuffer`` :397-529).

Storage is a dict of ``[buffer_size, n_envs, ...]`` arrays, in RAM or, with
``memmap=True``, in files under ``memmap_dir`` (``data/memmap.py``; one
directory per env for the env-independent buffer, as in the JAX package).
A buffer pickles its arrays' contents: a checkpoint of a memmapped buffer
holds the data, not the names of files that the run owning them unlinks
when it ends (the JAX package pickles the file references).

Sampling draws from the same ``numpy.random.Generator`` calls in the same
order as the JAX package's buffers, so one seed gives the same windows in
both; the gather is numpy fancy indexing where the JAX package calls its
C++ gather (``sheeprl_tpu.native``). ``add`` takes ``[seq_len, n_envs, ...]``;
``ReplayBuffer.sample`` returns ``[n_samples, batch_size, ...]`` and the
sequential buffers ``[n_samples, seq_len, batch_size, ...]``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from sheeprl_tpu_torch.data.memmap import ALLOWED_MODES, MemmapArray


def _memmap_dir(memmap_dir: str | os.PathLike | None, memmap_mode: str) -> Path:
    if memmap_mode not in ALLOWED_MODES:
        raise ValueError(f"Accepted values for memmap_mode are {ALLOWED_MODES}, got {memmap_mode!r}")
    if memmap_dir is None:
        raise ValueError("The buffer is memory-mapped but 'memmap_dir' is None. Set it to a known directory.")
    return Path(memmap_dir)


def _validate_add_data(data: Dict[str, np.ndarray]) -> None:
    if not isinstance(data, dict):
        raise ValueError(f"'data' must be a dictionary of numpy arrays, got {type(data)}")
    shape0 = key0 = None
    for k, v in data.items():
        if not isinstance(v, (np.ndarray, MemmapArray)):
            raise ValueError(f"'data' must contain numpy arrays; key {k!r} has type {type(v)}")
        if v.ndim < 2:
            raise RuntimeError(f"'data' arrays must be [sequence_length, n_envs, ...]; shape of {k!r} is {v.shape}")
        if shape0 is None:
            shape0, key0 = v.shape[:2], k
        elif v.shape[:2] != shape0:
            raise RuntimeError(f"arrays must agree in the first 2 dims: {key0!r} has {shape0}, {k!r} has {v.shape[:2]}")


class ReplayBuffer:
    """Uniform-sampling circular buffer over ``[buffer_size, n_envs, ...]``."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: str | os.PathLike | None = None,
        memmap_mode: str = "r+",
        seed: Optional[int] = None,
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap:
            memmap_dir = _memmap_dir(memmap_dir, memmap_mode)
            memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = bool(memmap)
        self._memmap_dir = memmap_dir
        self._memmap_mode = memmap_mode
        self._buf: Dict[str, Any] = {}
        self._pos = 0
        self._full = False
        self._rng = np.random.default_rng(seed)

    @property
    def buffer(self) -> Dict[str, Any]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._full

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def empty(self) -> bool:
        return len(self._buf) == 0

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    def __len__(self) -> int:
        return self._buffer_size

    def _allocate(self, key: str, trailing_shape: Sequence[int], dtype: np.dtype) -> Any:
        shape = (self._buffer_size, self._n_envs, *trailing_shape)
        if self._memmap:
            return MemmapArray(shape, dtype, self._memmap_mode, Path(self._memmap_dir) / f"{key}.memmap")
        return np.empty(shape, dtype=dtype)

    def __getitem__(self, key: str) -> Any:
        if not isinstance(key, str):
            raise TypeError("'key' must be a string")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        return self._buf.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        """Replace one key's whole ``[buffer_size, n_envs, ...]`` array (a
        copy; in the buffer's memmap file when it is memmapped)."""
        if not isinstance(value, (np.ndarray, MemmapArray)):
            raise ValueError(f"the value must be a np.ndarray or MemmapArray, got {type(value)}")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        if tuple(value.shape[:2]) != (self._buffer_size, self._n_envs):
            raise RuntimeError(
                f"'value' must be [buffer_size, n_envs, ...]; got shape {value.shape} with "
                f"buffer_size={self._buffer_size}, n_envs={self._n_envs}"
            )
        if self._memmap:
            filename = value.filename if isinstance(value, MemmapArray) else Path(self._memmap_dir) / f"{key}.memmap"
            old = self._buf.get(key)
            if isinstance(old, MemmapArray) and Path(old.filename) == Path(filename).resolve():
                # the displaced array must not unlink the file its successor adopts
                old.has_ownership = False
            self._buf[key] = MemmapArray.from_array(value, mode=self._memmap_mode, filename=filename)
        else:
            self._buf[key] = np.copy(np.asarray(value))

    def to_memmap(self, memmap_dir: str | os.PathLike, memmap_mode: str = "r+") -> None:
        """Move the arrays into memmap files under ``memmap_dir``, in place."""
        self._memmap_dir = _memmap_dir(memmap_dir, memmap_mode)
        self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._memmap, self._memmap_mode = True, memmap_mode
        for k, v in list(self._buf.items()):
            self._buf[k] = MemmapArray.from_array(np.asarray(v), mode=memmap_mode, filename=self._memmap_dir / f"{k}.memmap")

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["_buf"] = {k: np.array(v) for k, v in self._buf.items()}
        state["_memmap"] = False
        state["_memmap_dir"] = None
        return state

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Append ``[seq_len, n_envs, ...]`` data at the cursor, wrapping over
        the oldest entries."""
        if validate_args:
            _validate_add_data(data)
        data_len = next(iter(data.values())).shape[0]
        if data_len > self._buffer_size:
            data = {k: v[-self._buffer_size :] for k, v in data.items()}
            effective_len = self._buffer_size
        else:
            effective_len = data_len
        start = self._pos if effective_len == data_len else (self._pos + data_len) % self._buffer_size
        idxes = (start + np.arange(effective_len)) % self._buffer_size
        for k, v in data.items():
            if k not in self._buf:
                self._buf[k] = self._allocate(k, v.shape[2:], np.asarray(v).dtype)
            self._buf[k][idxes] = v[-effective_len:]
        if self._pos + data_len >= self._buffer_size:
            self._full = True
        self._pos = (self._pos + data_len) % self._buffer_size

    def _valid_idxes(self, sample_next_obs: bool) -> np.ndarray:
        """Start indices whose transition does not straddle the write cursor."""
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Please add at least one sample calling 'self.add()'")
        end = self._pos - 1 if sample_next_obs else self._pos
        if self._full:
            second_end = self._buffer_size if end >= 0 else self._buffer_size + end
            valid = np.concatenate([np.arange(0, max(end, 0)), np.arange(self._pos, second_end)]).astype(np.intp)
            if len(valid) == 0:
                raise RuntimeError("every stored transition straddles the write cursor; add at least two samples")
            return valid
        if end == 0:
            raise RuntimeError("only one sample has been added to the buffer; add at least two samples")
        return np.arange(0, end, dtype=np.intp)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        """Uniform sample, shape ``[n_samples, batch_size, ...]``."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        valid = self._valid_idxes(sample_next_obs)
        batch_idxes = valid[self._rng.integers(0, len(valid), size=(batch_size * n_samples,), dtype=np.intp)]
        env_idxes = self._rng.integers(0, self._n_envs, size=(len(batch_idxes),), dtype=np.intp)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            v = np.asarray(v)
            out[k] = v[batch_idxes, env_idxes]
            if sample_next_obs and k in self._obs_keys:
                out[f"next_{k}"] = v[(batch_idxes + 1) % self._buffer_size, env_idxes]
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in out.items()}


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous length-L windows (one env each) that do not cross
    the write cursor, returning ``[n_samples, seq_len, batch_size, ...]``."""

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if self.empty:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        if not self._full and self._pos == 0:
            raise ValueError("No sample has been added to the buffer. Please add at least one sample calling 'self.add()'")
        span = sequence_length + 1 if sample_next_obs else sequence_length
        if not self._full and self._pos - span + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}")
        if self._full and span > self._buffer_size:
            raise ValueError(
                f"The sequence length ({sequence_length}) is greater than the buffer size ({self._buffer_size})"
            )
        batch_dim = batch_size * n_samples
        if self._full:
            first_end = self._pos - span + 1
            second_end = self._buffer_size if first_end >= 0 else self._buffer_size + first_end
            valid = np.concatenate([np.arange(0, max(first_end, 0)), np.arange(self._pos, second_end)]).astype(np.intp)
            if len(valid) == 0:
                raise RuntimeError(
                    f"No valid sequence of length {sequence_length} exists that does not straddle the write cursor."
                )
            start_idxes = valid[self._rng.integers(0, len(valid), size=(batch_dim,), dtype=np.intp)]
        else:
            start_idxes = self._rng.integers(0, self._pos - span + 1, size=(batch_dim,), dtype=np.intp)
        env_idxes = self._rng.integers(0, self._n_envs, size=(batch_dim,), dtype=np.intp)
        # [batch_dim, L] index grids -> [n_samples, L, batch_size, ...]
        idxes = (start_idxes[:, None] + np.arange(sequence_length, dtype=np.intp)[None, :]) % self._buffer_size
        envs = np.repeat(env_idxes[:, None], sequence_length, axis=1)

        def gather(rows: np.ndarray, arr: np.ndarray) -> np.ndarray:
            g = arr[rows, envs]
            g = g.reshape(n_samples, batch_size, sequence_length, *g.shape[2:]).swapaxes(1, 2)
            return np.ascontiguousarray(g)

        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            v = np.asarray(v)
            out[k] = gather(idxes, v)
            if sample_next_obs and k in self._obs_keys:
                out[f"next_{k}"] = gather((idxes + 1) % self._buffer_size, v)
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment with its own cursor, so envs may
    restart at different steps; a batch splits over the envs by a
    multinomial draw and concatenates on the batch axis."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: str | os.PathLike | None = None,
        memmap_mode: str = "r+",
        buffer_cls: Type[ReplayBuffer] = ReplayBuffer,
        seed: Optional[int] = None,
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap:
            memmap_dir = _memmap_dir(memmap_dir, memmap_mode)
        self._buf: List[ReplayBuffer] = [
            buffer_cls(
                buffer_size=buffer_size,
                n_envs=1,
                obs_keys=obs_keys,
                memmap=memmap,
                memmap_dir=memmap_dir / f"env_{i}" if memmap else None,
                memmap_mode=memmap_mode,
                seed=None if seed is None else seed + i,
            )
            for i in range(n_envs)
        ]
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._rng = np.random.default_rng(seed)
        self._concat_along_axis = buffer_cls.batch_axis

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return tuple(self._buf)

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> Sequence[bool]:
        return tuple(b.full for b in self._buf)

    @property
    def empty(self) -> Sequence[bool]:
        return tuple(b.empty for b in self._buf)

    @property
    def is_memmap(self) -> Sequence[bool]:
        return tuple(b.is_memmap for b in self._buf)

    def to_memmap(self, memmap_dir: str | os.PathLike, memmap_mode: str = "r+") -> None:
        """Move every env's arrays into memmap files under
        ``memmap_dir/env_<i>``, in place."""
        for i, b in enumerate(self._buf):
            b.to_memmap(_memmap_dir(memmap_dir, memmap_mode) / f"env_{i}", memmap_mode)

    def __len__(self) -> int:
        return self._buffer_size

    def add(
        self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False
    ) -> None:
        if indices is None:
            indices = tuple(range(self._n_envs))
        elif len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must be equal to the second dimension of the "
                f"arrays in 'data' ({next(iter(data.values())).shape[1]})"
            )
        for data_idx, env_idx in enumerate(indices):
            self._buf[env_idx].add({k: v[:, data_idx : data_idx + 1] for k, v in data.items()}, validate_args)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        bs_per_buf = np.bincount(self._rng.integers(0, self._n_envs, (batch_size,)), minlength=self._n_envs)
        per_buf = [
            b.sample(batch_size=bs, sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs)
            for b, bs in zip(self._buf, bs_per_buf)
            if bs > 0
        ]
        return {k: np.concatenate([s[k] for s in per_buf], axis=self._concat_along_axis) for k in per_buf[0]}
