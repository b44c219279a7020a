"""Host replay buffers in numpy (port of ``sheeprl_tpu/data/buffers.py``:
``ReplayBuffer`` :79, ``SequentialReplayBuffer`` :308-395,
``EnvIndependentReplayBuffer`` :397-529 and ``EpisodeBuffer`` :531-790).

Storage is a dict of ``[buffer_size, n_envs, ...]`` arrays, in RAM or, with
``memmap=True``, in files under ``memmap_dir`` (``data/memmap.py``; one
directory per env for the env-independent buffer, as in the JAX package).
A buffer pickles its arrays' contents: a checkpoint of a memmapped buffer
holds the data, not the names of files that the run owning them unlinks
when it ends (the JAX package pickles the file references).

Sampling draws from the same ``numpy.random.Generator`` calls in the same
order as the JAX package's buffers, so one seed gives the same windows in
both; the gather is the port's C++ gather (``sheeprl_tpu_torch.native``)
where the JAX package calls its own, numpy fancy indexing for an array the
kernel does not take. ``add`` takes ``[seq_len, n_envs, ...]``;
``ReplayBuffer.sample`` returns ``[n_samples, batch_size, ...]`` and the
sequential buffers ``[n_samples, seq_len, batch_size, ...]``.
"""

from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from sheeprl_tpu_torch import native
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
            out[k] = _gather_rows(v, batch_idxes, env_idxes)
            if sample_next_obs and k in self._obs_keys:
                out[f"next_{k}"] = _gather_rows(v, (batch_idxes + 1) % self._buffer_size, env_idxes)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in out.items()}


def _gather_rows(arr: np.ndarray, rows: np.ndarray, envs: np.ndarray) -> np.ndarray:
    """``arr[rows, envs]``: the native gather, numpy where it does not take
    ``arr``."""
    g = native.gather_rows(arr, rows, envs)
    return arr[rows, envs] if g is None else g


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

        def gather(arr: np.ndarray, shift: int) -> np.ndarray:
            # one pass into [n_samples, L, batch_size, ...]
            g = native.gather_sequences(arr, start_idxes, env_idxes, sequence_length, n_samples, batch_size, shift)
            if g is not None:
                return g
            # [batch_dim, L] index grids, then the same layout
            rows = (start_idxes[:, None] + shift + np.arange(sequence_length, dtype=np.intp)[None, :]) % self._buffer_size
            g = arr[rows, np.repeat(env_idxes[:, None], sequence_length, axis=1)]
            return np.ascontiguousarray(g.reshape(n_samples, batch_size, sequence_length, *g.shape[2:]).swapaxes(1, 2))

        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            v = np.asarray(v)
            out[k] = gather(v, 0)
            if sample_next_obs and k in self._obs_keys:
                out[f"next_{k}"] = gather(v, 1)
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


class EpisodeBuffer:
    """Whole episodes, one list of them for the buffer, each a dict of
    ``[episode_length, ...]`` arrays (JAX :531-790; Dreamer-V1/V2's
    ``buffer.type=episode``). ``add`` routes each env's steps into its open
    episode and stores it when a step ends it (terminated or truncated); an
    episode shorter than ``minimum_episode_length`` or longer than
    ``buffer_size`` raises. The oldest whole episodes make room for a new
    one. ``sample`` returns ``[n_samples, sequence_length, batch_size, ...]``
    windows that never cross an episode: an episode a window, uniform over
    the episodes long enough, a start uniform within it, or, with
    ``prioritize_ends``, uniform over ``sequence_length`` more starts that
    clip to the last window, so the end of an episode is drawn more often.
    The draws are the JAX buffer's numpy calls in its order. With
    ``memmap``, each episode's arrays live in files of their own under
    ``memmap_dir``, removed when it is evicted; a pickle holds the arrays'
    contents."""

    batch_axis: int = 2

    def __init__(
        self,
        buffer_size: int,
        minimum_episode_length: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: str | os.PathLike | None = None,
        memmap_mode: str = "r+",
        seed: Optional[int] = None,
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if minimum_episode_length <= 0:
            raise ValueError(f"The sequence length must be greater than zero, got: {minimum_episode_length}")
        if buffer_size < minimum_episode_length:
            raise ValueError(
                f"The sequence length must be lower than the buffer size, got: bs = {buffer_size} and sl = {minimum_episode_length}"
            )
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._buffer_size = buffer_size
        self._minimum_episode_length = minimum_episode_length
        self._prioritize_ends = bool(prioritize_ends)
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(n_envs)]
        self._cum_lengths: List[int] = []
        self._buf: List[Dict[str, Any]] = []
        self._rng = np.random.default_rng(seed)
        self._memmap = bool(memmap)
        self._memmap_mode = memmap_mode
        self._memmap_dir = _memmap_dir(memmap_dir, memmap_mode) if memmap else None
        if self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)

    @property
    def prioritize_ends(self) -> bool:
        return self._prioritize_ends

    @prioritize_ends.setter
    def prioritize_ends(self, value: bool) -> None:
        self._prioritize_ends = bool(value)

    @property
    def buffer(self) -> Sequence[Dict[str, Any]]:
        return self._buf

    @property
    def obs_keys(self) -> Sequence[str]:
        return self._obs_keys

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def minimum_episode_length(self) -> int:
        return self._minimum_episode_length

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    @property
    def full(self) -> bool:
        return self._cum_lengths[-1] + self._minimum_episode_length > self._buffer_size if self._buf else False

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._buf else 0

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["_buf"] = [{k: np.array(v) for k, v in ep.items()} for ep in self._buf]
        state["_memmap"] = False
        state["_memmap_dir"] = None
        return state

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Route ``[seq_len, n_envs, ...]`` steps (of the envs
        ``env_idxes``, by default all) into the envs' open episodes; a step
        that ends an episode stores it (JAX :620-664)."""
        if validate_args:
            if data is None:
                raise ValueError("The data must be not None")
            _validate_add_data(data)
            if "terminated" not in data or "truncated" not in data:
                raise RuntimeError(f"The episode must contain the `terminated` and the `truncated` keys, got: {list(data.keys())}")
            if env_idxes is not None and (np.asarray(env_idxes) >= self._n_envs).any():
                raise ValueError(f"The indices of the environment must be integers in [0, {self._n_envs}), given {env_idxes}")
        if env_idxes is None:
            env_idxes = range(self._n_envs)
        for data_idx, env in enumerate(env_idxes):
            env_data = {k: np.asarray(v)[:, data_idx] for k, v in data.items()}
            done = np.logical_or(env_data["terminated"], env_data["truncated"]).reshape(-1)
            ends = done.nonzero()[0].tolist()
            if not ends:
                self._open_episodes[env].append(env_data)
                continue
            ends.append(len(done))
            start = 0
            for stop in ends:
                chunk = {k: v[start : stop + 1] for k, v in env_data.items()}
                if len(chunk["terminated"]) > 0:
                    self._open_episodes[env].append(chunk)
                start = stop + 1
                last = self._open_episodes[env][-1] if self._open_episodes[env] else None
                if last is not None and bool(np.logical_or(last["terminated"][-1], last["truncated"][-1])):
                    self._save_episode(self._open_episodes[env])
                    self._open_episodes[env] = []

    def _save_episode(self, chunks: Sequence[Dict[str, np.ndarray]]) -> None:
        if len(chunks) == 0:
            raise RuntimeError("Invalid episode, an empty sequence is given. You must pass a non-empty sequence.")
        episode = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0].keys()}
        ends = np.logical_or(episode["terminated"], episode["truncated"]).reshape(-1)
        ep_len = ends.shape[0]
        if len(ends.nonzero()[0]) != 1 or not ends[-1]:
            raise RuntimeError(f"The episode must contain exactly one done, got: {len(ends.nonzero()[0])}")
        if ep_len < self._minimum_episode_length:
            raise RuntimeError(f"Episode too short (at least {self._minimum_episode_length} steps), got: {ep_len} steps")
        if ep_len > self._buffer_size:
            raise RuntimeError(f"Episode too long (at most {self._buffer_size} steps), got: {ep_len} steps")
        # the oldest whole episodes go until the new one fits (JAX :686-698)
        if self.full or len(self) + ep_len > self._buffer_size:
            cum = np.array(self._cum_lengths)
            keep_from = int(((len(self) - cum + ep_len) <= self._buffer_size).argmax())
            evicted, self._buf = self._buf[: keep_from + 1], self._buf[keep_from + 1 :]
            for ep in evicted:
                self._remove_files(ep)
            cum = cum[keep_from + 1 :] - cum[keep_from]
            self._cum_lengths = cum.tolist()
        self._cum_lengths.append(len(self) + ep_len)
        if self._memmap:
            episode_dir = self._memmap_dir / f"episode_{uuid.uuid4()}"
            episode_dir.mkdir(parents=True, exist_ok=True)
            episode = {
                k: MemmapArray.from_array(v, mode=self._memmap_mode, filename=episode_dir / f"{k}.memmap") for k, v in episode.items()
            }
        self._buf.append(episode)

    @staticmethod
    def _remove_files(episode: Dict[str, Any]) -> None:
        files = [v.filename for v in episode.values() if isinstance(v, MemmapArray)]
        episode.clear()
        if files:
            shutil.rmtree(os.path.dirname(str(files[0])), ignore_errors=True)

    def episode_lengths(self) -> np.ndarray:
        return np.array(self._cum_lengths) - np.array([0] + self._cum_lengths[:-1])

    def sample_indices(
        self, batch_size: int, n_samples: int = 1, sequence_length: int = 1, sample_next_obs: bool = False
    ) -> Tuple[List[int], List[np.ndarray]]:
        """The draws of :meth:`sample` (JAX :720-758): the stored episodes
        each window reads (ascending, with repeats grouped) and, for each
        episode drawn, the ``[n, sequence_length]`` step indices of its
        windows."""
        if batch_size <= 0:
            raise ValueError(f"Batch size must be greater than 0, got: {batch_size}")
        if n_samples <= 0:
            raise ValueError(f"The number of samples must be greater than 0, got: {n_samples}")
        min_len = sequence_length + 1 if sample_next_obs else sequence_length
        valid = [i for i, n in enumerate(self.episode_lengths()) if n >= min_len]
        if len(valid) == 0:
            raise RuntimeError(
                "No valid episodes has been added to the buffer. Please add at least one episode of length greater "
                f"than or equal to {sequence_length} calling `self.add()`"
            )
        offsets = np.arange(sequence_length, dtype=np.intp)[None, :]
        n_per_ep = np.bincount(self._rng.integers(0, len(valid), (batch_size * n_samples,)), minlength=len(valid))
        episodes, idxes = [], []
        for i, n in enumerate(n_per_ep):
            if n == 0:
                continue
            ep_len = np.asarray(self._buf[valid[i]]["terminated"]).shape[0] - (1 if sample_next_obs else 0)
            upper = ep_len - sequence_length + 1
            if self._prioritize_ends:
                upper += sequence_length
            starts = np.minimum(self._rng.integers(0, upper, size=(n, 1)), ep_len - sequence_length).astype(np.intp)
            episodes.append(valid[i])
            idxes.append(starts + offsets)
        return episodes, idxes

    def gather(
        self, episodes: Sequence[int], idxes: Sequence[np.ndarray], batch_size: int, n_samples: int = 1, sample_next_obs: bool = False
    ) -> Dict[str, np.ndarray]:
        """The ``[n_samples, sequence_length, batch_size, ...]`` windows of
        the draws ``(episodes, idxes)``, in their order."""
        keys = list(self._buf[episodes[0]].keys())
        chunks: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        if sample_next_obs:
            chunks.update({f"next_{k}": [] for k in self._obs_keys})
        for e, idx in zip(episodes, idxes):
            n, length = idx.shape
            for k in keys:
                arr = np.asarray(self._buf[e][k])
                chunks[k].append(arr[idx.reshape(-1)].reshape(n, length, *arr.shape[1:]))
                if sample_next_obs and k in self._obs_keys:
                    chunks[f"next_{k}"].append(arr[(idx + 1).reshape(-1)].reshape(n, length, *arr.shape[1:]))
        out: Dict[str, np.ndarray] = {}
        for k, v in chunks.items():
            if v:
                stacked = np.concatenate(v, axis=0).reshape(n_samples, batch_size, v[0].shape[1], *v[0].shape[2:])
                out[k] = np.ascontiguousarray(np.moveaxis(stacked, 2, 1))
        return out

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        n_samples: int = 1,
        clone: bool = False,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        """``[n_samples, sequence_length, batch_size, ...]`` windows from
        within the stored episodes (JAX :700-772)."""
        episodes, idxes = self.sample_indices(batch_size, n_samples, sequence_length, sample_next_obs)
        return self.gather(episodes, idxes, batch_size, n_samples, sample_next_obs)
