"""Replay resident on the card (port of ``sheeprl_tpu/data/device_buffer.py``,
single device): sequence windows for the Dreamer loops and uniform
transitions for the SAC family (``transition_item_mask`` :89,
``draw_transition_batch`` :162, ``sample_transitions`` :593-676, the
transition host-buffer conversions :838-893, ``make_transition_replay``
:1064).

The host buffers copy every sampled batch over the bus: at Dreamer-V3's
B=16, T=64 and 64x64x3 pixels that is 12.6 MB a gradient step. The ring
keeps replay in device memory instead: each env step uploads its few KB
once, at ``add``, and a batch is a gather on the card. From the host path
only the indices cross (``B * (T + 1)`` int32 a batch); a fused superstep
draws in the graph and reads only the ``[n_envs]`` cursors, copied once a
train window.

Semantics are ``EnvIndependentReplayBuffer(buffer_cls=SequentialReplayBuffer)``'s
(per-env cursors, windows that never straddle an env's write cursor), with
the JAX ring's draw: the host draw calls the buffer's numpy generator in the
JAX ring's order, so the two rings, fed the same adds from the same seed,
give the same batches bit for bit.

Storage, allocated at capacity on the first ``add``: each uint8 (pixel) key
``[n_envs, capacity + 1, *item]``, and every other key packed into one
float32 slab ``[n_envs, capacity + 1, width]`` (``_small_slices``: each
key's columns and item shape), which ``bufs`` exposes per key as views.
Slot ``capacity`` is a scratch row: an env left out of a partial ``add``
writes there, so every add is the same fixed-shape scatter. Every write is
in place (``add``, ``amend_last``, ``flag_last_truncated``): a captured
graph reading the storage never sees it move. Writes and gathers run on
the current stream, the stream the train step's graph replays on, so an
``add`` is ordered after any queued step that still reads the ring.

The draw and the gather are plain torch ops (advanced indexing, ``cumsum``,
``argmax``), as the JAX ring's are XLA ops: no kernel of its own.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.device import DeviceLike, resolve_device

SmallSlices = Dict[str, Tuple[int, int, Tuple[int, ...]]]


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array, queued on the current stream: staged
    through pinned memory on the card, whose allocator keeps the staging
    block until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def copy_from_host_(dst: torch.Tensor, array: np.ndarray) -> None:
    """``dst[...] = array``, queued on the current stream as :func:`to_device`."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dst.device.type == "cuda":
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


# --------------------------------------------------------------------------- #
# The sampling functions: plain functions of device tensors, called by the
# ring's host path and, inside a fused superstep's graph, by the in-graph
# draw. The ring tensors are [n_envs, capacity + 1, ...]; slot capacity is
# the scratch row and is never sampled.
# --------------------------------------------------------------------------- #


def sequence_start_mask(pos: torch.Tensor, full: torch.Tensor, capacity: int, span: int) -> torch.Tensor:
    """``[n_envs, capacity]`` bool mask of the window starts of ``span``
    steps that do not straddle each env's write cursor."""
    s = torch.arange(capacity, dtype=torch.int64, device=pos.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    full = full.to(torch.bool)[:, None]
    first_end = pos - span + 1
    second_end = capacity + first_end.clamp(max=0)
    when_full = (s < first_end.clamp(min=0)) | ((s >= pos) & (s < second_end))
    return torch.where(full, when_full, s < first_end)


def draw_from_mask(generator: torch.Generator, mask: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(env_idx [n], item [n])``: a uniform env, then uniform over that
    env's valid entries, from ``generator``. Every env must have a valid
    entry (the callers check on the host first)."""
    n_envs = mask.shape[0]
    env_idx = torch.randint(0, n_envs, (n,), generator=generator, device=mask.device)
    rows = mask[env_idx].to(torch.int32)
    counts = rows.sum(1)
    u = torch.rand((n,), generator=generator, device=mask.device)
    j = torch.minimum((u * counts.to(torch.float32)).to(torch.int64), (counts - 1).clamp(min=0))
    # the (j+1)-th valid entry of the row: argmax returns the first maximum
    item = torch.argmax((torch.cumsum(rows, 1, dtype=torch.int32) > j[:, None]).to(torch.uint8), dim=1)
    return env_idx, item


def gather_sequences(bufs: Dict[str, torch.Tensor], env_idx: torch.Tensor, time_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``env_idx [B]`` and ``time_idx [B, T]`` to time-major ``[T, B, ...]``
    values, device to device."""
    env, time = env_idx.to(torch.int64)[None, :], time_idx.to(torch.int64).t()
    return {k: b[env, time] for k, b in bufs.items()}


def draw_sequence_batch(
    bufs: Dict[str, torch.Tensor],
    pos: torch.Tensor,
    full: torch.Tensor,
    generator: torch.Generator,
    batch_size: int,
    sequence_length: int,
) -> Dict[str, torch.Tensor]:
    """One ``[T, B, ...]`` batch drawn and gathered on the device: the
    replay read of a fused superstep."""
    capacity = next(iter(bufs.values())).shape[1] - 1
    mask = sequence_start_mask(pos, full, capacity, sequence_length)
    env_idx, starts = draw_from_mask(generator, mask, batch_size)
    offsets = torch.arange(sequence_length, dtype=torch.int64, device=starts.device)
    return gather_sequences(bufs, env_idx, (starts[:, None] + offsets[None, :]) % capacity)


def transition_item_mask(pos: torch.Tensor, full: torch.Tensor, capacity: int, sample_next_obs: bool) -> torch.Tensor:
    """``[n_envs, capacity]`` bool mask of the items a transition draw may
    take: every stored item, less the one before each env's write cursor
    when ``sample_next_obs`` (its successor is the oldest slot, about to be
    overwritten)."""
    s = torch.arange(capacity, dtype=torch.int64, device=pos.device)[None, :]
    pos = pos.to(torch.int64)[:, None]
    full = full.to(torch.bool)[:, None]
    end = pos - (1 if sample_next_obs else 0)
    second_end = torch.where(end >= 0, capacity, capacity + end)
    when_full = (s < end.clamp(min=0)) | ((s >= pos) & (s < second_end))
    return torch.where(full, when_full, s < end.clamp(min=0))


def gather_transition_items(bufs: Dict[str, torch.Tensor], env_idx: torch.Tensor, time_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``env_idx`` and ``time_idx [N]`` to ``[N, ...]`` values, device to
    device."""
    env, time = env_idx.to(torch.int64), time_idx.to(torch.int64)
    return {k: b[env, time] for k, b in bufs.items()}


def _with_next(
    out: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor], env_idx: torch.Tensor, next_idx: torch.Tensor, obs_keys: Sequence[str]
) -> Dict[str, torch.Tensor]:
    for k in obs_keys:
        if k in bufs:
            out[f"next_{k}"] = bufs[k][env_idx.to(torch.int64), next_idx.to(torch.int64)]
    return out


def draw_transition_items(
    generator: torch.Generator, pos: torch.Tensor, full: torch.Tensor, capacity: int, n: int, sample_next_obs: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(env_idx [n], item [n])``: :func:`draw_from_mask` over
    :func:`transition_item_mask`, the same draws mapped to the same items,
    without the ``[n, capacity]`` rows: an env's valid items are at most
    two ranges, ``[0, end)`` and, once full, ``[pos, second_end)``, so the
    (j+1)-th of them is found arithmetically in O(n), where the mask's
    cumulative sum reads ``n * capacity`` entries (a 1M-transition ring at
    batch 256 is 64M a draw). Every env must have a valid item (the callers
    check on the host first)."""
    n_envs = pos.shape[0]
    env_idx = torch.randint(0, n_envs, (n,), generator=generator, device=pos.device)
    p = pos.to(torch.int64)[env_idx]
    f = full.to(torch.bool)[env_idx]
    end = p - (1 if sample_next_obs else 0)
    first = end.clamp(min=0)
    second_end = torch.where(end >= 0, capacity, capacity + end)
    counts = torch.where(f, first + (second_end - p), first)
    u = torch.rand((n,), generator=generator, device=pos.device)
    j = torch.minimum((u * counts.to(torch.float32)).to(torch.int64), (counts - 1).clamp(min=0))
    return env_idx, torch.where(j < first, j, p + (j - first))


def draw_transition_batch(
    bufs: Dict[str, torch.Tensor],
    pos: torch.Tensor,
    full: torch.Tensor,
    generator: torch.Generator,
    batch_size: int,
    sample_next_obs: bool = False,
    obs_keys: Sequence[str] = (),
) -> Dict[str, torch.Tensor]:
    """One ``[B, ...]`` batch of uniform transitions drawn and gathered on
    the device (a uniform env, then a uniform valid item,
    :func:`draw_transition_items`), ``next_<key>`` of each of ``obs_keys``
    at the next item when ``sample_next_obs``: the replay read of the SAC
    family's fused superstep."""
    capacity = next(iter(bufs.values())).shape[1] - 1
    env_idx, items = draw_transition_items(generator, pos, full, capacity, batch_size, sample_next_obs)
    out = gather_transition_items(bufs, env_idx, items)
    if sample_next_obs:
        _with_next(out, bufs, env_idx, (items + 1) % capacity, obs_keys)
    return out


def _small_slices(items: Dict[str, Tuple[int, ...]]) -> SmallSlices:
    """Each small key's ``(first column, end column, item shape)`` in the
    slab, keys in sorted order."""
    out: SmallSlices = {}
    offset = 0
    for k in sorted(items):
        item = tuple(items[k])
        width = int(np.prod(item)) if item else 1
        out[k] = (offset, offset + width, item)
        offset += width
    return out


class DeviceReplayBuffer:
    """Sequence replay ring on one device: ``add`` takes the host buffers'
    ``[1, n, ...]`` step dicts (with optional env ``indices``) and
    ``sample_batches`` yields device ``[T, B, ...]`` batches."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        device: DeviceLike = None,
        seed: Optional[int] = None,
    ) -> None:
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._obs_keys = tuple(obs_keys)
        self._device: Optional[torch.device] = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        # host mirrors of the per-env cursors: the device never reports them
        self._pos = np.zeros((n_envs,), np.int64)
        self._full = np.zeros((n_envs,), bool)
        self._small_slices: SmallSlices = {}
        self._small_keys: Tuple[str, ...] = ()
        self._pixel_keys: Tuple[str, ...] = ()
        self._pending_arrays: Optional[Dict[str, np.ndarray]] = None
        self._clear_storage()

    def _clear_storage(self) -> None:
        self._pixels: Dict[str, torch.Tensor] = {}
        self._slab: Optional[torch.Tensor] = None
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        self._pos_dev: Optional[torch.Tensor] = None
        self._full_dev: Optional[torch.Tensor] = None
        self._env_ids: Optional[torch.Tensor] = None

    # ------------------------------------------------------------- properties
    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> Sequence[bool]:
        return tuple(bool(f) for f in self._full)

    @property
    def empty(self) -> Sequence[bool]:
        return tuple(not f and p == 0 for f, p in zip(self._full, self._pos))

    @property
    def is_memmap(self) -> Sequence[bool]:
        return tuple(False for _ in range(self._n_envs))

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    @property
    def bufs(self) -> Optional[Dict[str, torch.Tensor]]:
        """The storage per key, ``[n_envs, capacity + 1, *item]`` (the small
        keys as views of the slab), or ``None`` before the first ``add``."""
        return self._bufs

    def __len__(self) -> int:
        return self._buffer_size

    def __repr__(self) -> str:
        return (
            f"DeviceReplayBuffer(buffer_size={self._buffer_size}, n_envs={self._n_envs}, "
            f"allocated={self._bufs is not None}, placement=single({self._device}))"
        )

    # ------------------------------------------------------------- allocation
    def _set_layout(self, items: Dict[str, Tuple[int, ...]], pixel_keys: Sequence[str]) -> None:
        self._pixel_keys = tuple(sorted(pixel_keys))
        self._small_keys = tuple(k for k in sorted(items) if k not in self._pixel_keys)
        self._small_slices = _small_slices({k: items[k] for k in self._small_keys})
        self._pixel_items = {k: tuple(items[k]) for k in self._pixel_keys}

    def _make_storage(self) -> None:
        dev, n, cap1 = self._device, self._n_envs, self._buffer_size + 1
        width = max((s[1] for s in self._small_slices.values()), default=0)
        self._pixels = {k: torch.zeros((n, cap1, *item), dtype=torch.uint8, device=dev) for k, item in self._pixel_items.items()}
        self._slab = torch.zeros((n, cap1, width), dtype=torch.float32, device=dev)
        bufs = dict(self._pixels)
        for k, (o0, o1, item) in self._small_slices.items():
            bufs[k] = self._slab[:, :, o0:o1].view(n, cap1, *item)
        self._bufs = {k: bufs[k] for k in sorted(bufs)}
        self._pos_dev = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._full_dev = torch.zeros((n,), dtype=torch.bool, device=dev)
        self._env_ids = torch.arange(n, device=dev)

    def _allocate(self, data: Dict[str, np.ndarray]) -> None:
        items = {k: tuple(np.asarray(v).shape[2:]) for k, v in data.items()}
        self._set_layout(items, [k for k, v in data.items() if np.asarray(v).dtype == np.uint8])
        self._make_storage()

    # ------------------------------------------------------------------ write
    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Append one time step for the envs in ``indices`` (all envs when
        ``None``); ``data`` values are ``[1, len(indices), ...]`` host arrays."""
        if not isinstance(data, dict):
            raise ValueError(f"'data' must be a dictionary, got {type(data)}")
        first = np.asarray(next(iter(data.values())))
        if first.shape[0] != 1:
            raise ValueError(f"DeviceReplayBuffer.add stores one step per call; got a [{first.shape[0]}, ...] block")
        indices = list(range(self._n_envs) if indices is None else indices)
        if validate_args and len(indices) != first.shape[1]:
            raise ValueError(
                f"The length of 'indices' ({len(indices)}) must be equal to the second dimension of the "
                f"arrays in 'data' ({first.shape[1]})"
            )
        if self._bufs is None:
            self._allocate(data)
        if set(data) != set(self._bufs):
            raise ValueError(f"add() keys {sorted(data)} do not match the allocated keys {sorted(self._bufs)}")
        # the env's cursor, or the scratch slot for an env left out
        pos = np.full((self._n_envs,), self._buffer_size, np.int64)
        smalls = np.zeros((self._n_envs, self._slab.shape[2]), np.float32)
        pixels = {k: np.zeros((self._n_envs, *item), np.uint8) for k, item in self._pixel_items.items()}
        for col, env in enumerate(indices):
            pos[env] = self._pos[env]
            for k in self._pixel_keys:
                pixels[k][env] = data[k][0, col]
            for k in self._small_keys:
                o0, o1, _ = self._small_slices[k]
                smalls[env, o0:o1] = np.asarray(data[k][0, col], np.float32).reshape(-1)
        dev = self._device
        pos_t = to_device(pos, dev)
        self._slab[self._env_ids, pos_t] = to_device(smalls, dev)
        for k in self._pixel_keys:
            self._pixels[k][self._env_ids, pos_t] = to_device(pixels[k], dev)
        for env in indices:
            self._pos[env] += 1
            if self._pos[env] >= self._buffer_size:
                self._pos[env] = 0
                self._full[env] = True

    def amend_last(self, env_idx: int, terminated: float, truncated: float, is_first: float) -> None:
        """Rewrite the done and first flags of one env's most recent step
        (the env-restart patch of the loop, JAX ``dreamer_v3.py:868-882``)."""
        if self._bufs is None:
            return
        slot = int((self._pos[env_idx] - 1) % self._buffer_size)
        for k, v in (("terminated", terminated), ("truncated", truncated), ("is_first", is_first)):
            if k in self._small_slices:
                self._bufs[k][env_idx, slot] = float(v)

    # ----------------------------------------------------------------- sample
    def _draw_env_idx(self, n: int) -> np.ndarray:
        return self._rng.integers(0, self._n_envs, (n,), dtype=np.intp)

    def _valid_starts(self, env: int, span: int) -> np.ndarray:
        """One env's window starts that do not straddle its write cursor
        (``SequentialReplayBuffer.sample``'s rule)."""
        pos = int(self._pos[env])
        if self._full[env]:
            first_end = pos - span + 1
            second_end = self._buffer_size if first_end >= 0 else self._buffer_size + first_end
            return np.concatenate([np.arange(0, max(first_end, 0)), np.arange(pos, second_end)]).astype(np.intp)
        if pos - span + 1 < 1:
            return np.empty((0,), np.intp)
        return np.arange(0, pos - span + 1, dtype=np.intp)

    def _check_sequences(self, env: int, sequence_length: int) -> None:
        if len(self._valid_starts(env, sequence_length)) == 0:
            raise ValueError(
                f"Cannot sample a sequence of length {sequence_length} from env {env}. "
                f"Data added so far: {self._pos[env]}"
            )

    def _valid_items(self, env: int, sample_next_obs: bool) -> np.ndarray:
        """One env's items whose transition does not straddle its write
        cursor (``ReplayBuffer._valid_idxes``' rule, per env)."""
        pos = int(self._pos[env])
        end = pos - 1 if sample_next_obs else pos
        if self._full[env]:
            second_end = self._buffer_size if end >= 0 else self._buffer_size + end
            return np.concatenate([np.arange(0, max(end, 0)), np.arange(pos, second_end)]).astype(np.intp)
        return np.arange(0, max(end, 0), dtype=np.intp)

    def _check_items(self, env: int, sample_next_obs: bool) -> np.ndarray:
        valid = self._valid_items(env, sample_next_obs)
        if len(valid) == 0:
            raise ValueError(
                "You want to sample the next observations, but not enough samples have been "
                f"added to env {env}. Make sure that at least two samples are added."
                if sample_next_obs
                else "No sample has been added to the buffer. Please add at least one sample calling 'self.add()'"
            )
        return valid

    def sample_transitions(
        self, batch_size: int, n_samples: int = 1, sample_next_obs: bool = False
    ) -> Dict[str, torch.Tensor]:
        """``[n_samples, batch_size, ...]`` uniform transitions on the
        device: a uniform env for each row, then per env (in sorted order) a
        uniform valid item, from the buffer's numpy generator in the JAX
        ring's order, with ``next_<key>`` at the next item for the obs keys
        when ``sample_next_obs``. Only the indices cross the bus."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be both greater than 0")
        if self._bufs is None:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        n = batch_size * n_samples
        env_idx = self._draw_env_idx(n)
        items = np.empty((n,), np.intp)
        for env in np.unique(env_idx):
            valid = self._check_items(int(env), sample_next_obs)
            rows = np.nonzero(env_idx == env)[0]
            items[rows] = valid[self._rng.integers(0, len(valid), size=(len(rows),), dtype=np.intp)]
        parts = [env_idx, items] + ([(items + 1) % self._buffer_size] if sample_next_obs else [])
        idx = to_device(np.concatenate(parts).astype(np.int32), self._device)
        flat = gather_transition_items(self._bufs, idx[:n], idx[n : 2 * n])
        if sample_next_obs:
            _with_next(flat, self._bufs, idx[:n], idx[2 * n :], self._obs_keys)
        return {k: v.view(n_samples, batch_size, *v.shape[1:]) for k, v in flat.items()}

    def draw_indices(self, batch_size: int, sequence_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(env_idx [B], start [B])`` on the host: the env of each row,
        then per env (in sorted order) uniform over its valid starts."""
        if batch_size <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) must be greater than 0")
        if self._bufs is None:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        env_idx = self._draw_env_idx(batch_size)
        starts = np.empty((batch_size,), np.intp)
        for env in np.unique(env_idx):
            self._check_sequences(int(env), sequence_length)
            valid = self._valid_starts(int(env), sequence_length)
            rows = np.nonzero(env_idx == env)[0]
            starts[rows] = valid[self._rng.integers(0, len(valid), size=(len(rows),), dtype=np.intp)]
        return env_idx, starts

    def gather(
        self,
        env_idx: np.ndarray,
        starts: np.ndarray,
        sequence_length: int,
        out: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The ``[T, B, ...]`` windows at host indices ``(env_idx, starts)``:
        one upload of ``B * (T + 1)`` int32, then a gather on the device,
        into ``out``'s tensors when given."""
        time_idx = (starts[:, None] + np.arange(sequence_length)[None, :]) % self._buffer_size
        idx = to_device(np.concatenate([env_idx.reshape(-1), time_idx.reshape(-1)]).astype(np.int32), self._device)
        batch = gather_sequences(self._bufs, idx[: len(env_idx)], idx[len(env_idx) :].view(len(env_idx), sequence_length))
        if out is None:
            return batch
        for k, dst in out.items():
            dst.copy_(batch[k])
        return out

    def sample_batches(
        self,
        batch_size: int,
        sequence_length: int,
        n_samples: int,
        out: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield ``n_samples`` ``[T, B, ...]`` device batches, each drawn on
        the host (:meth:`draw_indices`) and gathered on the device, into
        ``out`` when given (the captured train step's static inputs)."""
        if n_samples <= 0:
            raise ValueError(f"'n_samples' ({n_samples}) must be greater than 0")
        for _ in range(n_samples):
            env_idx, starts = self.draw_indices(batch_size, sequence_length)
            yield self.gather(env_idx, starts, sequence_length, out)

    def superstep_inputs(
        self, sequence_length: Optional[int] = None, sample_next_obs: bool = False
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """``(bufs, pos, full)`` for an in-graph draw of sequences of
        ``sequence_length``, or of transitions when it is ``None``. The
        cursors are copied into the ring's static device tensors, which a
        captured superstep reads: only they cross the bus for a train
        window. The in-graph draw cannot raise, so every env is checked here
        first, with :meth:`draw_indices`' or :meth:`sample_transitions`'
        errors. The loop adds no step between this call and the superstep it
        feeds (a train window runs between env steps)."""
        if self._bufs is None:
            raise RuntimeError("The buffer has not been initialized. Try to add some data first.")
        for env in range(self._n_envs):
            if sequence_length is None:
                self._check_items(env, sample_next_obs)
            else:
                self._check_sequences(env, int(sequence_length))
        copy_from_host_(self._pos_dev, self._pos.astype(np.int32))
        copy_from_host_(self._full_dev, self._full.copy())
        return self._bufs, self._pos_dev, self._full_dev

    # ------------------------------------------------ checkpoint consistency
    def _last_slots(self) -> torch.Tensor:
        return to_device((self._pos - 1) % self._buffer_size, self._device)

    def flag_last_truncated(self) -> Optional[np.ndarray]:
        """Set ``truncated`` on every env's most recent step (a checkpoint
        holds no env state, so its last stored step must end an episode) and
        return the values it overwrote, for :meth:`restore_last_truncated`."""
        if self._bufs is None or "truncated" not in self._bufs:
            return None
        slots = self._last_slots()
        saved = self._bufs["truncated"][self._env_ids, slots].cpu().numpy()
        self._bufs["truncated"][self._env_ids, slots] = 1.0
        return saved

    def restore_last_truncated(self, saved: Optional[np.ndarray]) -> None:
        if saved is None or self._bufs is None:
            return
        self._bufs["truncated"][self._env_ids, self._last_slots()] = to_device(saved, self._device)

    # ------------------------------------------------------------- checkpoint
    def host_arrays(self) -> Dict[str, np.ndarray]:
        """The ring without its scratch slot as ``[n_envs, capacity, ...]``
        numpy arrays: one copy for each pixel key and one for the slab."""
        if self._bufs is None:
            return dict(self._pending_arrays or {})
        cap, n = self._buffer_size, self._n_envs
        out = {k: v[:, :cap].cpu().numpy() for k, v in self._pixels.items()}
        slab = self._slab[:, :cap].cpu().numpy()
        for k, (o0, o1, item) in self._small_slices.items():
            out[k] = np.ascontiguousarray(slab[:, :, o0:o1]).reshape(n, cap, *item)
        return {k: out[k] for k in sorted(out)}

    def __getstate__(self) -> Dict[str, Any]:
        return {
            "buffer_size": self._buffer_size,
            "n_envs": self._n_envs,
            "obs_keys": self._obs_keys,
            "rng": self._rng,
            "pos": self._pos,
            "full": self._full,
            "small_slices": self._small_slices,
            "small_keys": self._small_keys,
            "pixel_keys": self._pixel_keys,
            "arrays": self.host_arrays(),
        }

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self._buffer_size = state["buffer_size"]
        self._n_envs = state["n_envs"]
        self._obs_keys = tuple(state["obs_keys"])
        self._rng = state["rng"]
        self._pos = state["pos"]
        self._full = state["full"]
        self._small_slices = state["small_slices"]
        self._small_keys = tuple(state["small_keys"])
        self._pixel_keys = tuple(state["pixel_keys"])
        self._device = None  # placed by the restoring process (restore_to_device)
        self._clear_storage()
        self._pending_arrays = state["arrays"]

    def restore_to_device(self, device: DeviceLike = None) -> "DeviceReplayBuffer":
        """Put a restored (unpickled) ring on ``device`` (the card by default)."""
        self._device = resolve_device(device)
        arrays = self._pending_arrays
        if arrays:
            items = {k: tuple(v.shape[2:]) for k, v in arrays.items()}
            self._set_layout(items, self._pixel_keys)
            self._make_storage()
            cap = self._buffer_size
            for k in self._pixel_keys:
                self._pixels[k][:, :cap].copy_(torch.from_numpy(np.ascontiguousarray(arrays[k])))
            slab = np.zeros((self._n_envs, cap, self._slab.shape[2]), np.float32)
            for k, (o0, o1, _) in self._small_slices.items():
                slab[:, :, o0:o1] = np.asarray(arrays[k], np.float32).reshape(self._n_envs, cap, o1 - o0)
            self._slab[:, :cap].copy_(torch.from_numpy(slab))
            self._pending_arrays = None
        return self

    @classmethod
    def from_host_buffer(cls, host_rb: EnvIndependentReplayBuffer, device: DeviceLike = None, seed: Optional[int] = None) -> "DeviceReplayBuffer":
        """Load an ``EnvIndependentReplayBuffer`` (of ``SequentialReplayBuffer``s)
        into a ring on ``device``, cursors included."""
        subs = host_rb.buffer
        out = cls(host_rb.buffer_size, n_envs=len(subs), obs_keys=subs[0]._obs_keys, device=device, seed=seed)
        keys = list(subs[0].buffer.keys())
        arrays = {k: np.stack([np.asarray(sub.buffer[k])[:, 0] for sub in subs]) for k in keys}
        out._pos = np.array([sub._pos for sub in subs], np.int64)
        out._full = np.array([sub.full for sub in subs], bool)
        out._pending_arrays = {k: (v if v.dtype == np.uint8 else v.astype(np.float32)) for k, v in arrays.items()}
        out._pixel_keys = tuple(k for k in sorted(keys) if arrays[k].dtype == np.uint8)
        return out.restore_to_device(device)

    def to_host_buffer(self, memmap: bool = False, memmap_dir: Any = None) -> EnvIndependentReplayBuffer:
        """The ring as an ``EnvIndependentReplayBuffer`` in host RAM, or
        memmapped under ``memmap_dir``, cursors included."""
        host = EnvIndependentReplayBuffer(
            self._buffer_size,
            n_envs=self._n_envs,
            obs_keys=self._obs_keys,
            memmap=memmap,
            memmap_dir=memmap_dir,
            buffer_cls=SequentialReplayBuffer,
        )
        arrays = self.host_arrays()
        for env, sub in enumerate(host.buffer):
            # allocate with one step, then overwrite every key whole
            sub.add({k: v[env : env + 1, 0:1].swapaxes(0, 1) for k, v in arrays.items()})
            for k, v in arrays.items():
                sub[k] = v[env][:, None]
            sub._pos = int(self._pos[env])
            sub._full = bool(self._full[env])
        return host

    @classmethod
    def from_transition_host_buffer(cls, host_rb: ReplayBuffer, device: DeviceLike = None, seed: Optional[int] = None) -> "DeviceReplayBuffer":
        """Load a plain ``ReplayBuffer`` (the SAC family's host layout:
        ``[size, n_envs, ...]`` arrays, one cursor for every env) into a
        ring on ``device``."""
        arrays = {k: np.asarray(v).swapaxes(0, 1) for k, v in host_rb.buffer.items()}
        out = cls(host_rb.buffer_size, n_envs=host_rb.n_envs, obs_keys=host_rb._obs_keys, device=device, seed=seed)
        out._pos = np.full((host_rb.n_envs,), host_rb._pos, np.int64)
        out._full = np.full((host_rb.n_envs,), host_rb.full, bool)
        out._pending_arrays = {k: (v if v.dtype == np.uint8 else v.astype(np.float32)) for k, v in arrays.items()}
        out._pixel_keys = tuple(k for k in sorted(arrays) if arrays[k].dtype == np.uint8)
        return out.restore_to_device(device)

    def to_transition_host_buffer(self, memmap: bool = False, memmap_dir: Any = None) -> ReplayBuffer:
        """The ring as a plain ``ReplayBuffer`` (the SAC family's host
        layout). Its envs advance in lockstep in those loops, so env 0's
        cursor is the buffer's; a ring written by partial adds raises."""
        if not ((self._pos == self._pos[0]).all() and (self._full == self._full[0]).all()):
            raise RuntimeError(
                "to_transition_host_buffer requires lockstep env cursors (the plain ReplayBuffer has one "
                f"global cursor) but pos={self._pos.tolist()} full={self._full.tolist()}; "
                "convert with to_host_buffer() instead"
            )
        host = ReplayBuffer(self._buffer_size, n_envs=self._n_envs, obs_keys=self._obs_keys, memmap=memmap, memmap_dir=memmap_dir)
        host.add({k: v.swapaxes(0, 1) for k, v in self.host_arrays().items()})
        host._pos = int(self._pos[0])
        host._full = bool(self._full[0])
        return host

    def ring_bytes(self) -> int:
        """Device bytes of the allocated ring."""
        if self._bufs is None:
            return 0
        tensors = [*self._pixels.values(), self._slab]
        return sum(t.numel() * t.element_size() for t in tensors)


def estimate_ring_bytes(obs_space: Any, actions_dim: Sequence[int], buffer_size: int, n_envs: int) -> int:
    """The ring's bytes for a Dreamer step dict (the obs keys, the actions
    and 4 scalar flags), before any data exists."""
    per_step = 0
    for k in obs_space.spaces:
        space = obs_space[k]
        itemsize = 1 if np.issubdtype(space.dtype, np.uint8) else 4
        per_step += int(np.prod(space.shape)) * itemsize
    per_step += (int(np.sum(actions_dim)) + 4) * 4
    return per_step * int(buffer_size) * int(n_envs)


def estimate_transition_bytes(
    obs_space: Any, keys: Sequence[str], actions_dim: Sequence[int], buffer_size: int, n_envs: int, store_next_obs: bool
) -> int:
    """The ring's bytes for a SAC-family step dict: the stored obs keys
    (twice when the loop stores the next observation too), the actions and
    3 scalar flags."""
    per_step = 0
    for k in keys:
        space = obs_space[k]
        itemsize = 1 if np.issubdtype(space.dtype, np.uint8) else 4
        per_step += int(np.prod(space.shape)) * itemsize
    if store_next_obs:
        per_step *= 2
    per_step += (int(np.sum(actions_dim)) + 3) * 4
    return per_step * int(buffer_size) * int(n_envs)


def resolve_device_buffer(
    cfg: Dict[str, Any],
    device: DeviceLike,
    obs_space: Any,
    actions_dim: Sequence[int],
    buffer_size: int,
    n_envs: int,
    estimated_bytes: Optional[int] = None,
) -> bool:
    """Whether this run keeps replay on ``device``: ``buffer.device`` true
    or false forces it; ``auto`` picks the ring when ``device`` is not the
    CPU and the estimated ring fits ``buffer.device_max_bytes``. The port
    runs one process on one device, where the JAX package's ring always
    fits a placement."""
    buffer_cfg = cfg["buffer"]
    spec = buffer_cfg.get("device", "auto")
    if spec in (True, "true", "True"):
        return True
    if spec in (False, "false", "False", None):
        return False
    if spec != "auto":
        raise ValueError(f"unknown buffer.device spec {spec!r}; use auto/true/false")
    if torch.device("cuda" if device is None else device).type == "cpu":
        return False
    est = estimated_bytes if estimated_bytes is not None else estimate_ring_bytes(obs_space, actions_dim, buffer_size, n_envs)
    return est <= int(buffer_cfg.get("device_max_bytes", 8_000_000_000))


def make_sequential_replay(
    cfg: Dict[str, Any],
    device: DeviceLike,
    obs_space: Any,
    actions_dim: Sequence[int],
    buffer_size: int,
    num_envs: int,
    obs_keys: Sequence[str],
    memmap_dir: Any,
    seed: Optional[int],
) -> Any:
    """The Dreamer loop's sequence replay: the ring when
    :func:`resolve_device_buffer` picks it, else the host
    ``EnvIndependentReplayBuffer`` (memmapped under ``memmap_dir`` with
    ``buffer.memmap``)."""
    if resolve_device_buffer(cfg, device, obs_space, actions_dim, buffer_size, num_envs):
        return DeviceReplayBuffer(buffer_size, n_envs=num_envs, obs_keys=obs_keys, device=device, seed=seed)
    return EnvIndependentReplayBuffer(
        buffer_size,
        n_envs=num_envs,
        obs_keys=obs_keys,
        memmap=bool(cfg["buffer"]["memmap"]),
        memmap_dir=memmap_dir,
        buffer_cls=SequentialReplayBuffer,
        seed=seed,
    )


def make_transition_replay(
    cfg: Dict[str, Any],
    device: DeviceLike,
    obs_space: Any,
    stored_keys: Sequence[str],
    actions_dim: Sequence[int],
    buffer_size: int,
    num_envs: int,
    obs_keys: Sequence[str],
    memmap_dir: Any,
    seed: Optional[int],
    store_next_obs: bool,
) -> Any:
    """The SAC family's transition replay: the ring when
    :func:`resolve_device_buffer` picks it for
    :func:`estimate_transition_bytes` of ``stored_keys`` (the observation
    keys the loop writes), else the host ``ReplayBuffer`` (memmapped under
    ``memmap_dir`` with ``buffer.memmap``). ``obs_keys`` are the step-dict
    keys that get a ``next_`` twin with ``sample_next_obs``."""
    est = estimate_transition_bytes(obs_space, stored_keys, actions_dim, buffer_size, num_envs, store_next_obs)
    if resolve_device_buffer(cfg, device, obs_space, actions_dim, buffer_size, num_envs, estimated_bytes=est):
        return DeviceReplayBuffer(buffer_size, n_envs=num_envs, obs_keys=obs_keys, device=device, seed=seed)
    return ReplayBuffer(
        buffer_size, num_envs, obs_keys=obs_keys, memmap=bool(cfg["buffer"]["memmap"]), memmap_dir=memmap_dir, seed=seed
    )


def adapt_restored_buffer(
    rb: Any,
    want_device: bool,
    seed: Optional[int] = None,
    memmap: bool = False,
    memmap_dir: Any = None,
    device: DeviceLike = None,
    mode: str = "sequence",
) -> Any:
    """A checkpoint's replay buffer in this run's mode: a ring or a host
    buffer resumes into either. ``mode`` names the host layout:
    ``sequence`` (the Dreamer loops' ``EnvIndependentReplayBuffer``) or
    ``transition`` (the SAC family's plain ``ReplayBuffer``). A host buffer
    lands memmapped under ``memmap_dir`` with ``memmap`` (the run's
    ``buffer.memmap``), as a fresh run of the config would hold it."""
    if mode not in ("sequence", "transition"):
        raise ValueError(f"unknown replay mode {mode!r}; use sequence/transition")
    if isinstance(rb, DeviceReplayBuffer):
        if want_device:
            return rb.restore_to_device(device)
        if mode == "transition":
            return rb.to_transition_host_buffer(memmap=memmap, memmap_dir=memmap_dir)
        return rb.to_host_buffer(memmap=memmap, memmap_dir=memmap_dir)
    if want_device and isinstance(rb, EnvIndependentReplayBuffer):
        return DeviceReplayBuffer.from_host_buffer(rb, device=device, seed=seed)
    if want_device and isinstance(rb, ReplayBuffer):
        return DeviceReplayBuffer.from_transition_host_buffer(rb, device=device, seed=seed)
    if memmap and isinstance(rb, EnvIndependentReplayBuffer) and not all(rb.is_memmap):
        rb.to_memmap(memmap_dir)
    elif memmap and isinstance(rb, ReplayBuffer) and not rb.is_memmap:
        rb.to_memmap(memmap_dir)
    return rb
