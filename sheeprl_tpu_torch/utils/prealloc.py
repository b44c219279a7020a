"""Preallocated rollout storage for the on-policy host loops (port of
``sheeprl_tpu/utils/prealloc.py``).

A ``RolloutBuffer`` holds per-key ``[T, ...]`` tensors, allocated on the
first window from the first written value's shape and dtype, on the
buffer's device, and written in place (``buf.put(t, values)``: the write is
the copy). On the card the buffer is where the rollout lives: the values
the player computed there are copied there, the env's numpy values cross
the bus once, and a captured update reads the same tensors at every replay.

``RolloutStore`` keeps one slot: the two-slot overlap that
``algo.overlap_collection`` needs is not ported (ROADMAP A4; the loop
raises on the option).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


class RolloutBuffer:
    """One window's storage: per-key ``[length, ...]`` tensors on
    ``device``, allocated lazily and reused."""

    def __init__(self, length: int, device: Optional[torch.device] = None) -> None:
        self._length = int(length)
        self.device = torch.device("cpu") if device is None else device
        self._arrays: Dict[str, torch.Tensor] = {}

    def put(self, t: int, values: Mapping[str, Any]) -> None:
        """Write one step's values at index ``t`` (an in-place copy; numpy
        values cross to the device)."""
        for k, v in values.items():
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            arr = self._arrays.get(k)
            if arr is None:
                arr = self._arrays[k] = torch.zeros((self._length, *v.shape), dtype=v.dtype, device=self.device)
            arr[t].copy_(v, non_blocking=True)

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The ``[T, ...]`` tensors (the live buffers, not copies)."""
        return dict(self._arrays)


class RolloutStore:
    """The buffer of each update's window: one slot (the JAX store's second
    slot serves ``algo.overlap_collection``, which is not ported)."""

    def __init__(self, length: int, device: Optional[torch.device] = None) -> None:
        self._buffer = RolloutBuffer(length, device)

    def begin(self, update: int) -> RolloutBuffer:
        """The buffer for this update's window."""
        return self._buffer
