"""The dispatch fence (port of ``sheeprl_tpu/parallel/fabric.py::
DispatchFence``, :720-752).

A loop that never waits on the card can run arbitrarily far ahead of it.
``push`` records a CUDA event on the current stream after each train
window and, once more than ``depth`` windows are in flight, waits for the
oldest; in the steady state that event has long completed and the wait
costs nothing. On the CPU there is nothing to bound and both calls return.
"""

from __future__ import annotations

import collections
from typing import Deque

import torch


class DispatchFence:
    def __init__(self, device: torch.device, depth: int = 4) -> None:
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self._pending: Deque[torch.cuda.Event] = collections.deque()

    def push(self) -> None:
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._pending.append(event)
        while len(self._pending) > self.depth:
            self._pending.popleft().synchronize()

    def drain(self) -> None:
        while self._pending:
            self._pending.popleft().synchronize()
