"""Pinned, double-buffered batch prefetch (port of
``sheeprl_tpu/data/prefetch.py::sampled_batches``).

A background thread samples each train window's batches from the replay
buffer into a ring of ``depth`` pinned host buffers; the loop copies each
one with ``non_blocking=True`` on a copy stream into the static inputs of
the captured train step. CUDA events order the three: a copy waits for the
step that last read the inputs (``after``, recorded by the step after each
replay), the step waits for the copy, and a host buffer is handed back to
the sampler only once its copy has completed (the main thread polls the
events; the sampler thread makes no CUDA call, so it never disturbs a graph
capture). Pixels stay uint8 across the bus; everything else goes fp32.

With ``n_samples`` > 1 each item is a stack of that many batches, the
``[K, T, B, ...]`` inputs of a fused superstep over the host buffer, drawn
in one ``sample`` call as the JAX package's pregathered stack is.

On the CPU there is no stream and no pinned memory: the same loop samples
on the thread and copies synchronously.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Deque, Dict, Iterator, List, Optional

import numpy as np
import torch


class BatchPrefetcher:
    """Feeds ``[T, B, ...]`` sequence batches of ``rb`` (``[n_samples, T, B,
    ...]`` stacks with ``n_samples`` > 1) into ``inputs`` (the step's static
    input tensors, keyed as the buffer's sample)."""

    def __init__(
        self,
        rb: Any,
        batch_size: int,
        sequence_length: int,
        inputs: Dict[str, torch.Tensor],
        depth: int = 2,
        after: Optional["torch.cuda.Event"] = None,
        n_samples: int = 1,
    ) -> None:
        self.rb = rb
        self.batch_size = batch_size
        self.sequence_length = sequence_length
        self.n_samples = n_samples
        self.inputs = inputs
        self.after = after
        self.device = next(iter(inputs.values())).device
        cuda = self.device.type == "cuda"
        self.depth = max(1, int(depth))
        self._slots: List[Dict[str, torch.Tensor]] = [
            {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda) for k, v in inputs.items()} for _ in range(self.depth)
        ]
        self._host = [{k: t.numpy() for k, t in slot.items()} for slot in self._slots]
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = [torch.cuda.Event() for _ in range(self.depth)] if cuda else []
        self._inflight: Deque[int] = collections.deque()
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(self.depth):
            self._free.put(i)

    def _fill(self, idx: int) -> None:
        sample = self.rb.sample(self.batch_size, sequence_length=self.sequence_length, n_samples=self.n_samples)
        for k, dst in self._host[idx].items():
            np.copyto(dst, sample[k].reshape(dst.shape), casting="unsafe")

    def _worker(self, n: int, ready: "queue.Queue[Optional[int]]", stop: threading.Event, err: list) -> None:
        try:
            for _ in range(n):
                while True:
                    if stop.is_set():
                        return
                    try:
                        idx = self._free.get(timeout=0.05)
                        break
                    except queue.Empty:
                        continue
                self._fill(idx)
                ready.put(idx)
        except BaseException as e:  # surfaced on the consumer's thread
            err.append(e)
            ready.put(None)

    def _release(self, wait: bool) -> None:
        """Hand host buffers whose copies completed back to the sampler;
        with ``wait``, wait for the oldest copy first."""
        while self._inflight and (wait or self._copied[self._inflight[0]].query()):
            idx = self._inflight.popleft()
            self._copied[idx].synchronize()
            self._free.put(idx)
            wait = False

    def _load(self, idx: int) -> None:
        slot = self._slots[idx]
        if self._copy_stream is None:
            for k, dst in self.inputs.items():
                dst.copy_(slot[k])
            self._free.put(idx)
            return
        if self.after is not None:
            self._copy_stream.wait_event(self.after)
        with torch.cuda.stream(self._copy_stream):
            for k, dst in self.inputs.items():
                dst.copy_(slot[k], non_blocking=True)
        self._copied[idx].record(self._copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self._copied[idx])
        self._inflight.append(idx)

    def sampled_batches(self, n: int) -> Iterator[Dict[str, torch.Tensor]]:
        """``n`` times: the next batch is (or is being copied, in stream
        order, into) ``inputs``; yields ``inputs``."""
        ready: "queue.Queue[Optional[int]]" = queue.Queue()
        stop = threading.Event()
        err: list = []
        thread = threading.Thread(target=self._worker, args=(n, ready, stop, err), name="prefetch", daemon=True)
        thread.start()
        try:
            for _ in range(n):
                self._release(wait=False)
                while True:
                    try:
                        idx = ready.get(timeout=0.05)
                        break
                    except queue.Empty:
                        # every host buffer waits on a copy: free the oldest
                        self._release(wait=len(self._inflight) == self.depth)
                if idx is None:
                    raise RuntimeError("prefetch sampler failed") from err[0]
                self._load(idx)
                yield self.inputs
        finally:
            stop.set()
            thread.join(timeout=10.0)
            while not ready.empty():
                idx = ready.get_nowait()
                if idx is not None:
                    self._free.put(idx)
