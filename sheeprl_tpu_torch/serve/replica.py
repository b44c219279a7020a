"""One serving replica: a worker thread pulling micro-batches off the queue
(port of ``sheeprl_tpu/serve/replica.py``).

Replicas are intentionally dumb — pull a batch, inject any scheduled faults,
run the batch on this slot's graphs of the current version of the shared
:class:`~sheeprl_tpu_torch.serve.model.ModelStore`, stamp the version's
step on each request and complete the futures. All recovery intelligence lives one level up
(:mod:`sheeprl_tpu_torch.serve.supervisor`); the replica's contribution to
robustness is the contract it dies by:

- **no request is lost to a crash** — the batch is re-queued *before* the
  failure propagates, so in-flight requests ride out replica death (they are
  re-served by a sibling, or expire against their own deadline).
- **circuit breaker** — ``breaker_threshold`` consecutive inference failures
  trip the replica: it re-queues and exits rather than chewing through the
  queue failing every batch. The supervisor then restarts it under the
  restart budget; a sick model (rather than a sick replica) therefore fails
  N replicas * budget restarts and degrades to an empty replica set instead
  of spinning forever.
- **heartbeats** — a monotone timestamp the supervisor uses to detect a hung
  (not dead) replica; inference runs between heartbeats, so a replica stuck
  in a pathological forward is indistinguishable from a dead one and gets
  restarted the same way (once it has left the slot's graphs). Waiting for
  a swap's flip is not a hang: the replica beats while it waits.

Batch indices are per-replica-slot monotone counters owned by the
supervisor, so the deterministic fault schedule keeps its position across
restarts (a restarted replica does not re-fire ``at_batch`` faults). The
slot's graphs outlive its replica threads too: a restart captures nothing.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

from sheeprl_tpu_torch.serve.batching import MicroBatcher, Request
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.serve.model import ModelStore


class InjectedCrash(RuntimeError):
    """A scheduled ``replica_crash`` fault firing (distinguishable in logs
    from an organic inference failure)."""


class ReplicaStats:
    """Shared mutable counters, written by the replica thread, read by the
    supervisor/stats reporters. Single-writer, so plain attributes are fine;
    ``heartbeat`` is the liveness signal."""

    __slots__ = ("heartbeat", "batches", "requests", "failures", "consecutive_failures")

    def __init__(self) -> None:
        self.heartbeat = time.monotonic()
        self.batches = 0
        self.requests = 0
        self.failures = 0
        self.consecutive_failures = 0

    def beat(self) -> None:
        self.heartbeat = time.monotonic()


class Replica(threading.Thread):
    """A serving worker. ``batch_counter`` is the supervisor-owned iterator
    yielding this slot's monotone batch indices; ``on_batch(n, latency_s)``
    reports completed work for the stats pipeline."""

    def __init__(
        self,
        index: int,
        *,
        batcher: MicroBatcher,
        store: ModelStore,
        stats: ReplicaStats,
        batch_counter: "itertools.count[int]",
        max_batch: int,
        breaker_threshold: int,
        fault_schedule: Optional[ServeFaultSchedule] = None,
        poll_timeout_s: float = 0.05,
        on_batch: Optional[Callable[[int, float], None]] = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__(name=name or f"serve-replica-{index}", daemon=True)
        self.index = index
        self.batcher = batcher
        self.store = store
        self.stats = stats
        self._batch_counter = batch_counter
        self.max_batch = int(max_batch)
        self.breaker_threshold = int(breaker_threshold)
        self._faults = fault_schedule
        self._poll_timeout_s = float(poll_timeout_s)
        self._on_batch = on_batch
        self._stop_evt = threading.Event()
        self.exit_reason: Optional[str] = None

    def request_stop(self) -> None:
        self._stop_evt.set()

    # ------------------------------------------------------------------- loop
    def run(self) -> None:  # pragma: no cover - exercised via the server tests
        try:
            self._loop()
        except InjectedCrash as err:
            self.exit_reason = f"injected crash: {err}"
        except Exception as err:
            self.exit_reason = f"crashed: {err!r}"
        else:
            self.exit_reason = self.exit_reason or "stopped"

    def _loop(self) -> None:
        while not self._stop_evt.is_set() and not self.batcher.closed:
            self.stats.beat()
            batch = self.batcher.next_batch(self.max_batch, self._poll_timeout_s)
            if not batch:
                continue
            self._serve_batch(batch)
        # drain nothing on the way out: pending work belongs to siblings

    def _serve_batch(self, batch: List[Request]) -> None:
        batch_index = next(self._batch_counter)
        if self._faults is not None:
            for fault in self._faults.batch_faults(self.index, batch_index):
                if fault.kind == "slow_inference":
                    self._sleep_injected(fault.duration_s)
                elif fault.kind == "replica_crash":
                    # crash contract: work survives the worker
                    self.batcher.requeue(batch)
                    raise InjectedCrash(f"scheduled replica_crash at batch {batch_index}")
        t0 = time.monotonic()
        try:
            outputs, served_step = self.store.infer([r.obs for r in batch], slot=self.index, beat=self.stats.beat)
        except Exception as err:
            self.stats.failures += 1
            self.stats.consecutive_failures += 1
            if self.stats.consecutive_failures >= self.breaker_threshold:
                # breaker trip: hand the work back, die, let the supervisor
                # decide whether this slot has restart budget left
                self.batcher.requeue(batch)
                raise RuntimeError(
                    f"circuit breaker open after {self.stats.consecutive_failures} "
                    f"consecutive inference failures"
                ) from err
            self.batcher.requeue(batch)
            return
        latency_s = time.monotonic() - t0
        self.stats.consecutive_failures = 0
        self.stats.batches += 1
        self.stats.requests += len(batch)
        self.stats.beat()
        now = time.monotonic()
        for req, out in zip(batch, outputs):
            if not req.future.done():
                if req.expired(now):
                    # result arrived too late: route through requeue so the
                    # expiry is completed AND counted as shed in one place
                    self.batcher.requeue([req])
                else:
                    # the step of the version whose graphs computed this batch
                    req.served_step = served_step
                    req.future.set_result(out)
        if self._on_batch is not None:
            try:
                self._on_batch(len(batch), latency_s)
            except Exception:
                pass

    def _sleep_injected(self, duration_s: float) -> None:
        # interruptible sleep so close() doesn't wait out a long slow-fault
        end = time.monotonic() + duration_s
        while not self._stop_evt.is_set():
            remaining = end - time.monotonic()
            if remaining <= 0:
                return
            self.stats.beat()  # slow, not hung: keep the supervisor informed
            time.sleep(min(0.02, remaining))
