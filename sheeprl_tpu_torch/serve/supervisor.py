"""Supervision of the replica set: restart-with-budget, masking, degraded mode
(port of ``sheeprl_tpu/serve/supervisor.py``).

The JAX rollout pool's supervision doctrine, for threads:

- **detect** — a replica is *dead* when its thread has exited (crash fault,
  circuit breaker, organic exception) and *hung* when its heartbeat is older
  than ``replica_timeout_s``. Hung threads cannot be killed in Python; they
  are abandoned (stop-flagged so they exit if they ever wake) and replaced,
  which is the same observable outcome. The slot's graphs and buffers have
  one owner at a time, so the replacement starts only once the abandoned
  thread has left them (``ModelStore.slot_busy``); until then the slot is
  down and its siblings serve.
- **restart under budget** — each slot owns a
  :class:`~sheeprl_tpu_torch.rollout.supervisor.RestartBudget` (max_restarts with
  healthy-window refunds), restarts are scheduled with exponential backoff
  and executed by the monitor loop without blocking it.
- **mask, don't crash** — a slot whose budget is exhausted is masked: the
  server keeps serving on N-1 (degraded mode, visible in stats) rather than
  dying because one replica is beyond saving. With ALL slots masked the
  server stays up and requests fail by their own deadlines — the typed
  failure a client can reason about.

The monitor is one thread with a short interval; every decision it makes is
also re-derivable from the slot state it records (restarts, masks, reasons),
which is what the fault-drill tests assert against.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.rollout.supervisor import RestartBudget
from sheeprl_tpu_torch.serve.batching import MicroBatcher
from sheeprl_tpu_torch.serve.config import ServeConfig
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.serve.model import ModelStore
from sheeprl_tpu_torch.serve.replica import Replica, ReplicaStats


class ReplicaSlot:
    """One supervised serving slot. The slot (not the thread) owns the batch
    counter and the restart budget so both survive replica incarnations
    (its graphs, in each version's ``ladders[index]``, survive them too)."""

    def __init__(self, index: int, config: ServeConfig) -> None:
        self.index = index
        self.batch_counter = itertools.count()
        self.budget = RestartBudget(config.max_restarts, config.restart_refund_s)
        self.thread: Optional[Replica] = None
        self.stats: Optional[ReplicaStats] = None
        self.restarts = 0  # lifetime total (telemetry; budget may refund)
        self.masked = False
        self.mask_reason: Optional[str] = None
        self.restart_at: Optional[float] = None  # pending backoff-scheduled restart
        self.total_requests = 0
        self.total_failures = 0

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def fold_stats(self) -> None:
        """Accumulate the dying incarnation's counters into slot totals."""
        if self.stats is not None:
            self.total_requests += self.stats.requests
            self.total_failures += self.stats.failures


class ReplicaSet:
    """The supervised pool of serving replicas over one shared queue/model."""

    def __init__(
        self,
        config: ServeConfig,
        *,
        batcher: MicroBatcher,
        store: ModelStore,
        fault_schedule: Optional[ServeFaultSchedule] = None,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        on_batch: Optional[Callable[[int, float], None]] = None,
    ) -> None:
        self.config = config
        self.batcher = batcher
        self.store = store
        self._faults = fault_schedule
        self._on_event = on_event
        self._on_batch = on_batch
        self.slots: List[ReplicaSlot] = [ReplicaSlot(i, config) for i in range(config.num_replicas)]
        self._monitor_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        for slot in self.slots:
            self._spawn(slot)
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="serve-monitor", daemon=True
        )
        self._monitor_thread.start()

    def close(self, timeout_s: float = 2.0) -> None:
        self._closing.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout_s)
        for slot in self.slots:
            if slot.thread is not None:
                slot.thread.request_stop()
        deadline = time.monotonic() + timeout_s
        for slot in self.slots:
            if slot.thread is not None:
                slot.thread.join(max(0.0, deadline - time.monotonic()))
            slot.fold_stats()

    # -------------------------------------------------------------- inspection
    @property
    def alive_count(self) -> int:
        return sum(1 for s in self.slots if s.alive)

    @property
    def masked_count(self) -> int:
        return sum(1 for s in self.slots if s.masked)

    @property
    def degraded(self) -> bool:
        return self.masked_count > 0

    @property
    def all_masked(self) -> bool:
        return self.masked_count == len(self.slots)

    @property
    def total_restarts(self) -> int:
        return sum(s.restarts for s in self.slots)

    # ---------------------------------------------------------------- monitor
    def _monitor(self) -> None:
        interval = self.config.monitor_interval_s
        while not self._closing.is_set() and not self.batcher.closed:
            now = time.monotonic()
            for slot in self.slots:
                if slot.masked:
                    continue
                if slot.restart_at is not None:
                    if now >= slot.restart_at and not self.store.slot_busy(slot.index):
                        slot.restart_at = None
                        self._spawn(slot)
                    continue
                if not slot.alive:
                    reason = (
                        slot.thread.exit_reason if slot.thread is not None else None
                    ) or "thread exited"
                    self._handle_fault(slot, reason)
                elif (
                    slot.stats is not None
                    and now - slot.stats.heartbeat > self.config.replica_timeout_s
                ):
                    # hung, not dead: abandon the thread, replace the slot
                    age = now - slot.stats.heartbeat
                    slot.thread.request_stop()
                    self._emit("replica_hung", {"replica": slot.index, "heartbeat_age_s": age})
                    self._handle_fault(slot, f"hung (heartbeat {age:.1f}s stale)")
            self._closing.wait(interval)

    def _handle_fault(self, slot: ReplicaSlot, reason: str) -> None:
        slot.fold_stats()
        if slot.budget.exhausted:
            slot.masked = True
            slot.mask_reason = reason
            slot.thread = None
            slot.stats = None
            self._emit(
                "replica_masked",
                {
                    "replica": slot.index,
                    "reason": reason,
                    "restarts": slot.restarts,
                    "alive": self.alive_count,
                    "degraded": True,
                },
            )
            return
        charge = slot.budget.charge()
        slot.restarts += 1
        backoff = self.config.backoff_s(charge)
        slot.restart_at = time.monotonic() + backoff
        self._emit(
            "replica_restart",
            {
                "replica": slot.index,
                "reason": reason,
                "restarts": slot.restarts,
                "backoff_s": backoff,
            },
        )

    def _spawn(self, slot: ReplicaSlot) -> None:
        slot.stats = ReplicaStats()
        slot.thread = Replica(
            slot.index,
            batcher=self.batcher,
            store=self.store,
            stats=slot.stats,
            batch_counter=slot.batch_counter,
            max_batch=self.config.max_batch,
            breaker_threshold=self.config.breaker_threshold,
            fault_schedule=self._faults,
            on_batch=self._on_batch,
        )
        slot.thread.start()

    def _emit(self, kind: str, info: Dict[str, Any]) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, info)
            except Exception:
                pass
