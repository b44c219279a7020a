"""The policy server: graph capture, replica set, stats, hot-swap watcher
(port of ``sheeprl_tpu/serve/server.py``).

:class:`PolicyServer` composes the serving tier:

- **warmup-before-traffic** — ``start()`` captures every ladder rung for
  every replica slot (:class:`~sheeprl_tpu_torch.serve.model.ModelStore`)
  *before* any replica is spawned; by the time ``infer`` can enqueue
  anything, every batch shape the server will ever run is captured
  (``warmup_s``: seconds a rung, all slots). ``submit`` before ``start``
  raises :class:`ServerClosed`.
- **request path** — ``infer(obs)`` = admission-controlled enqueue + wait on
  the request's Future, bounded by the request deadline (an unserved request
  — e.g. every replica masked — fails as :class:`DeadlineExceeded`, never
  hangs).
- **stats** — one :class:`ServeStats` aggregates counters (submitted /
  completed / shed / failed / restarts / swaps) and an end-to-end latency
  reservoir for p50/p95, snapshotted by ``snapshot()`` for telemetry and the
  load report.
- **hot swap** — with ``swap_poll_s > 0`` a watcher thread scans the
  checkpoint dir for newer *committed* manifests and promotes them through
  the :class:`~sheeprl_tpu_torch.serve.model.ModelStore` validation
  gauntlet; ``request_swap`` does the same on demand and raises on
  rejection.

The JAX package's executable cache (``serve.aot_cache_dir``) stores XLA
executables; a CUDA graph cannot be serialized, so the port refuses it
(ROADMAP A10).
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, List, Optional

from sheeprl_tpu_torch.resilience.manifest import CommittedCheckpoint, read_manifest
from sheeprl_tpu_torch.serve.batching import MicroBatcher, Request
from sheeprl_tpu_torch.serve.config import ServeConfig
from sheeprl_tpu_torch.serve.errors import DeadlineExceeded, ServerClosed, SwapRejected
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.serve.model import PAUSE_TIMEOUT_S, ModelStore, ModelVersion, ServedPolicy
from sheeprl_tpu_torch.serve.supervisor import ReplicaSet


class ServeStats:
    """Thread-safe serving counters + a bounded end-to-end latency reservoir."""

    RESERVOIR = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_t: Optional[float] = None
        self.submitted = 0
        self.completed = 0
        self.shed_overloaded = 0
        self.shed_expired = 0
        self.failed = 0
        self.batches = 0
        self.batched_requests = 0
        self._latencies: List[float] = []  # ring buffer of end-to-end seconds
        self._lat_pos = 0
        self.events: Dict[str, int] = {}  # supervision/swap event counts by kind

    def mark_started(self) -> None:
        with self._lock:
            self.started_t = time.monotonic()

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_complete(self, latency_s: float) -> None:
        with self._lock:
            self.completed += 1
            if len(self._latencies) < self.RESERVOIR:
                self._latencies.append(latency_s)
            else:
                self._latencies[self._lat_pos] = latency_s
                self._lat_pos = (self._lat_pos + 1) % self.RESERVOIR
    def record_failed(self) -> None:
        with self._lock:
            self.failed += 1

    def record_shed(self, kind: str) -> None:
        with self._lock:
            if kind == "overloaded":
                self.shed_overloaded += 1
            else:
                self.shed_expired += 1

    def record_batch(self, size: int, latency_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += size

    def record_event(self, kind: str) -> None:
        with self._lock:
            self.events[kind] = self.events.get(kind, 0) + 1

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._latencies:
                return None
            ordered = sorted(self._latencies)
        idx = min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))
        return ordered[idx]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            elapsed = time.monotonic() - self.started_t if self.started_t is not None else 0.0
            snap: Dict[str, Any] = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed_overloaded": self.shed_overloaded,
                "shed_expired": self.shed_expired,
                "failed": self.failed,
                "batches": self.batches,
                "mean_batch": (self.batched_requests / self.batches) if self.batches else 0.0,
                "uptime_s": elapsed,
                "qps": (self.completed / elapsed) if elapsed > 0 else 0.0,
                "events": dict(self.events),
            }
        for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95)):
            p = self.percentile(q)
            snap[name] = (p * 1e3) if p is not None else None
        return snap


class ServingFacade:
    """What both tiers (this single server and the replica fleet,
    ``serve/fleet.py``) do alike behind the facade the client, the load
    generator and the CLI talk to: waiting out a request, the hot swap and
    its watcher, counting events. A tier sets ``config``, ``stats``,
    ``store``, ``ckpt_dir``, ``_closing`` and ``_on_event``, and has
    ``start``, ``close``, ``submit`` and ``snapshot``."""

    def __enter__(self) -> Any:
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def wait(self, req: Request) -> Any:
        """Wait out a submitted request. Bounded: even with zero live
        replicas this fails by the request's own deadline."""
        budget = max(0.0, req.deadline_t - time.monotonic()) + 0.25
        try:
            out = req.future.result(timeout=budget)
        except DeadlineExceeded:
            self.stats.record_failed()
            raise
        except (TimeoutError, FutureTimeout):
            self.stats.record_failed()
            now = time.monotonic()
            raise DeadlineExceeded(now - req.enqueue_t, req.deadline_t - req.enqueue_t) from None
        except Exception:
            self.stats.record_failed()
            raise
        self._completed(time.monotonic() - req.enqueue_t)
        return out

    def _completed(self, latency_s: float) -> None:
        self.stats.record_complete(latency_s)

    # ------------------------------------------------------------------- swap
    def request_swap(self, ckpt_path: str) -> ModelVersion:
        """Promote ``ckpt_path`` now (on every replica slot at once); raises
        :class:`SwapRejected` if it does not survive validation
        (torn/uncommitted, digest mismatch, structure change, poisoned
        weights)."""
        if self.store is None:
            raise ServerClosed("server not started")
        man = read_manifest(ckpt_path)
        if man is None:
            raise SwapRejected(f"checkpoint {ckpt_path} has no commit manifest (torn or foreign write)")
        return self.store.request_swap(CommittedCheckpoint(int(man["step"]), ckpt_path, man))

    def maybe_swap(self) -> Optional[ModelVersion]:
        """One scan-and-maybe-promote pass over ``ckpt_dir`` (what the
        watcher thread runs on its poll cadence)."""
        if self.store is None or not self.ckpt_dir:
            return None
        return self.store.maybe_swap_newest(self.ckpt_dir)

    def _swap_watch(self) -> None:
        while not self._closing.wait(self.config.swap_poll_s):
            try:
                self.maybe_swap()
            except Exception:
                pass  # the watcher must outlive any one bad scan

    def _event(self, kind: str, info: Dict[str, Any]) -> None:
        self.stats.record_event(kind)
        if self._on_event is not None:
            try:
                self._on_event(kind, info)
            except Exception:
                pass


class PolicyServer(ServingFacade):
    """The serving facade the CLI, tests and load generator talk to."""

    def __init__(
        self,
        policy: ServedPolicy,
        config: ServeConfig,
        *,
        step: int,
        path: str,
        ckpt_dir: Optional[str] = None,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    ) -> None:
        if config.aot_cache_dir:
            raise NotImplementedError(
                "serve.aot_cache_dir: the JAX package caches XLA executables there; a CUDA graph cannot be "
                "serialized, and the port captures its ladder at start (ROADMAP A10)"
            )
        self.config = config
        self.policy = policy
        self.step = int(step)
        self.path = str(path)
        self.ckpt_dir = ckpt_dir
        self._on_event = on_event
        self.stats = ServeStats()
        self.fault_schedule = ServeFaultSchedule(config.faults) if config.faults else None
        self.batcher = MicroBatcher(
            max_queue=config.max_queue,
            gather_window_s=config.gather_window_s,
            on_shed=self.stats.record_shed,
        )
        self.store: Optional[ModelStore] = None
        self.replicas: Optional[ReplicaSet] = None
        self._swap_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._started = False
        self.warmup_s: Dict[int, float] = {}

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "PolicyServer":
        """Capture the ladder, then open for traffic. Blocking: when this
        returns every rung is captured for every slot and all replicas are
        pulling."""
        if self._started:
            return self
        self.store = ModelStore(
            self.policy,
            self.config.batch_ladder,
            step=self.step,
            path=self.path,
            slots=self.config.num_replicas,
            fault_schedule=self.fault_schedule,
            on_event=self._event,
        )
        self.warmup_s = dict(self.store.warmup_s)
        self.replicas = ReplicaSet(
            self.config,
            batcher=self.batcher,
            store=self.store,
            fault_schedule=self.fault_schedule,
            on_event=self._event,
            on_batch=self.stats.record_batch,
        )
        self.replicas.start()
        if self.config.swap_poll_s > 0 and self.ckpt_dir:
            self._swap_thread = threading.Thread(
                target=self._swap_watch, name="serve-swap-watch", daemon=True
            )
            self._swap_thread.start()
        self.stats.mark_started()
        self._started = True
        return self

    def close(self) -> None:
        self._closing.set()
        self.batcher.close()
        if self.replicas is not None:
            self.replicas.close()
        if self._swap_thread is not None:
            self._swap_thread.join(PAUSE_TIMEOUT_S)

    # ------------------------------------------------------------ request path
    def submit(self, obs: Any, deadline_s: Optional[float] = None) -> Request:
        """Admit a request (or raise Overloaded/ServerClosed immediately)."""
        if not self._started:
            raise ServerClosed("server not started: warmup has not run")
        self.stats.record_submit()
        try:
            return self.batcher.submit(obs, deadline_s or self.config.default_deadline_s)
        except Exception:
            self.stats.record_failed()
            raise

    def infer(self, obs: Any, deadline_s: Optional[float] = None) -> Any:
        """Blocking single-request inference, bounded by the deadline."""
        deadline_s = deadline_s or self.config.default_deadline_s
        req = self.submit(obs, deadline_s)
        return self.wait(req)

    # ------------------------------------------------------------------ stats
    def snapshot(self) -> Dict[str, Any]:
        snap = self.stats.snapshot()
        snap["queue_depth"] = self.batcher.depth()
        snap["slo_ms"] = self.config.slo_ms
        snap["batch_ladder"] = list(self.config.batch_ladder)
        snap["warmup_s"] = dict(self.warmup_s)
        if self.replicas is not None:
            snap["replicas_alive"] = self.replicas.alive_count
            snap["replicas_masked"] = self.replicas.masked_count
            snap["restarts"] = self.replicas.total_restarts
            snap["degraded"] = self.replicas.degraded
        if self.store is not None:
            snap["serving_step"] = self.store.current.step
            snap["swaps"] = self.store.swaps
            snap["swap_rejects"] = self.store.swap_rejects
            snap["rollbacks"] = self.store.rollbacks
        return snap
