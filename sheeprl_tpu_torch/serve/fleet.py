"""Replica-fleet serving: N policy replicas behind one router (port of
``sheeprl_tpu/serve/fleet.py``, the same contracts).

The single :class:`~sheeprl_tpu_torch.serve.server.PolicyServer` multiplexes
replica *threads* over one queue. The fleet is the next structural step:
each :class:`FleetSlot` is a full serving unit — its own continuous-batching
:class:`~sheeprl_tpu_torch.serve.slots.SlotPool` and its own
:class:`~sheeprl_tpu_torch.serve.model.ModelStore` slot (stream, one CUDA
graph a rung over each version's weights, pinned staging) — and the
:class:`~sheeprl_tpu_torch.serve.router.Router` in front owns every
fleet-wide decision. Composition:

- **placement** — the JAX fleet puts one replica on each local device. The
  port's device slots all share the one card (``cuda:0``), each with its own
  stream, graphs and staging; the ``cpu_spill_replicas`` slots run eager
  forwards on ``torch.device("cpu")`` over a CPU copy of each version's
  params, because the config asks for them. A capture or a placement that
  fails raises: no slot falls back to another device's ladder.
- **supervision** — the single-server doctrine (detect dead/hung, restart
  under a :class:`~sheeprl_tpu_torch.rollout.supervisor.RestartBudget` with
  exponential backoff, mask when the budget is spent, keep serving degraded
  on N-1) is re-instantiated per slot, with one fleet-shaping change: a dead
  replica's queued + in-flight work is *re-routed at the front of a sibling*
  (``router.reroute``) before the restart is even scheduled. A hung thread
  cannot be killed in Python, so a slot's next incarnation starts only once
  the previous one has left the slot's graphs (joined, and
  ``ModelStore.slot_busy`` clear); until then the restart is deferred
  (``replica_restart_deferred``) and two threads never replay one slot's
  graphs.
- **elastic scaling** — the monitor doubles as the autoscaler: sustained
  queue depth per active replica above ``scale_up_depth`` activates a
  standby slot, whose graphs are captured *before* it takes traffic (under
  the serving gate held alone: the pause is counted in ``slot_captures``);
  sustained depth below ``scale_down_depth`` retires the newest active slot
  (router stops routing, its queued work re-homes, the thread finishes its
  window). ``min_replicas`` / ``max_replicas`` bound both directions, and an
  emergency floor re-activates standby slots at once when masking drops the
  fleet below ``min_replicas``.
- **CPU spill** — ``batch``-priority traffic (eval / loadgen) goes to the
  spill slots when the device replicas are queueing past ``spill_depth``,
  keeping interactive latency flat while bulk traffic degrades gracefully
  instead of shedding.
- **chaos surface** — ``kill_replica(i)`` is the drill entry point: the
  replica dies *without completing its in-flight futures* (the worst legal
  crash), and the drills assert zero admitted requests are dropped while
  the survivors hold the SLO.

:class:`FleetServer` keeps the :class:`PolicyServer` facade (``infer`` /
``submit`` / ``wait`` / ``snapshot`` / ``request_swap`` / ``maybe_swap``),
so the client, the load generator and the telemetry pipeline serve either
tier unchanged. Remote replicas (``serve.fleet.remote_agents``) and the
executable cache are ROADMAP A10.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from sheeprl_tpu_torch.obs.telemetry import telemetry_request_path
from sheeprl_tpu_torch.obs.trace import trace_event
from sheeprl_tpu_torch.rollout.supervisor import RestartBudget
from sheeprl_tpu_torch.serve.config import ServeConfig
from sheeprl_tpu_torch.serve.errors import Overloaded, ServerClosed
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.serve.model import PAUSE_TIMEOUT_S, ModelStore, ServedPolicy
from sheeprl_tpu_torch.serve.replica import InjectedCrash, ReplicaStats
from sheeprl_tpu_torch.serve.router import INTERACTIVE, RoutedRequest, Router, RouteTarget
from sheeprl_tpu_torch.serve.server import ServeStats, ServingFacade
from sheeprl_tpu_torch.serve.slots import SlotPool, safe_complete

DEVICE = "device"
CPU_SPILL = "cpu_spill"


class FleetReplica(threading.Thread):
    """One serving incarnation bound to one slot's pool and graphs.

    Differences from the single-server replica are exactly the fleet
    contracts: work it cannot finish stays *in its pool* (in-flight window
    included) for the router to re-home, and ``kill()`` makes it die without
    completing futures — the crash shape the chaos drill injects.
    """

    def __init__(
        self,
        index: int,
        *,
        pool: SlotPool,
        store: ModelStore,
        stats: ReplicaStats,
        batch_counter: Any,
        breaker_threshold: int,
        fault_schedule: Optional[ServeFaultSchedule] = None,
        poll_timeout_s: float = 0.05,
        on_batch: Optional[Callable[[int, float], None]] = None,
        on_shed: Optional[Callable[[str], None]] = None,
    ) -> None:
        super().__init__(name=f"fleet-replica-{index}", daemon=True)
        self.index = index
        self.pool = pool
        self.store = store
        self.stats = stats
        self._batch_counter = batch_counter
        self.breaker_threshold = int(breaker_threshold)
        self._faults = fault_schedule
        self._poll_timeout_s = float(poll_timeout_s)
        self._on_batch = on_batch
        self._on_shed = on_shed
        self._stop_evt = threading.Event()
        self._killed = threading.Event()
        self.exit_reason: Optional[str] = None

    def request_stop(self) -> None:
        self._stop_evt.set()

    def kill(self) -> None:
        """Chaos entry point: die at the next check WITHOUT completing
        in-flight futures. The work stays in the pool for re-routing."""
        self._killed.set()
        self._stop_evt.set()

    # ------------------------------------------------------------------- loop
    def run(self) -> None:  # pragma: no cover - exercised via the fleet tests
        try:
            self._loop()
        except InjectedCrash as err:
            self.exit_reason = f"injected crash: {err}"
        except Exception as err:
            self.exit_reason = f"crashed: {err!r}"
        else:
            self.exit_reason = "killed" if self._killed.is_set() else self.exit_reason or "stopped"

    def _loop(self) -> None:
        while not self._stop_evt.is_set() and not self.pool.closed:
            self.stats.beat()
            batch = self.pool.take_batch(self._poll_timeout_s)
            if self._killed.is_set():
                return  # batch (if any) stays in the in-flight window
            if not batch:
                continue
            self._serve_batch(batch)

    def _serve_batch(self, batch: List[Any]) -> None:
        batch_index = next(self._batch_counter)
        if self._faults is not None:
            for fault in self._faults.batch_faults(self.index, batch_index):
                if fault.kind == "slow_inference":
                    self._sleep_injected(fault.duration_s)
                elif fault.kind == "replica_crash":
                    # the batch stays in the pool's in-flight window; the
                    # fleet monitor re-routes it at the front of a sibling
                    raise InjectedCrash(f"scheduled replica_crash at batch {batch_index}")
        t0 = time.monotonic()
        try:
            outputs, served_step, t_staged = self.store.infer_staged(
                self.index,
                len(batch),
                lambda host, rung: self.pool.staged_batch(batch, rung, out=host),
                beat=self.stats.beat,
            )
            t_done = time.monotonic()
        except Exception as err:
            self.stats.failures += 1
            self.stats.consecutive_failures += 1
            self.pool.requeue_failed(batch)
            if self.stats.consecutive_failures >= self.breaker_threshold:
                raise RuntimeError(
                    f"circuit breaker open after {self.stats.consecutive_failures} "
                    f"consecutive inference failures"
                ) from err
            return
        if self._killed.is_set():
            return  # die before delivery: futures stay pending → re-routed
        latency_s = time.monotonic() - t0
        self.stats.consecutive_failures = 0
        self.stats.batches += 1
        self.stats.requests += len(batch)
        self.stats.beat()
        now = time.monotonic()
        for req, out in zip(batch, outputs):
            if req.future.done():
                continue  # hedge twin won
            if req.expired(now):
                req.fail_expired(now)
                if self._on_shed is not None:
                    try:
                        self._on_shed("expired")
                    except Exception:
                        pass
            else:
                # the step of the version whose graphs computed this batch,
                # stamped BEFORE completion (a waiter reads it right after)
                req.served_step = served_step
                delivered = safe_complete(req, out)
                if delivered and req.trace_id:
                    # critical-path decomposition, measured at the replica
                    # that actually delivered the result: queue-wait is
                    # admission→this batch's start, assembly is the staging
                    # row-gather into the rung's pinned buffers, compute is
                    # copy in, replay, copy out
                    queue_wait_ms = (t0 - req.enqueue_t) * 1e3
                    assembly_ms = (t_staged - t0) * 1e3
                    compute_ms = (t_done - t_staged) * 1e3
                    hedged = len(getattr(req, "placements", ())) > 1
                    rerouted = getattr(req, "rerouted", 0) > 0
                    trace_event(
                        "request_done",
                        req.trace_id,
                        rid=req.rid,
                        replica=self.index,
                        batch=len(batch),
                        queue_wait_ms=queue_wait_ms,
                        assembly_ms=assembly_ms,
                        compute_ms=compute_ms,
                        hedged=hedged,
                        rerouted=rerouted,
                    )
                    telemetry_request_path(
                        queue_wait_ms=queue_wait_ms,
                        assembly_ms=assembly_ms,
                        compute_ms=compute_ms,
                        hedged=hedged,
                        rerouted=rerouted,
                    )
        self.pool.complete_batch(batch)
        if self._on_batch is not None:
            try:
                self._on_batch(len(batch), latency_s)
            except Exception:
                pass

    def _sleep_injected(self, duration_s: float) -> None:
        end = time.monotonic() + duration_s
        while not self._stop_evt.is_set():
            remaining = end - time.monotonic()
            if remaining <= 0:
                return
            self.stats.beat()  # slow, not hung
            time.sleep(min(0.02, remaining))


class FleetSlot:
    """One supervised fleet position. The slot — not any thread incarnation —
    owns the pool, the batch counter, the restart budget, the device and the
    activation state, so all of them survive restarts (its graphs live in
    the store's slot of the same index)."""

    def __init__(self, index: int, kind: str, device: torch.device, config: ServeConfig, *, obs_spec: Any = None) -> None:
        self.index = index
        self.kind = kind
        self.device = device
        self.pool = SlotPool(
            capacity=config.max_batch,
            backlog_bound=config.fleet.backlog_per_replica,
            obs_spec=obs_spec,
        )
        self.batch_counter = itertools.count()
        self.budget = RestartBudget(config.max_restarts, config.restart_refund_s)
        self.thread: Optional[FleetReplica] = None
        self.stats: Optional[ReplicaStats] = None
        self.active = False  # routable position (autoscaler toggles)
        self.retiring = False
        self.masked = False
        self.mask_reason: Optional[str] = None
        self.restart_at: Optional[float] = None
        self.restart_deferrals = 0  # restarts held back by a hung-alive thread
        self.restarts = 0
        self.total_requests = 0
        self.total_failures = 0

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def health(self, now: float, timeout_s: float) -> float:
        """Routing weight in [0, 1]: 0 = unroutable, decaying with heartbeat
        age so a struggling replica sheds traffic before it is declared
        hung."""
        if not self.active or self.masked or self.retiring or not self.alive:
            return 0.0
        if self.restart_at is not None:
            # declared hung, awaiting restart: the thread may be alive (stuck
            # in a dispatch) but nothing will serve new work until respawn
            return 0.0
        if self.stats is None:
            return 0.0
        age = max(0.0, now - self.stats.heartbeat)
        return max(0.05, 1.0 - age / max(timeout_s, 1e-6))

    def fold_stats(self) -> None:
        if self.stats is not None:
            self.total_requests += self.stats.requests
            self.total_failures += self.stats.failures


class FleetServer(ServingFacade):
    """N supervised replicas + router behind the ``PolicyServer`` facade
    (``wait``, ``request_swap``, ``maybe_swap`` and the swap watcher are
    :class:`~sheeprl_tpu_torch.serve.server.ServingFacade`'s)."""

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
        if not config.fleet.enabled:
            raise ValueError("FleetServer requires serve.fleet.enabled=true")
        if config.fleet.remote_agents:
            raise NotImplementedError(
                "serve.fleet.remote_agents: remote replicas need the network plane, which is not ported to "
                "sheeprl_tpu_torch yet (ROADMAP.md A10)"
            )
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
        self.slots: List[FleetSlot] = []
        self.router: Optional[Router] = None
        self.store: Optional[ModelStore] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._swap_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._started = False
        self.warmup_s: Dict[int, float] = {}
        # standby slots captured at activation: {"replica", "capture_s", "pause_s"}
        self.slot_captures: List[Dict[str, Any]] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self._pressure_streak = 0
        self._idle_streak = 0
        self._last_autoscale_t = 0.0

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "FleetServer":
        """Capture the initial replicas' graphs, then open the front door.
        When this returns every initially-active replica is captured and
        pulling; standby slots are captured at activation, before routing."""
        if self._started:
            return self
        fleet = self.config.fleet
        spec = self.policy.obs_spec
        for i in range(fleet.max_replicas):
            self.slots.append(FleetSlot(i, DEVICE, self.policy.device, self.config, obs_spec=spec))
        for j in range(fleet.cpu_spill_replicas):
            self.slots.append(FleetSlot(fleet.max_replicas + j, CPU_SPILL, torch.device("cpu"), self.config, obs_spec=spec))
        standby = [s.index for s in self.slots if s.kind == DEVICE and s.index >= fleet.num_replicas]
        self.store = ModelStore(
            self.policy,
            self.config.batch_ladder,
            step=self.step,
            path=self.path,
            slot_devices=[s.device for s in self.slots],
            standby=standby,
            fault_schedule=self.fault_schedule,
            on_event=self._event,
        )
        self.warmup_s = dict(self.store.warmup_s)
        for slot in self.slots:
            if slot.index not in standby:
                slot.active = True
                self._spawn(slot)

        self.router = Router(
            targets=self._route_targets,
            max_pending=fleet.resolved_max_pending(self.config),
            slo_s=self.config.slo_ms / 1e3,
            hedge_quantile=fleet.hedge_quantile,
            hedge_floor_s=fleet.hedge_floor_ms / 1e3,
            hedge_max=fleet.hedge_max,
            hedge_scan_s=fleet.hedge_scan_ms / 1e3,
            spill_depth=fleet.spill_depth,
            fault_schedule=self.fault_schedule,
            on_event=self._event,
        ).start()

        self._monitor_thread = threading.Thread(target=self._monitor, name="fleet-monitor", daemon=True)
        self._monitor_thread.start()
        if self.config.swap_poll_s > 0 and self.ckpt_dir:
            self._swap_thread = threading.Thread(target=self._swap_watch, name="fleet-swap-watch", daemon=True)
            self._swap_thread.start()
        self.stats.mark_started()
        self._started = True
        return self

    def close(self) -> None:
        self._closing.set()
        if self.router is not None:
            self.router.close()
        if self._monitor_thread is not None:
            self._monitor_thread.join(PAUSE_TIMEOUT_S)
        for slot in self.slots:
            if slot.thread is not None:
                slot.thread.request_stop()
        deadline = time.monotonic() + 2.0
        for slot in self.slots:
            if slot.thread is not None:
                slot.thread.join(max(0.0, deadline - time.monotonic()))
            slot.fold_stats()
            slot.pool.close()
        if self._swap_thread is not None:
            self._swap_thread.join(PAUSE_TIMEOUT_S)

    # ------------------------------------------------------------ request path
    def submit(
        self,
        obs: Any,
        deadline_s: Optional[float] = None,
        *,
        priority: str = INTERACTIVE,
        idempotent: bool = True,
    ) -> RoutedRequest:
        if not self._started or self.router is None:
            raise ServerClosed("fleet not started: warmup has not run")
        self.stats.record_submit()
        try:
            return self.router.submit(
                obs,
                deadline_s or self.config.default_deadline_s,
                idempotent=idempotent,
                priority=priority,
            )
        except Exception as err:
            if isinstance(err, Overloaded):
                self.stats.record_shed("overloaded")
            self.stats.record_failed()
            raise

    def infer(
        self,
        obs: Any,
        deadline_s: Optional[float] = None,
        *,
        priority: str = INTERACTIVE,
        idempotent: bool = True,
    ) -> Any:
        req = self.submit(obs, deadline_s, priority=priority, idempotent=idempotent)
        return self.wait(req)

    def _completed(self, latency_s: float) -> None:
        self.stats.record_complete(latency_s)
        if self.router is not None:
            self.router.record_latency(latency_s)  # the hedge quantile's history

    # ------------------------------------------------------------------ chaos
    def kill_replica(self, index: int) -> bool:
        """Drill API: make replica ``index`` die without completing its
        in-flight futures. Returns False when it has no live thread."""
        slot = self.slots[index]
        if slot.thread is None or not slot.thread.is_alive():
            return False
        slot.thread.kill()
        self._event("replica_killed", {"replica": index})
        trace_event("replica_killed", replica=index)  # process-scoped (tid 0)
        return True

    # ------------------------------------------------------------------ stats
    def snapshot(self) -> Dict[str, Any]:
        snap = self.stats.snapshot()
        snap["slo_ms"] = self.config.slo_ms
        snap["batch_ladder"] = list(self.config.batch_ladder)
        snap["warmup_s"] = dict(self.warmup_s)
        snap["queue_depth"] = self.router.pending_depth() if self.router else 0
        routable = [s for s in self.slots if s.active and not s.masked]
        snap["replicas_alive"] = sum(1 for s in routable if s.alive)
        snap["replicas_masked"] = sum(1 for s in self.slots if s.masked)
        snap["restarts"] = sum(s.restarts for s in self.slots)
        snap["degraded"] = snap["replicas_masked"] > 0
        if self.store is not None:
            snap["serving_step"] = self.store.current.step
            snap["swaps"] = self.store.swaps
            snap["swap_rejects"] = self.store.swap_rejects
            snap["rollbacks"] = self.store.rollbacks
        now = time.monotonic()
        snap["fleet"] = {
            "active_device_replicas": sum(1 for s in self.slots if s.kind == DEVICE and s.active and not s.masked),
            "cpu_spill_replicas": sum(1 for s in self.slots if s.kind == CPU_SPILL and s.active),
            "remote_replicas": 0,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "slot_captures": [dict(c) for c in self.slot_captures],
            "router": self.router.snapshot() if self.router else {},
            "replicas": [
                {
                    "index": s.index,
                    "kind": s.kind,
                    "device": str(s.device),
                    "remote": None,
                    "active": s.active,
                    "alive": s.alive,
                    "masked": s.masked,
                    "retiring": s.retiring,
                    "restarts": s.restarts,
                    "health": round(s.health(now, self.config.replica_timeout_s), 3),
                    "depth": s.pool.depth(),
                    "outstanding": s.pool.outstanding(),
                    "requests": s.total_requests + (s.stats.requests if s.stats is not None else 0),
                    "failures": s.total_failures + (s.stats.failures if s.stats is not None else 0),
                }
                for s in self.slots
            ],
        }
        return snap

    # ---------------------------------------------------------------- monitor
    def _route_targets(self) -> List[RouteTarget]:
        now = time.monotonic()
        timeout = self.config.replica_timeout_s
        return [RouteTarget(s.index, s.pool, s.health(now, timeout), s.kind) for s in self.slots if s.active]

    def _monitor(self) -> None:
        interval = self.config.monitor_interval_s
        fleet = self.config.fleet
        self._last_autoscale_t = time.monotonic()
        while not self._closing.is_set():
            now = time.monotonic()
            for slot in self.slots:
                try:
                    self._supervise_slot(slot, now)
                except Exception as err:
                    # one bad pass on one slot must not kill the fleet's only
                    # supervision thread (mirrors the hedge scan's loop)
                    self._event("monitor_error", {"replica": slot.index, "error": repr(err)})
            if now - self._last_autoscale_t >= fleet.autoscale_interval_s:
                self._last_autoscale_t = now
                try:
                    self._autoscale()
                except Exception as err:
                    self._event("monitor_error", {"replica": None, "error": repr(err)})
            self._closing.wait(interval)

    def _supervise_slot(self, slot: FleetSlot, now: float) -> None:
        if not slot.active or slot.masked:
            if self.router is not None and not slot.alive and slot.pool.outstanding():
                # a placement ranked while the slot was routable can land
                # after it was masked or retired and drained: nothing would
                # serve it here, so it re-homes like a dead replica's work
                self.router.reroute(slot.index, slot.pool, "stranded", inflight="all")
            return
        if slot.restart_at is not None:
            if now < slot.restart_at:
                return
            if self._previous_busy(slot):
                # the hung incarnation is still inside a dispatch on this
                # slot: a second thread would replay its graphs beside it,
                # so the restart waits until the old thread has left them
                # (its late complete/requeue is ownership-checked anyway)
                slot.restart_at = now + max(self.config.monitor_interval_s, 0.05)
                if slot.restart_deferrals == 0:
                    self._event("replica_restart_deferred", {"replica": slot.index})
                slot.restart_deferrals += 1
                return
            slot.restart_at = None
            slot.restart_deferrals = 0
            self._spawn(slot)
            return
        if not slot.alive:
            reason = (slot.thread.exit_reason if slot.thread is not None else None) or "thread exited"
            self._handle_fault(slot, reason)
        elif slot.stats is not None and now - slot.stats.heartbeat > self.config.replica_timeout_s:
            age = now - slot.stats.heartbeat
            slot.thread.request_stop()
            self._event("replica_hung", {"replica": slot.index, "heartbeat_age_s": age})
            self._handle_fault(slot, f"hung (heartbeat {age:.1f}s stale)")

    def _handle_fault(self, slot: FleetSlot, reason: str) -> None:
        """Crash-requeue-at-front, fleet edition: the dead replica's work is
        re-routed to a sibling FIRST, then the restart/mask decision runs —
        recovery of the *work* never waits on recovery of the *worker*."""
        if self.router is not None:
            # a dead thread's in-flight window re-homes in full; a hung but
            # still-alive thread may yet finish its dispatch, so only its
            # idempotent requests are duplicated (hedge semantics) — the
            # rest complete when it wakes or expire by their own deadline
            alive = slot.thread is not None and slot.thread.is_alive()
            self.router.reroute(slot.index, slot.pool, reason, inflight="idempotent" if alive else "all")
        slot.fold_stats()
        if slot.budget.exhausted:
            slot.masked = True
            slot.mask_reason = reason
            slot.thread = None
            slot.stats = None
            self._event(
                "replica_masked",
                {
                    "replica": slot.index,
                    "reason": reason,
                    "restarts": slot.restarts,
                    "alive": sum(1 for s in self.slots if s.alive),
                    "degraded": True,
                },
            )
            return
        charge = slot.budget.charge()
        slot.restarts += 1
        backoff = self.config.backoff_s(charge)
        slot.restart_at = time.monotonic() + backoff
        self._event(
            "replica_restart",
            {"replica": slot.index, "reason": reason, "restarts": slot.restarts, "backoff_s": backoff},
        )

    def _autoscale(self) -> None:
        fleet = self.config.fleet

        def active_device() -> List[FleetSlot]:
            return [s for s in self.slots if s.kind == DEVICE and s.active and not s.masked]

        def standby() -> List[FleetSlot]:
            return [s for s in self.slots if s.kind == DEVICE and not s.active and not s.masked]

        device_slots = active_device()
        # emergency floor, no patience: masking can drop the fleet below
        # min_replicas — even to zero, where no queue-depth signal could ever
        # fire again — so standby slots are re-activated immediately. The
        # hedge scan then re-places every stranded request on the recovered
        # capacity.
        if len(device_slots) < fleet.min_replicas:
            for slot in standby()[: fleet.min_replicas - len(device_slots)]:
                self._activate(slot, {"reason": "below_min_replicas"})
            device_slots = active_device()
        if not device_slots:
            return
        depth_per = sum(s.pool.depth() for s in device_slots) / len(device_slots)
        if depth_per >= fleet.scale_up_depth:
            self._pressure_streak += 1
            self._idle_streak = 0
        elif depth_per <= fleet.scale_down_depth:
            self._idle_streak += 1
            self._pressure_streak = 0
        else:
            self._pressure_streak = 0
            self._idle_streak = 0
        if self._pressure_streak >= fleet.scale_patience:
            self._pressure_streak = 0
            waiting = standby()
            if waiting:
                self._activate(waiting[0], {"depth_per_replica": depth_per})
        elif self._idle_streak >= fleet.scale_patience:
            self._idle_streak = 0
            if len(device_slots) > fleet.min_replicas:
                slot = device_slots[-1]
                slot.retiring = True  # router stops targeting it immediately
                if self.router is not None:
                    # a healthy retiring thread finishes its own in-flight
                    # dispatch (re-homing it would double-run non-idempotent
                    # requests); only its queued work moves to a sibling
                    alive = slot.thread is not None and slot.thread.is_alive()
                    self.router.reroute(slot.index, slot.pool, "scale_down", inflight="none" if alive else "all")
                if slot.thread is not None:
                    slot.thread.request_stop()
                slot.active = False
                slot.retiring = False
                self.scale_downs += 1
                self._event("fleet_scale_down", {"replica": slot.index})

    # --------------------------------------------------------------- internal
    def _activate(self, slot: FleetSlot, info: Dict[str, Any]) -> None:
        """Bring standby ``slot`` into rotation: its graphs are captured
        first (a failed capture raises and the slot stays on standby), then
        it becomes routable and its replica starts."""
        if not self.store.has_graphs(slot.index):
            capture = self.store.capture_slot(slot.index)
            self.slot_captures.append({"replica": slot.index, **capture})
        # counted before the slot takes traffic: no snapshot shows it serving
        # uncounted
        self.scale_ups += 1
        slot.retiring = False
        slot.active = True
        self._spawn(slot)
        self._event("fleet_scale_up", {"replica": slot.index, **info})

    def _previous_busy(self, slot: FleetSlot) -> bool:
        """Whether the slot's previous incarnation may still run its graphs:
        stopped and joined briefly, it counts as gone only once its thread
        has exited and the store's slot lock is free."""
        prev = slot.thread
        if prev is not None and prev.is_alive():
            prev.request_stop()
            prev.join(0.05)
        return (prev is not None and prev.is_alive()) or self.store.slot_busy(slot.index)

    def _spawn(self, slot: FleetSlot) -> None:
        if self._previous_busy(slot):
            # never run two incarnations on one slot (a hung thread mid
            # dispatch, or a retired thread finishing its window): arm a
            # deferred restart; the monitor spawns once the slot is free
            slot.restart_at = time.monotonic() + max(self.config.monitor_interval_s, 0.05)
            return
        slot.stats = ReplicaStats()
        slot.thread = FleetReplica(
            slot.index,
            pool=slot.pool,
            store=self.store,
            stats=slot.stats,
            batch_counter=slot.batch_counter,
            breaker_threshold=self.config.breaker_threshold,
            fault_schedule=self.fault_schedule,
            on_batch=self.stats.record_batch,
            on_shed=self.stats.record_shed,
        )
        slot.thread.start()
