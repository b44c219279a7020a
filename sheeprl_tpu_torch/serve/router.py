"""The fleet's front door: admission, health-scored routing, hedged retries
(port of ``sheeprl_tpu/serve/router.py``, the same decisions; it touches no
tensor).

One :class:`Router` sits in front of N replica slot pools
(:mod:`sheeprl_tpu_torch.serve.fleet`) and owns every fleet-wide
request-path decision, so the per-replica machinery can stay dumb:

- **admission** — one fleet-wide pending bound (``serve.fleet`` scales the
  single-server ``max_queue``); past it, ``submit`` sheds with the same typed
  :class:`~sheeprl_tpu_torch.serve.errors.Overloaded` contract as the single
  server. Re-routed and hedged placements of already-admitted requests bypass
  admission — an admitted request is never shed by a fleet event it didn't
  cause.
- **routing** — consistent health-weighted least-loaded choice: each live
  replica gets a health score in ``(0, 1]`` decayed from its heartbeat age
  (fed by the fleet supervisor) and the router picks the lowest
  ``outstanding / health``. A sick-but-alive replica therefore sees traffic
  taper before the supervisor declares it dead, and routing is a pure
  function of observable state (no RNG) so drills replay exactly.
- **hedged retries** — a scan thread watches in-flight requests; one that has
  waited past the fleet's rolling latency quantile
  (``hedge_quantile``, floored by ``hedge_floor_ms``) is duplicated to a
  different replica. Only *idempotent* requests hedge (single-step policy
  calls are; anything submitted with ``idempotent=False`` never is), the
  first completion wins the request's Future, and the loser's copy is
  dropped at its pool's next dispatch assembly (``future.done()``), i.e. the
  losing twin is cancelled rather than served dead.
- **re-route-at-front** — when the fleet declares a replica dead, the
  router drains that replica's pool (in-flight window first, admission order
  preserved) and plants the work at the FRONT of the healthiest sibling:
  the single-server crash-requeue-at-front contract, promoted across
  replicas. Zero admitted requests are dropped by a crash; each still
  expires only by its own deadline. The in-flight window re-homes in full
  only when the replica thread is confirmed dead — a hung-but-alive thread
  may still finish its dispatch, so only its idempotent requests are
  duplicated (hedge semantics) and a healthy retiring thread keeps its
  whole window.
- **blackhole drill** — a scheduled ``router_blackhole`` fault makes the
  router swallow assignments for ``duration_s``: requests are admitted but
  reach no replica, and the hedge scan must rescue every one of them. This
  is the front door's own failure mode, drilled like every other.

The scan shares one interpreter with the monitor, N replica threads and the
CPU-spill replicas' forwards, so its passes can start late: each pass's
lateness against its nominal cadence is kept (``scan_lag_ms`` in the
snapshot: p50, p95 and max over the newest passes).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

from sheeprl_tpu_torch.obs.trace import new_trace_id, trace_event, tracing_active
from sheeprl_tpu_torch.serve.batching import Request
from sheeprl_tpu_torch.serve.errors import Overloaded, ServerClosed
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.serve.slots import SlotPool

INTERACTIVE = "interactive"
BATCH = "batch"  # eval / loadgen traffic, spillable to CPU replicas


class RoutedRequest(Request):
    """A fleet request: a :class:`Request` plus routing state the hedge scan
    and the drills read. ``placements`` is the ordered list of replica
    indices this request was offered to (first = primary route)."""

    __slots__ = ("idempotent", "priority", "placements", "hedges", "rerouted", "routing")

    def __init__(
        self,
        obs: Any,
        enqueue_t: float,
        deadline_t: float,
        *,
        idempotent: bool = True,
        priority: str = INTERACTIVE,
    ) -> None:
        super().__init__(obs, enqueue_t, deadline_t)
        self.idempotent = bool(idempotent)
        self.priority = str(priority)
        self.placements: List[int] = []
        self.hedges = 0
        self.rerouted = 0
        # True while ``submit`` still places it: the scan leaves it alone
        self.routing = False


class RouteTarget(NamedTuple):
    """One routable replica as the fleet advertises it to the router."""

    index: int
    pool: SlotPool
    health: float  # (0, 1]; <= 0 means unroutable (masked/dead/retiring)
    kind: str  # "device" | "cpu_spill"


class Router:
    """Fleet front door. ``targets()`` is the fleet's live routing table —
    re-read on every decision so replica death/scale events take effect
    immediately; the router holds no replica state of its own."""

    LATENCY_RESERVOIR = 2048
    MIN_HEDGE_SAMPLES = 16
    SCAN_LAG_RESERVOIR = 1024  # newest scan passes whose lateness is kept

    def __init__(
        self,
        *,
        targets: Callable[[], List[RouteTarget]],
        max_pending: int,
        slo_s: float,
        hedge_quantile: float = 0.95,
        hedge_floor_s: float = 0.0,
        hedge_max: int = 1,
        hedge_scan_s: float = 0.005,
        spill_depth: int = 4,
        fault_schedule: Optional[ServeFaultSchedule] = None,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._targets = targets
        self.max_pending = int(max_pending)
        self._slo_s = float(slo_s)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_floor_s = float(hedge_floor_s)
        self.hedge_max = int(hedge_max)
        self._hedge_scan_s = float(hedge_scan_s)
        self.spill_depth = int(spill_depth)
        self._faults = fault_schedule
        self._on_event = on_event
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: Dict[int, RoutedRequest] = {}
        self._latencies: List[float] = []
        self._lat_pos = 0
        self._route_seq = 0
        self._blackhole_until = 0.0
        self._closing = threading.Event()
        self._scan_thread: Optional[threading.Thread] = None
        self._scan_lags: List[float] = []  # seconds each pass started late
        self._scan_lag_pos = 0
        # counters (drills and the fleet snapshot read these)
        self.routed = 0
        self.shed = 0
        self.hedged = 0
        self.hedged_won = 0  # completions that had at least one hedge twin
        self.rerouted_requests = 0
        self.blackholed = 0
        self.spilled = 0
        self.expired = 0  # backstop expiries of unplaced requests

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        if self._scan_thread is None:
            self._scan_thread = threading.Thread(
                target=self._scan, name="fleet-router-hedge", daemon=True
            )
            self._scan_thread.start()
        return self

    def close(self) -> None:
        self._closing.set()
        if self._scan_thread is not None:
            self._scan_thread.join(1.0)

    # ---------------------------------------------------------------- routing
    def submit(
        self,
        obs: Any,
        deadline_s: float,
        *,
        idempotent: bool = True,
        priority: str = INTERACTIVE,
    ) -> RoutedRequest:
        """Admit + route one request. Raises :class:`Overloaded` at the
        fleet-wide bound, :class:`ServerClosed` when no replica exists at
        all (fleet shut down)."""
        if self._closing.is_set():
            raise ServerClosed("fleet router is shut down")
        now = self._clock()
        # queued depth alone misses admitted-but-unplaced requests (blackhole
        # window, every pool full): they occupy no pool, so they must count
        # here or a blackhole makes the fleet-wide bound unenforceable
        depth = self.pending_depth() + self.unplaced_inflight()
        if depth >= self.max_pending:
            self._count("shed", 1)
            raise Overloaded(depth, self.max_pending, self._slo_s / 5.0)
        req = RoutedRequest(
            obs, now, now + float(deadline_s), idempotent=idempotent, priority=priority
        )
        # visible to the scan from the moment it enters _inflight; until
        # submit's own placement attempt is over, a rescue or a hedge from
        # the scan would place it a second time (a non-idempotent request
        # served twice)
        req.routing = True
        if tracing_active():
            # the request id is per-process; the trace id is the cross-process
            # causal handle — minted once here, it rides the shared request
            # object through every hedge/re-route/requeue placement. Minted
            # BEFORE the request enters _inflight: the hedge scan can place
            # an inflight-but-unplaced request from its own thread, and a
            # replica may dispatch and deliver that copy immediately — if the
            # mint raced that window the delivery would see trace_id == 0 and
            # the chain would dangle without its request_done
            req.trace_id = new_trace_id()
            trace_event(
                "request_admit",
                req.trace_id,
                rid=req.rid,
                priority=req.priority,
                idempotent=req.idempotent,
                deadline_ms=float(deadline_s) * 1e3,
            )
        with self._lock:
            seq = self._route_seq
            self._route_seq += 1
            self._inflight[req.rid] = req
        try:
            self._count("routed", 1)
            self._consume_router_faults(seq, now)
            if now < self._blackhole_until:
                # blackholed: admitted, tracked, but the assignment is
                # swallowed; the hedge scan is the rescue path for every one
                self._count("blackholed", 1)
                if req.trace_id:
                    trace_event("request_blackholed", req.trace_id, rid=req.rid)
                return req
            self._place(req, now)
            return req
        finally:
            req.routing = False

    def _place(self, req: RoutedRequest, now: float) -> bool:
        """Offer ``req`` to the best target it hasn't been placed on yet."""
        for target in self._ranked_targets(req):
            try:
                if target.pool.offer(req):
                    req.placements.append(target.index)
                    if target.kind == "cpu_spill":
                        self._count("spilled", 1)
                    if req.trace_id:
                        trace_event(
                            "request_route",
                            req.trace_id,
                            rid=req.rid,
                            replica=target.index,
                            attempt=len(req.placements),
                            target_kind=target.kind,
                        )
                    return True
            except ServerClosed:
                continue
        return False  # every pool full/closed: the hedge scan retries

    def _ranked_targets(self, req: RoutedRequest) -> List[RouteTarget]:
        """Routable targets, best first: health-weighted least-loaded.
        ``batch`` traffic spills to CPU replicas once the device replicas are
        queueing past ``spill_depth`` each; interactive traffic only ever
        lands on a spill replica when no device replica is routable."""
        live = [t for t in self._targets() if t.health > 0 and not t.pool.closed]
        fresh = [t for t in live if t.index not in req.placements]
        device = [t for t in fresh if t.kind != "cpu_spill"]
        spill = [t for t in fresh if t.kind == "cpu_spill"]

        def score(t: RouteTarget) -> float:
            return t.pool.outstanding() / max(t.health, 1e-6)

        device.sort(key=score)
        spill.sort(key=score)
        if req.priority == BATCH and spill:
            saturated = device and all(
                t.pool.depth() >= self.spill_depth for t in device
            )
            if saturated or not device:
                return spill + device
        return device + spill

    # ---------------------------------------------------------------- hedging
    def hedge_threshold_s(self) -> float:
        """How long a request may wait before it is hedged: the rolling
        ``hedge_quantile`` of completed fleet latencies, floored by
        ``hedge_floor_s``; one SLO until enough samples exist."""
        with self._lock:
            lats = sorted(self._latencies)
        if len(lats) < self.MIN_HEDGE_SAMPLES:
            return max(self.hedge_floor_s, self._slo_s)
        idx = min(len(lats) - 1, max(0, math.ceil(self.hedge_quantile * len(lats)) - 1))
        return max(self.hedge_floor_s, lats[idx])

    def record_latency(self, latency_s: float) -> None:
        """Feed one completed end-to-end latency into the hedge quantile."""
        with self._lock:
            if len(self._latencies) < self.LATENCY_RESERVOIR:
                self._latencies.append(latency_s)
            else:
                self._latencies[self._lat_pos] = latency_s
                self._lat_pos = (self._lat_pos + 1) % self.LATENCY_RESERVOIR

    def _scan(self) -> None:
        due = self._clock() + self._hedge_scan_s
        while not self._closing.wait(self._hedge_scan_s):
            self._record_scan_lag(max(0.0, self._clock() - due))
            try:
                self._scan_once()
            except Exception:
                pass  # the rescue path must outlive any one bad pass
            due = self._clock() + self._hedge_scan_s

    def _record_scan_lag(self, lag_s: float) -> None:
        with self._lock:
            if len(self._scan_lags) < self.SCAN_LAG_RESERVOIR:
                self._scan_lags.append(lag_s)
            else:
                self._scan_lags[self._scan_lag_pos] = lag_s
                self._scan_lag_pos = (self._scan_lag_pos + 1) % self.SCAN_LAG_RESERVOIR

    def scan_lag_ms(self) -> Dict[str, Any]:
        """How late the hedge scan's passes started against its cadence
        (ms, over the newest ``SCAN_LAG_RESERVOIR`` passes)."""
        with self._lock:
            lags = sorted(self._scan_lags)
        if not lags:
            return {"passes": 0, "p50": None, "p95": None, "max": None}

        def pct(q: float) -> float:
            return lags[min(len(lags) - 1, max(0, math.ceil(q * len(lags)) - 1))] * 1e3

        return {"passes": len(lags), "p50": pct(0.50), "p95": pct(0.95), "max": lags[-1] * 1e3}

    def _scan_once(self) -> None:
        now = self._clock()
        threshold = self.hedge_threshold_s()
        with self._lock:
            inflight = list(self._inflight.values())
        for req in inflight:
            if req.future.done():
                with self._lock:
                    self._inflight.pop(req.rid, None)
                if req.hedges and not req.future.exception():
                    self._count("hedged_won", 1)
                continue
            if now >= req.deadline_t:
                # backstop expiry: a placed request is normally expired by
                # its pool at dispatch assembly, but an unplaced one (black-
                # holed, every pool full, re-route with no live sibling) is
                # in NO pool — without this it would leak in-flight forever
                # and its consumer would hang on a raw future
                req.fail_expired(now)
                with self._lock:
                    self._inflight.pop(req.rid, None)
                self._count("expired", 1)
                if req.trace_id:
                    trace_event(
                        "request_expired",
                        req.trace_id,
                        rid=req.rid,
                        waited_ms=(now - req.enqueue_t) * 1e3,
                    )
                continue
            if req.routing:
                continue  # submit is placing it
            if not req.placements and now >= self._blackhole_until:
                # swallowed by a blackhole (or every pool was full): rescue
                if self._place(req, now):
                    self._emit("router_rescue", {"rid": req.rid})
                continue
            if (
                req.idempotent
                and req.hedges < self.hedge_max
                and now - req.enqueue_t >= threshold
            ):
                if self._place(req, now):
                    req.hedges += 1
                    self._count("hedged", 1)
                    self._emit(
                        "hedge",
                        {
                            "rid": req.rid,
                            "waited_ms": (now - req.enqueue_t) * 1e3,
                            "threshold_ms": threshold * 1e3,
                            "placements": list(req.placements),
                        },
                    )
                    if req.trace_id:
                        trace_event(
                            "request_hedge",
                            req.trace_id,
                            rid=req.rid,
                            replica=req.placements[-1],
                            waited_ms=(now - req.enqueue_t) * 1e3,
                            threshold_ms=threshold * 1e3,
                        )

    # -------------------------------------------------------------- re-routing
    def reroute(self, index: int, pool: SlotPool, reason: str, *, inflight: str = "all") -> int:
        """Drain a dead/retiring replica's pool and plant the work — in
        admission order — at the FRONT of the healthiest surviving sibling.
        Returns how many requests were re-homed. Requests with no live
        sibling stay tracked in-flight; the hedge scan keeps retrying them
        until a replica returns or their own deadline expires.

        ``inflight`` (see :meth:`SlotPool.drain`) scopes the in-flight
        window: ``"all"`` only when the replica thread is confirmed dead —
        re-homing a live thread's window would run non-idempotent requests
        twice. A hung-but-alive replica uses ``"idempotent"`` (duplication
        there is hedging: first completion wins), a healthy retiring one
        ``"none"``."""
        drained = pool.drain(inflight=inflight)
        if not drained:
            return 0
        moved = 0
        for req in drained:
            if isinstance(req, RoutedRequest):
                req.rerouted += 1
        targets = [
            t
            for t in self._ranked_targets_any()
            if t.index != index and t.health > 0 and not t.pool.closed
        ]
        for target in targets:
            try:
                target.pool.offer_front(drained)
            except ServerClosed:
                continue  # closed between the ranking and the offer: next one
            for req in drained:
                if isinstance(req, RoutedRequest):
                    req.placements.append(target.index)
            moved = len(drained)
            break
        if moved == 0:
            # nowhere to go right now: leave them in-flight; the scan retries
            for req in drained:
                if isinstance(req, RoutedRequest):
                    req.placements.clear()
        self._count("rerouted_requests", moved)
        self._emit(
            "reroute",
            {"replica": index, "reason": reason, "requests": len(drained), "moved": moved},
        )
        # one batched trace event per reroute (not one per request): the
        # merger expands trace_ids so every victim's chain carries the
        # re-route attribution without a hot-path write per request
        tids = [r.trace_id for r in drained if getattr(r, "trace_id", 0)]
        if tids:
            trace_event(
                "request_reroute",
                replica=index,
                reason=reason,
                moved=moved,
                trace_ids=tids,
            )
        return moved

    def _ranked_targets_any(self) -> List[RouteTarget]:
        live = [t for t in self._targets() if t.health > 0 and not t.pool.closed]
        return sorted(live, key=lambda t: t.pool.outstanding() / max(t.health, 1e-6))

    # ------------------------------------------------------------------ stats
    def pending_depth(self) -> int:
        """Fleet-wide queued depth (the admission + autoscale signal)."""
        return sum(t.pool.depth() for t in self._targets())

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def unplaced_inflight(self) -> int:
        """Admitted requests currently in NO pool (blackholed, or every pool
        was full/closed at placement). Part of the admission signal."""
        with self._lock:
            return sum(
                1
                for r in self._inflight.values()
                if not r.placements and not r.future.done()
            )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "routed": self.routed,
            "shed": self.shed,
            "hedged": self.hedged,
            "hedged_won": self.hedged_won,
            "rerouted_requests": self.rerouted_requests,
            "blackholed": self.blackholed,
            "spilled": self.spilled,
            "expired": self.expired,
            "inflight": self.inflight_count(),
            "unplaced_inflight": self.unplaced_inflight(),
            "pending_depth": self.pending_depth(),
            "hedge_threshold_ms": self.hedge_threshold_s() * 1e3,
            "scan_lag_ms": self.scan_lag_ms(),
        }

    # --------------------------------------------------------------- internal
    def _count(self, name: str, n: int) -> None:
        # client threads, the scan and the monitor all count: a bare += on
        # an attribute can lose an update between threads
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def _consume_router_faults(self, seq: int, now: float) -> None:
        if self._faults is None:
            return
        for fault in self._faults.router_faults(seq):
            self._blackhole_until = max(self._blackhole_until, now + fault.duration_s)
            self._emit(
                "router_blackhole",
                {"at_request": seq, "duration_s": fault.duration_s},
            )

    def _emit(self, kind: str, info: Dict[str, Any]) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, info)
            except Exception:
                pass
