"""Continuous batching: a per-replica slot pool replacing the gather window
(port of ``sheeprl_tpu/serve/slots.py``, the same contracts).

The single server's micro-batcher coalesces requests with a time window:
the first waiting request opens a ``gather_window_s`` gate and the batch
closes when the window elapses. That buys batch occupancy with latency —
every request pays up to one window of dead air even on an idle server.

The slot pool is the vLLM-style alternative, trivial for single-step
policies because there is no per-request generation state to keep resident:
the replica's in-flight batch is a window of ``capacity`` *slots* (capacity
= the top ladder rung), and a request is admitted into any free slot at any
time — including while the previous dispatch is still running on the card.
The replica loop runs back-to-back dispatches over whatever slots are
occupied; a lone request rides the very next dispatch with zero gather
latency, and a saturated replica runs full rungs continuously. Requests past
the slot window wait in a bounded FIFO *backlog* that refills slots as
dispatches free them.

Two properties the fleet's robustness contract leans on:

- **admission order is dispatch order** — slots and backlog are FIFO, every
  occupied slot rides the next dispatch, and ``offer(front=True)`` (the
  crash re-route path) inserts ahead of the backlog, so an admitted request
  is never reordered behind later admissions.
- **expiry only by a request's own deadline** — a request is completed
  exceptionally when *its* deadline passes (at dispatch assembly, exactly
  like the micro-batcher), never because a crash elsewhere re-routed it.

Observation staging is slot-resident: each pool preallocates rows for each
observation key (2x the slot window — the occupied slots and the in-flight
batch hold rows at the same time) and admission writes the request's obs
into its row at once. Batch assembly on the dispatch path is one
vectorized row-gather a key, written straight into the replica slot's
pinned host staging (the buffers its rung's CUDA graph copies from,
``serve/model.py::_Rung``) rather than into a fresh batch. A hedged request
sits in two pools at once; whichever copy loses is dropped at its pool's
next assembly and its row freed there, so rows cannot leak under hedging.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.obs.trace import trace_event
from sheeprl_tpu_torch.serve.batching import Request
from sheeprl_tpu_torch.serve.errors import ServerClosed


def safe_complete(req: Request, out: Any) -> bool:
    """Set ``req``'s result unless something else (a hedge twin, an expiry)
    beat us to it. Returns True when this call delivered the result."""
    if req.future.done():
        return False
    try:
        req.future.set_result(out)
        return True
    except Exception:  # InvalidStateError: lost the race to the hedge twin
        return False


class SlotPool:
    """One replica's continuous-batching window: ``capacity`` slots fed by a
    bounded FIFO backlog. ``obs_spec`` (key -> ``(shape, dtype)``, no batch
    axis) turns on slot-resident staging.

    ``on_expired(request)`` fires (outside the lock) for every request this
    pool completes exceptionally at dispatch assembly.
    """

    def __init__(
        self,
        *,
        capacity: int,
        backlog_bound: int,
        obs_spec: Optional[Dict[str, Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        on_expired: Optional[Callable[[Request], None]] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"slot pool capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.backlog_bound = int(backlog_bound)
        self._clock = clock
        self._on_expired = on_expired
        self._cond = threading.Condition()
        self._waiting: Deque[Request] = deque()  # occupied slots, admission order
        self._backlog: Deque[Request] = deque()
        # rid -> request, insertion-ordered. Keyed (not a plain list) so
        # release is ownership-checked per dispatch: a stale replica
        # incarnation whose window was already drained/re-routed releases
        # nothing, and can never clobber the live incarnation's tracking.
        self._inflight: Dict[int, Request] = {}
        self._closed = False
        # slot-resident obs staging. Rows must cover the occupied slot window
        # AND the in-flight batch at once — continuous batching admits into
        # slots while the previous dispatch still holds its rows — so the
        # buffer carries 2 * capacity rows (waiting <= capacity, in-flight
        # <= capacity, nothing else stages).
        self._spec = obs_spec
        self._buffers: Optional[Dict[str, np.ndarray]] = None
        self._rows: Dict[int, int] = {}  # rid -> staged slot row
        self._free_rows: List[int] = list(range(2 * self.capacity))
        if obs_spec is not None:
            self._buffers = {
                k: np.zeros((2 * self.capacity, *shape), dtype=dtype) for k, (shape, dtype) in obs_spec.items()
            }

    # ------------------------------------------------------------- admission
    def offer(self, req: Request, *, front: bool = False) -> bool:
        """Place ``req`` into a free slot (else the backlog). Returns False
        when slots and backlog are both full — the caller (router) owns the
        fleet-wide admission decision, this is per-replica capacity only.
        ``front=True`` is the re-route path: the request was admitted before
        anything now waiting here, so it goes ahead of the backlog (or into
        the head of the slot window when one is free)."""
        with self._cond:
            if self._closed:
                raise ServerClosed("slot pool is shut down")
            if len(self._waiting) < self.capacity:
                self._stage(req)
                if front:
                    self._waiting.appendleft(req)
                else:
                    self._waiting.append(req)
                self._cond.notify()
                return True
            if len(self._backlog) >= self.backlog_bound:
                return False
            if front:
                self._backlog.appendleft(req)
            else:
                self._backlog.append(req)
            return True

    # -------------------------------------------------------------- dispatch
    def take_batch(self, wait_timeout_s: float) -> List[Request]:
        """Block up to ``wait_timeout_s`` for at least one occupied slot,
        then take the whole occupied window (admission order) as the next
        dispatch, refilling slots from the backlog. ``[]`` on timeout/close
        so replica loops can heartbeat. Expired requests are completed
        exceptionally here — by their own deadline — and never dispatched."""
        expired: List[Request] = []
        batch: List[Request] = []
        dropped: List[Request] = []
        with self._cond:
            deadline = self._clock() + wait_timeout_s
            while not self._waiting and not self._closed:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            if self._closed and not self._waiting:
                return []
            now = self._clock()
            while self._waiting:
                req = self._waiting.popleft()
                if req.future.done():  # hedge twin won, or already expired
                    self._unstage(req)
                    dropped.append(req)
                    continue
                (expired if req.expired(now) else batch).append(req)
            for req in expired:
                self._unstage(req)
            for req in batch:
                self._inflight[req.rid] = req
                # first-dispatch stamp for the critical-path decomposition
                # (queue wait = enqueue → here); a hedge twin keeps the
                # winner's first stamp, shared via the request object
                if req.t_dispatch is None:
                    req.t_dispatch = now
            self._refill_locked()
        now = self._clock()
        for req in dropped:
            # a done-skipped request here is a cancelled hedge loser (an
            # expired one was completed by its winner/expiry path already):
            # mark the loser's copy on the timeline, outside the lock
            if req.trace_id and not req.future.exception():
                trace_event("request_hedge_drop", req.trace_id, rid=req.rid)
        for req in expired:
            req.fail_expired(now)
            if self._on_expired is not None:
                try:
                    self._on_expired(req)
                except Exception:
                    pass
        return batch

    def complete_batch(self, batch: Sequence[Request]) -> None:
        """Release ``batch``'s slice of the in-flight window (called by the
        replica after the dispatch's futures are settled) and free its staged
        rows. Only requests this pool still tracks in-flight are released: a
        stale incarnation — declared hung, its window drained and re-routed,
        then waking late — releases nothing that now belongs to the live
        incarnation."""
        with self._cond:
            for req in batch:
                if self._inflight.pop(req.rid, None) is not None:
                    self._unstage(req)
            self._refill_locked()

    def staged_batch(
        self, batch: Sequence[Request], rung: int, out: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        """Assemble the padded obs batch for ``batch`` at ladder rung
        ``rung`` from the slot-resident staging rows (one vectorized gather
        a key), into ``out``'s ``[rung, ...]`` arrays when given (a replica
        slot's pinned host staging) or fresh ones. Rows past ``len(batch)``
        are zeroed. With staging off the requests' own obs are stacked."""
        if out is None:
            out = {k: np.zeros((rung, *shape), dtype=dtype) for k, (shape, dtype) in self._spec.items()}
        n = len(batch)
        if self._buffers is None:
            for k, (_, dtype) in self._spec.items():
                for i, req in enumerate(batch):
                    out[k][i] = np.asarray(req.obs[k], dtype=dtype)
                out[k][n:] = 0
            return out
        with self._cond:
            # stage-on-demand backstop: a request can only be row-less here if
            # the 2x-capacity invariant was violated; never fail a dispatch
            # over it (the request still holds its obs)
            for req in batch:
                if req.rid not in self._rows:
                    self._stage(req)
            rows = [self._rows.get(r.rid) for r in batch]
        for k, buf in self._buffers.items():
            dst = out[k]
            if None not in rows:
                dst[:n] = buf[rows]
            else:
                for i, (req, row) in enumerate(zip(batch, rows)):
                    dst[i] = buf[row] if row is not None else np.asarray(req.obs[k], dtype=buf.dtype)
            dst[n:] = 0
        return out

    # ------------------------------------------------------------ re-routing
    def offer_front(self, reqs: Sequence[Request]) -> None:
        """Plant an ordered block of already-admitted requests AHEAD of this
        pool's backlog (the re-route-at-front path). Bypasses the backlog
        bound for the same reason the micro-batcher's ``requeue`` bypasses
        admission: these requests were admitted once — a fleet event they
        didn't cause must not shed them. Relative order is preserved; they
        ride the next dispatches as slots free up."""
        with self._cond:
            if self._closed:
                raise ServerClosed("slot pool is shut down")
            for req in reversed(reqs):
                if not req.future.done():
                    self._backlog.appendleft(req)
            self._refill_locked()

    def requeue_failed(self, batch: Sequence[Request]) -> None:
        """Hand a failed dispatch back to this pool at the front (the batch
        has waited longest). Releases the batch's in-flight slice, so call
        INSTEAD of ``complete_batch``. Same ownership check: requests a drain
        already re-routed are not requeued here — they ride their sibling."""
        with self._cond:
            owned = [r for r in batch if self._inflight.pop(r.rid, None) is not None]
            for req in owned:
                self._unstage(req)
            if not self._closed:
                for req in reversed(owned):
                    if not req.future.done():
                        self._backlog.appendleft(req)
            self._refill_locked()

    def drain(self, *, inflight: str = "all") -> List[Request]:
        """Pull every request this pool still owes work for — the in-flight
        window first (it has waited longest), then occupied slots, then the
        backlog, preserving admission order within each — so a dead replica's
        work can be re-routed at the FRONT of a sibling. The pool stays open
        (a restarted incarnation reuses it).

        ``inflight`` scopes the window when the replica thread may still be
        executing it: ``"all"`` (the replica is confirmed dead — nothing else
        will ever complete these), ``"idempotent"`` (hung but alive: re-home
        only what is safe to run twice, first completion wins exactly like a
        hedge; non-idempotent requests stay with their original executor),
        ``"none"`` (healthy and retiring: it finishes its own window)."""
        with self._cond:
            drained: List[Request] = []
            if inflight != "none":
                for req in list(self._inflight.values()):
                    if inflight == "idempotent" and not getattr(req, "idempotent", True):
                        continue
                    del self._inflight[req.rid]
                    self._unstage(req)
                    if not req.future.done():
                        drained.append(req)
            drained += [r for r in self._waiting if not r.future.done()]
            drained += [r for r in self._backlog if not r.future.done()]
            for req in list(self._waiting):
                self._unstage(req)
            self._waiting.clear()
            self._backlog.clear()
        return drained

    # ------------------------------------------------------------ inspection
    def depth(self) -> int:
        """Queued work (occupied slots + backlog), the autoscale signal."""
        with self._cond:
            return len(self._waiting) + len(self._backlog)

    def outstanding(self) -> int:
        """Everything this pool owes an answer for (queued + in flight), the
        router's load score."""
        with self._cond:
            return len(self._waiting) + len(self._backlog) + len(self._inflight)

    def free_rows(self) -> int:
        """Staging rows not held by a request (``2 * capacity`` when idle)."""
        with self._cond:
            return len(self._free_rows)

    @property
    def closed(self) -> bool:
        return self._closed

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop admitting; fail everything still queued with ServerClosed."""
        with self._cond:
            self._closed = True
            pending = list(self._waiting) + list(self._backlog)
            self._waiting.clear()
            self._backlog.clear()
            self._rows.clear()
            self._free_rows = list(range(2 * self.capacity))
            self._cond.notify_all()
        for req in pending:
            if not req.future.done():
                try:
                    req.future.set_exception(ServerClosed("slot pool is shut down"))
                except Exception:
                    pass

    # -------------------------------------------------------------- internal
    def _refill_locked(self) -> None:
        while self._backlog and len(self._waiting) < self.capacity:
            req = self._backlog.popleft()
            if req.future.done():
                continue
            self._stage(req)
            self._waiting.append(req)
        if self._waiting:
            self._cond.notify()

    def _stage(self, req: Request) -> None:
        if self._buffers is None:
            return
        if req.rid in self._rows or not self._free_rows:
            return
        row = self._free_rows.pop()
        self._rows[req.rid] = row
        for k, buf in self._buffers.items():
            buf[row] = np.asarray(req.obs[k], dtype=buf.dtype)

    def _unstage(self, req: Request) -> None:
        if self._buffers is None:
            return
        row = self._rows.pop(req.rid, None)
        if row is not None:
            self._free_rows.append(row)
