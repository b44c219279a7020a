"""SLO-bounded micro-batching queue with admission control (port of
``sheeprl_tpu/serve/batching.py``: pure threading, the same semantics).

The inference-server pattern: concurrent single-request callers are coalesced
into one batched forward. Two robustness rules make it production-shaped
rather than a demo:

- **bounded queue + explicit shedding** — ``submit`` REJECTS with a typed
  :class:`~sheeprl_tpu_torch.serve.errors.Overloaded` the moment the pending count
  hits ``max_queue``. Backlog is never unbounded, so p95 latency is bounded
  by construction: at most ``max_queue / throughput`` of queueing can
  accumulate, and the caller (not the server) decides whether to retry.
- **per-request deadlines** — every request carries an absolute deadline;
  expired requests are completed exceptionally (:class:`DeadlineExceeded`)
  at the next batch assembly instead of being served dead work.

Batch assembly is latency-SLO-bounded: the first waiting request opens a
gather window (``gather_window_s``, derived from the SLO); the batch closes
when the window elapses or the ladder's top rung fills, whichever is first.
A lone request therefore pays at most one gather window of queueing, and a
saturated server runs full rungs back to back.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Deque, List, Optional

from sheeprl_tpu_torch.serve.errors import DeadlineExceeded, Overloaded, ServerClosed

_REQUEST_IDS = itertools.count()


class Request:
    """One in-flight inference request: observation + deadline + Future."""

    __slots__ = ("obs", "enqueue_t", "deadline_t", "future", "rid", "attempts", "trace_id", "t_dispatch", "served_step")

    def __init__(self, obs: Any, enqueue_t: float, deadline_t: float) -> None:
        self.obs = obs
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.future: Future = Future()
        self.rid = next(_REQUEST_IDS)
        self.attempts = 0  # inference attempts (re-queues after replica failures)
        # trace-plane context (obs/trace.py): the causal id minted at the
        # fleet router's admission (0 = untraced; the single server never
        # mints one) and the monotonic first-dispatch stamp. Both live on the
        # shared request object, so one causal chain survives hedging,
        # re-route-at-front and requeue (every copy is the same object)
        self.trace_id = 0
        self.t_dispatch: Optional[float] = None
        # checkpoint step of the version whose graphs computed this request's
        # batch (stamped by the replica that completes it; -1 until then)
        self.served_step: int = -1

    def expired(self, now: float) -> bool:
        return now >= self.deadline_t

    def fail_expired(self, now: float) -> None:
        if not self.future.done():
            try:
                self.future.set_exception(
                    DeadlineExceeded(now - self.enqueue_t, self.deadline_t - self.enqueue_t)
                )
            except InvalidStateError:
                pass  # a fleet's hedge twin delivered between the check and here


class MicroBatcher:
    """The shared request queue between the submit path and the replicas.

    ``on_shed(kind)`` is the stats hook (``kind`` in ``overloaded`` /
    ``expired``); it fires outside the lock.
    """

    def __init__(
        self,
        *,
        max_queue: int,
        gather_window_s: float,
        clock: Callable[[], float] = time.monotonic,
        on_shed: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.max_queue = int(max_queue)
        self.gather_window_s = float(gather_window_s)
        self._clock = clock
        self._on_shed = on_shed
        self._pending: Deque[Request] = deque()
        self._cond = threading.Condition()
        self._closed = False

    # ------------------------------------------------------------ submit side
    def submit(self, obs: Any, deadline_s: float) -> Request:
        """Admit ``obs`` or raise. Never blocks: admission control is a
        depth check under the lock, shedding is immediate and typed."""
        now = self._clock()
        with self._cond:
            if self._closed:
                raise ServerClosed("policy server is shut down")
            depth = len(self._pending)
            if depth < self.max_queue:
                req = Request(obs, now, now + float(deadline_s))
                self._pending.append(req)
                self._cond.notify()
                return req
        # shed path: the stats hook is user code — never run it under the lock
        self._shed("overloaded")
        raise Overloaded(depth, self.max_queue, self.gather_window_s)

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # ----------------------------------------------------------- replica side
    def next_batch(self, max_batch: int, wait_timeout_s: float) -> List[Request]:
        """Block up to ``wait_timeout_s`` for work; then coalesce up to
        ``max_batch`` requests within one gather window. Returns ``[]`` on
        timeout/closed so replica loops can heartbeat. Expired requests are
        completed exceptionally here and never reach the model."""
        batch: List[Request] = []
        expired: List[Request] = []
        with self._cond:
            deadline = self._clock() + wait_timeout_s
            while not self._pending and not self._closed:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            if self._closed and not self._pending:
                return []
            gather_until = self._clock() + self.gather_window_s
            while len(batch) < max_batch:
                while self._pending:
                    req = self._pending.popleft()
                    (expired if req.expired(self._clock()) else batch).append(req)
                    if len(batch) >= max_batch:
                        break
                if len(batch) >= max_batch or self._closed:
                    break
                remaining = gather_until - self._clock()
                if remaining <= 0 or not batch:
                    # window over — or everything popped so far was expired:
                    # don't hold dead air waiting to pad a batch of nothing
                    break
                self._cond.wait(remaining)
        now = self._clock()
        for req in expired:
            req.fail_expired(now)
            self._shed("expired")
        return batch

    def requeue(self, requests: List[Request]) -> None:
        """Put a failed batch's still-viable requests back at the FRONT of
        the queue (they have already waited longest). Requests past their
        deadline are completed exceptionally instead. Bypasses admission
        control: an in-flight request was already admitted once — re-queueing
        it must not be sheddable, or a replica crash would drop work."""
        now = self._clock()
        viable = [r for r in requests if not r.future.done()]
        dead = [r for r in viable if r.expired(now)]
        keep = [r for r in viable if not r.expired(now)]
        for r in dead:
            r.fail_expired(now)
            self._shed("expired")
        if not keep:
            return
        failed: List[Request] = []
        with self._cond:
            if self._closed:
                # completing a Future wakes its waiter — do that after release
                failed = keep
            else:
                for r in reversed(keep):
                    r.attempts += 1
                    self._pending.appendleft(r)
                self._cond.notify_all()
        for r in failed:
            if not r.future.done():
                r.future.set_exception(ServerClosed("policy server is shut down"))

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop admitting; fail everything still pending with ServerClosed."""
        with self._cond:
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        for req in pending:
            if not req.future.done():
                req.future.set_exception(ServerClosed("policy server is shut down"))

    @property
    def closed(self) -> bool:
        return self._closed

    def _shed(self, kind: str) -> None:
        if self._on_shed is not None:
            try:
                self._on_shed(kind)
            except Exception:
                pass
