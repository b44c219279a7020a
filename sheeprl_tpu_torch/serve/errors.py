"""Typed request-path failures of the policy-serving tier (port of
``sheeprl_tpu/serve/errors.py``).

Every way a request can fail is a distinct exception type so clients branch
on ``except`` clauses, not string matching — and so the load-shedding
contract is explicit: an overloaded server REJECTS (``Overloaded``, returned
immediately at admission) instead of queueing without bound and timing every
request out.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for policy-serving failures."""


class Overloaded(ServeError):
    """Admission control rejected the request: the queue is at its bound.

    ``retry_after_s`` is the server's backoff hint (one gather window — by
    then at least one batch has drained); :class:`~sheeprl_tpu_torch.serve.client.
    ServeClient` sleeps it (with jittered exponential growth) before retrying.
    """

    def __init__(self, depth: int, bound: int, retry_after_s: float) -> None:
        super().__init__(f"serving queue at bound ({depth}/{bound}); retry after {retry_after_s:.3f}s")
        self.depth = depth
        self.bound = bound
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline elapsed before an inference completed it."""

    def __init__(self, waited_s: float, deadline_s: float) -> None:
        super().__init__(f"request deadline exceeded ({waited_s:.3f}s waited, deadline {deadline_s:.3f}s)")
        self.waited_s = waited_s
        self.deadline_s = deadline_s


class ServerClosed(ServeError):
    """The server is shutting down (or never started); nothing was enqueued."""


class InferenceFailed(ServeError):
    """The policy forward itself raised and the request's remaining deadline
    could not absorb a retry on another replica."""


class SwapRejected(ServeError):
    """A checkpoint promotion was refused (torn write, digest mismatch,
    structural change, or poisoned weights). The previous version keeps
    serving — raised only by the *explicit* ``request_swap`` API; the
    background watcher just records the rejection."""
