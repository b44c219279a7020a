"""Restart budgets (port of ``RestartBudget``, ``sheeprl_tpu/rollout/
supervisor.py:37-87``).

The serving tier's replica slots charge one each. The rest of the JAX
``rollout/`` package (the env-worker pool, its supervisor and shared
memory) is queued under ROADMAP A10.
"""

from __future__ import annotations

import time
from typing import Optional


class RestartBudget:
    """Restart budget with a healthy-window refund.

    A plain ``max_restarts`` cap conflates two failure shapes: a worker that
    crash-loops (restarts do not help — mask it) and a long-lived worker that
    accumulates rare, uncorrelated faults over hours (restarts always help —
    but the cap eventually masks it exactly when graceful degradation matters
    most). The refund separates them: every ``refund_after_s`` seconds WITHOUT
    a fault hands one restart back, so only faults *clustered* inside a
    healthy window can exhaust the budget. ``refund_after_s=None`` disables
    the refund (the original fixed-cap behaviour).

    Not thread-safe by itself — callers serialize (the serve supervisor
    charges from its monitor thread).
    """

    def __init__(self, max_restarts: int, refund_after_s: Optional[float] = None, clock=time.monotonic) -> None:
        self.max_restarts = int(max_restarts)
        self.refund_after_s = float(refund_after_s) if refund_after_s else None
        self._clock = clock
        self.used = 0
        self._last_fault_t: Optional[float] = None

    def _refund(self) -> None:
        if self.refund_after_s is None or self.used <= 0 or self._last_fault_t is None:
            return
        windows = int((self._clock() - self._last_fault_t) / self.refund_after_s)
        if windows > 0:
            self.used = max(0, self.used - windows)
            # keep the remainder of the current window so two refunds cannot
            # ride one healthy stretch
            self._last_fault_t += windows * self.refund_after_s
            if self.used == 0:
                self._last_fault_t = None

    @property
    def exhausted(self) -> bool:
        """True once the budget cannot absorb another fault — the caller
        masks instead of restarting."""
        self._refund()
        return self.used >= self.max_restarts

    def charge(self) -> int:
        """Record one fault/restart; returns the post-refund charge count
        (1-based within the current fault cluster — feeds the backoff)."""
        self._refund()
        self.used += 1
        self._last_fault_t = self._clock()
        return self.used
