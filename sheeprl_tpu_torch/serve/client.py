"""Retry-aware client wrapper over :class:`PolicyServer` (port of
``sheeprl_tpu/serve/client.py``).

The server's failure contract is typed, so the client's policy is a small
decision table instead of string matching:

- :class:`Overloaded` — *retryable*: the server shed the request at
  admission, nothing was enqueued. Sleep the server's ``retry_after_s`` hint
  scaled by jittered exponential growth, then retry, up to ``max_retries``
  and never past the caller's own deadline.
- :class:`DeadlineExceeded` — *not retryable here*: the latency budget is
  already spent; surfacing it beats returning a stale action late.
- :class:`ServerClosed` — *not retryable*: shutdown is not a transient.

The jitter is deterministic per-client (seeded ``random.Random``) so load
drills are reproducible.
"""

from __future__ import annotations

import random
import time
from typing import Any, Optional

from sheeprl_tpu_torch.serve.errors import Overloaded
from sheeprl_tpu_torch.serve.server import PolicyServer


class ServeClient:
    """One logical caller. Counts its retries so drills can assert that
    shedding produced *backoff* (client-side), not just rejections.
    ``priority`` (``"interactive"`` or ``"batch"``) rides every request to a
    fleet's router, which spills ``batch`` traffic to its CPU replicas; left
    ``None`` the call is the plain facade's, which either tier serves. (The
    JAX client's ``experience_sink``, the online-learning tap, belongs to
    the online plane, ROADMAP A10.)"""

    def __init__(
        self,
        server: PolicyServer,
        *,
        max_retries: int = 3,
        timeout_s: Optional[float] = None,
        backoff_multiplier: float = 2.0,
        seed: int = 0,
        priority: Optional[str] = None,
    ) -> None:
        self.server = server
        self.priority = priority
        self.max_retries = int(max_retries)
        self.timeout_s = timeout_s
        self.backoff_multiplier = float(backoff_multiplier)
        self._rng = random.Random(seed)
        self.retries = 0
        self.rejected = 0

    def infer(self, obs: Any, timeout_s: Optional[float] = None) -> Any:
        """One request with admission-retry. Raises the final Overloaded when
        the budget (retries or time) is exhausted."""
        timeout_s = timeout_s if timeout_s is not None else self.timeout_s
        deadline = (time.monotonic() + timeout_s) if timeout_s is not None else None
        attempt = 0
        while True:
            try:
                deadline_s = (
                    max(1e-3, deadline - time.monotonic()) if deadline is not None else None
                )
                if self.priority is None:
                    return self.server.infer(obs, deadline_s=deadline_s)
                return self.server.infer(obs, deadline_s=deadline_s, priority=self.priority)
            except Overloaded as err:
                self.rejected += 1
                attempt += 1
                if attempt > self.max_retries:
                    raise
                pause = err.retry_after_s * (self.backoff_multiplier ** (attempt - 1))
                pause *= 0.5 + self._rng.random()  # jitter in [0.5x, 1.5x)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= pause:
                        raise  # can't absorb the backoff inside the deadline
                self.retries += 1
                time.sleep(pause)
