"""Deterministic fault injection for the serving tier (port of
``sheeprl_tpu/serve/fault_injection.py``, over the shared engine
:mod:`sheeprl_tpu_torch.utils.faults`).

The recovery paths are exercised by scheduled drills, not discovered in
production. Faults are owned by the *schedule* (server-side state), not by
the replica that executes them, so a crashed-and-restarted replica cannot
lose the record of which faults already fired.

Config shape (``serve.fault_injection`` in the composed config)::

    serve:
      fault_injection:
        enabled: true
        faults:
          - {kind: replica_crash,  replica: 0, at_batch: 5}
          - {kind: slow_inference, replica: 0, at_batch: 2, duration_s: 0.2, for_batches: 20}
          - {kind: poison_swap, at_swap: 1}
          - {kind: router_blackhole, at_request: 10, duration_s: 0.2}

``kind``:

- ``replica_crash`` — replica ``replica`` raises before processing its
  ``at_batch``-th batch (the batch is re-queued first, so no request is
  dropped); the supervisor sees the dead thread and restarts it under the
  restart budget.
- ``slow_inference`` — replica ``replica`` sleeps ``duration_s`` before each
  of ``for_batches`` consecutive batches starting at ``at_batch``; drives the
  queue toward its bound so admission control sheds.
- ``poison_swap`` — the ``at_swap``-th swap *attempt* (1-based) has its
  freshly loaded weights NaN-poisoned after the load, so the promotion
  validation must reject it and keep serving the previous version.
- ``router_blackhole`` — the fleet front door
  (:mod:`sheeprl_tpu_torch.serve.router`) swallows assignments for
  ``duration_s`` starting at its ``at_request``-th routed request: the
  chosen replica never receives the work, so the hedge/deadline machinery
  must rescue every admitted request. Ignored by the single-server tier
  (there is no router to blackhole).

``at_batch`` counts batches *processed by that replica* (a monotone
per-replica counter that survives restarts); ``at_request`` counts requests
*routed by the fleet router*. Each fault fires exactly once
(``slow_inference`` covers its window, then expires).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Sequence

from sheeprl_tpu_torch.utils.faults import DeterministicSchedule, parse_fault_entries, register_fault_domain

_KINDS = ("replica_crash", "slow_inference", "poison_swap", "router_blackhole")
register_fault_domain("serve", _KINDS)


@dataclass
class ServeFaultSpec:
    kind: str
    replica: int = 0
    at_batch: int = 0
    at_swap: int = 1
    at_request: int = 0
    duration_s: float = 0.0
    for_batches: int = 1

    def __post_init__(self) -> None:
        self.kind = str(self.kind).lower()
        if self.kind not in _KINDS:
            raise ValueError(f"unknown serve fault kind {self.kind!r}; expected one of {_KINDS}")
        self.replica = int(self.replica)
        self.at_batch = int(self.at_batch)
        self.at_swap = int(self.at_swap)
        self.at_request = int(self.at_request)
        self.duration_s = float(self.duration_s)
        self.for_batches = int(self.for_batches)
        if self.replica < 0:
            raise ValueError(f"serve fault replica index must be >= 0, got {self.replica}")
        if self.at_batch < 0:
            raise ValueError(f"serve fault at_batch must be >= 0, got {self.at_batch}")
        if self.at_request < 0:
            raise ValueError(f"serve fault at_request must be >= 0, got {self.at_request}")
        if self.kind == "poison_swap" and self.at_swap < 1:
            raise ValueError(f"serve fault at_swap is 1-based, got {self.at_swap}")
        if self.for_batches < 1:
            raise ValueError(f"serve fault for_batches must be >= 1, got {self.for_batches}")


def parse_serve_faults(node: Sequence[Mapping[str, Any]]) -> List[ServeFaultSpec]:
    entries = parse_fault_entries(
        node,
        domain="serve.fault_injection",
        required=("kind",),
        fields=(
            ("replica", int, 0),
            ("at_batch", int, 0),
            ("at_swap", int, 1),
            ("at_request", int, 0),
            ("duration_s", float, 0.0),
            ("for_batches", int, 1),
        ),
    )
    return [ServeFaultSpec(**e) for e in entries]


class ServeFaultSchedule:
    """Thread-safe: replicas, the router and the swap watcher query
    concurrently (each counter family gets its own pending set)."""

    def __init__(self, faults: Sequence[ServeFaultSpec]) -> None:
        self._batches = DeterministicSchedule(
            [f for f in faults if f.kind in ("replica_crash", "slow_inference")],
            at=lambda f: f.at_batch,
            index=lambda f: f.replica,
            window=lambda f: f.for_batches if f.kind == "slow_inference" else 1,
        )
        self._swaps = DeterministicSchedule([f for f in faults if f.kind == "poison_swap"], at=lambda f: f.at_swap)
        self._router = DeterministicSchedule([f for f in faults if f.kind == "router_blackhole"], at=lambda f: f.at_request)

    def __bool__(self) -> bool:
        return bool(self._batches) or bool(self._swaps) or bool(self._router)

    def batch_faults(self, replica: int, batch_index: int) -> List[ServeFaultSpec]:
        """Faults due for ``replica``'s ``batch_index``-th batch. A
        ``replica_crash`` whose step the replica already passed (scheduled
        while it was restarting) fires on the next batch: nothing is
        silently dropped."""
        return self._batches.pop_due(batch_index, index=replica)

    def poison_swap(self, attempt: int) -> bool:
        """True when the ``attempt``-th swap attempt (1-based) must have its
        loaded weights poisoned before validation."""
        return self._swaps.pop_first(attempt) is not None

    def router_faults(self, request_index: int) -> List[ServeFaultSpec]:
        """``router_blackhole`` faults due at the router's ``request_index``-th
        routed request, marked fired (the router holds each blackhole open
        for its ``duration_s``)."""
        return self._router.pop_due(request_index)
