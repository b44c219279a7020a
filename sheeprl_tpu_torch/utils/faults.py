"""Shared deterministic fault-injection engine (port of
``sheeprl_tpu/utils/faults.py``).

Faults are *scheduled by the owner of a monotone counter* (per-replica
batches, swap attempts) and *executed by the component the counter
addresses*, so a crashed and restarted executor can never lose the record
of which faults already fired. The port's one domain is the serving tier
(``serve/fault_injection.py``); the rollout pool and the actor-learner
domains of the JAX package are queued with their planes (ROADMAP A10).

- :func:`parse_fault_entries` — the config-list parser a domain runs its
  ``fault_injection.faults`` node through (mapping check, required keys,
  typed coercion) before constructing its domain dataclass.
- :class:`DeterministicSchedule` — the fire-once-with-catch-up pending set.
  A fault whose trigger the counter already passed (scheduled while its
  target was restarting) fires on the next query instead of being silently
  dropped; *windowed* faults (``slow_inference`` over ``for_batches``) stay
  due for their whole window and then expire. Thread-safe: replica threads
  and the swap watcher query concurrently.
- :func:`register_fault_domain` — the domain registry: every domain module
  declares its fault-kind vocabulary here at import (a conflicting
  re-registration raises).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

# (field name, coercion, default) — None default means the field is required
# when listed in ``required``; coercions run with ``or``-style zero fallback
# for floats so YAML ``null`` composes to 0.0.
FieldSpec = Tuple[str, Callable[[Any], Any], Any]

# domain name -> ordered fault-kind vocabulary, populated by the domain
# modules at import. A plain module dict: registration is import-time only.
_FAULT_DOMAINS: Dict[str, Tuple[str, ...]] = {}


def register_fault_domain(domain: str, kinds: Sequence[str]) -> None:
    """Declare ``domain``'s fault-kind vocabulary (idempotent; a re-import
    re-registering identical kinds is a no-op, a conflicting registration
    is a programming error surfaced immediately)."""
    entry = tuple(str(k) for k in kinds)
    existing = _FAULT_DOMAINS.get(domain)
    if existing is not None and existing != entry:
        raise ValueError(
            f"fault domain {domain!r} re-registered with different kinds: {existing} != {entry}"
        )
    _FAULT_DOMAINS[domain] = entry


def parse_fault_entries(
    node: Sequence[Mapping[str, Any]],
    *,
    domain: str,
    required: Sequence[str] = ("kind",),
    fields: Sequence[FieldSpec] = (),
) -> List[Dict[str, Any]]:
    """Normalize one ``fault_injection.faults`` config list.

    Returns one plain dict per entry: ``kind`` (always) plus every field in
    ``fields`` coerced to its declared type (entry value, else default).
    Raises ``ValueError`` with ``domain``-prefixed messages; kind membership
    and range checks stay with the domain dataclasses, which remain the
    validation authority.
    """
    out: List[Dict[str, Any]] = []
    for i, entry in enumerate(node):
        if not hasattr(entry, "get"):
            raise ValueError(f"{domain}.faults[{i}] must be a mapping, got {entry!r}")
        missing = [k for k in required if k not in entry]
        if missing:
            need = "/".join(required)
            raise ValueError(f"{domain}.faults[{i}] needs {need}, got {dict(entry)!r}")
        parsed: Dict[str, Any] = {"kind": entry["kind"]}
        for name, coerce, default in fields:
            raw = entry.get(name, default)
            if coerce is float:
                parsed[name] = float(raw or 0.0)
            else:
                parsed[name] = coerce(raw)
        out.append(parsed)
    return out


class DeterministicSchedule:
    """Fire-once (with catch-up) pending set over a monotone counter.

    ``at(item)`` reads an item's trigger value, ``index(item)`` its target
    index (``None`` = untargeted), ``window(item)`` its due-window length
    (1 = instant). All three are captured at construction so domain specs
    keep their own field names.
    """

    def __init__(
        self,
        items: Sequence[Any],
        *,
        at: Callable[[Any], int],
        index: Optional[Callable[[Any], Optional[int]]] = None,
        window: Optional[Callable[[Any], int]] = None,
    ) -> None:
        self._lock = threading.Lock()
        self._at = at
        self._index = index or (lambda item: None)
        self._window = window or (lambda item: 1)
        self._pending: List[Any] = sorted(items, key=at)

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def pop_due(self, counter: int, index: Optional[int] = None) -> List[Any]:
        """Items due at (or before — catch-up, nothing is silently dropped)
        ``counter``. With ``index`` given, only items targeting that index
        are considered; others stay pending for their own target's counter.
        Instant items are marked fired; windowed items stay scheduled until
        their window passes, then expire without firing again."""
        due: List[Any] = []
        with self._lock:
            remaining: List[Any] = []
            for item in self._pending:
                target = self._index(item)
                if index is not None and target is not None and target != index:
                    remaining.append(item)
                    continue
                at, win = self._at(item), self._window(item)
                if win > 1:
                    if at <= counter < at + win:
                        due.append(item)
                        remaining.append(item)  # stays due for its window
                    elif counter < at:
                        remaining.append(item)
                    # else: window over — expire silently
                elif at <= counter:
                    due.append(item)
                else:
                    remaining.append(item)
            self._pending = remaining
        return due

    def pop_first(self, counter: int) -> Optional[Any]:
        """Remove and return the earliest-scheduled item due at ``counter``
        (``None`` when nothing is due) — at most one fires per query, the
        swap-attempt semantics."""
        with self._lock:
            for item in self._pending:
                if self._at(item) <= counter:
                    self._pending.remove(item)
                    return item
        return None
