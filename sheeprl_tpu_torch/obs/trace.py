"""Trace plane: causal ids for served requests (port of
``sheeprl_tpu/obs/trace.py``, the same records and field names, so the
repo's ``tools/trace.py`` merges the port's streams unchanged).

The telemetry stream (:mod:`sheeprl_tpu_torch.obs.telemetry`) is
per-process, and one request of the replica fleet crosses the router, the
hedge scan and several replica threads. This module adds the causal layer:

- **trace ids** — :func:`new_trace_id` mints a random 63-bit id (nonzero,
  fits an int64 word). A request's id survives hedging, re-route-at-front
  and requeue because it lives on the shared
  :class:`~sheeprl_tpu_torch.serve.batching.Request` object (the JAX
  package also stamps ids into its actor-learner slabs, whose plane is
  ROADMAP A10).
- **handshakes** — every trace sink opens with a ``trace_handshake`` record
  carrying ``role``, ``pid`` and ``clock_offset = time.time() -
  time.monotonic()`` measured at spawn. Monotonic clocks are per-process and
  arbitrary; the offset lets the merger (``tools/trace.py``) align every
  process's ``t_mono`` stamps onto one epoch timeline.
- **two sinks** — a process that owns a :class:`RunTelemetry` (the serve
  CLI) rides trace events on its existing ``telemetry.jsonl`` (buffered,
  rotated, registered in RUNS.jsonl). A process without one (a test tracing
  a threaded server, a child that may die via ``os._exit``) uses a
  *standalone* :class:`TraceRecorder` that flushes every event, so a crash
  still leaves every event it emitted on disk.

Event schema (one JSON object per line, merged by ``tools/trace.py``)::

    {"event": "trace_handshake", "role", "pid", "clock_offset", "t", "t_mono"}
    {"event": "trace", "kind", "trace_id", "role", "pid", "t", "t_mono", ...}

``trace_id == 0`` marks process-scoped events that belong to no one causal
chain (``replica_killed``, batched ``request_reroute`` carriers); the
merger files them on the emitting process's track.

Everything here is a cheap no-op when neither a standalone recorder nor an
active telemetry exists — the disabled hot path is two global reads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_MASK63 = (1 << 63) - 1
_ACTIVE_RING = 64  # recent trace ids kept for flight-recorder dumps


def new_trace_id() -> int:
    """Random nonzero 63-bit trace id (fits an int64 word)."""
    tid = 0
    while tid == 0:
        tid = int.from_bytes(os.urandom(8), "little") & _MASK63
    return tid


def clock_offset() -> float:
    """This process's monotonic→epoch alignment: ``epoch = t_mono + offset``."""
    return time.time() - time.monotonic()


class TraceRecorder:
    """Standalone trace sink: one flush-per-event JSONL file.

    For processes without a telemetry hub and for tests that trace threaded
    servers without configuring telemetry. The handshake is
    written at construction and every event is flushed immediately — a
    process that dies via ``os._exit`` (the crash drills) still leaves every
    event it emitted on disk.
    """

    def __init__(self, role: str, path: str, **handshake_fields: Any) -> None:
        self.role = str(role)
        self.pid = os.getpid()
        self.clock_offset = clock_offset()
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", buffering=1)
        self._active: deque = deque(maxlen=_ACTIVE_RING)
        self._write(self._handshake_record(**handshake_fields))

    def _handshake_record(self, **fields: Any) -> Dict[str, Any]:
        return {
            "event": "trace_handshake",
            "role": self.role,
            "pid": self.pid,
            "clock_offset": self.clock_offset,
            "t": time.time(),
            "t_mono": time.monotonic(),
            **fields,
        }

    def _write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def emit(self, kind: str, trace_id: int = 0, **fields: Any) -> None:
        tid = int(trace_id)
        if tid:
            self._active.append(tid)
        self._write(
            {
                "event": "trace",
                "kind": str(kind),
                "trace_id": tid,
                "role": self.role,
                "pid": self.pid,
                "t": time.time(),
                "t_mono": time.monotonic(),
                **fields,
            }
        )

    def rehandshake(self) -> None:
        """Re-emit the handshake (after a role change); the merger keeps the
        newest handshake per stream."""
        self._write(self._handshake_record())

    def active_trace_ids(self) -> List[int]:
        return list(self._active)

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except Exception:
                pass


# -- module state (per process) ----------------------------------------------

_recorder: Optional[TraceRecorder] = None
_role: Optional[str] = None
# telemetry-attached sink state: reset whenever the active RunTelemetry
# instance changes (a new run re-handshakes on its fresh stream)
_tel_ref: Any = None
_tel_active: deque = deque(maxlen=_ACTIVE_RING)


def _get_telemetry():
    from sheeprl_tpu_torch.obs.telemetry import get_telemetry

    return get_telemetry()


def current_role() -> str:
    """The role this process emits traces under (handshake + every event)."""
    if _recorder is not None:
        return _recorder.role
    return _role or "proc"


def set_trace_role(role: str) -> None:
    """Name this process's trace track (``learner``, ``serve``, ...). If a
    sink is already live, re-handshake so the merger picks up the role."""
    global _role
    _role = str(role)
    if _recorder is not None:
        _recorder.role = _role
        _recorder.rehandshake()
        return
    tel = _get_telemetry()
    if tel is not None:
        _emit_handshake_via(tel)


def configure_trace(role: str, path: str, **handshake_fields: Any) -> TraceRecorder:
    """Open a standalone trace recorder for this process (telemetry-less
    processes and tests). Replaces any previous recorder."""
    global _recorder, _role
    shutdown_trace()
    _role = str(role)
    _recorder = TraceRecorder(role, path, **handshake_fields)
    return _recorder


def get_trace() -> Optional[TraceRecorder]:
    return _recorder


def shutdown_trace() -> None:
    global _recorder
    rec, _recorder = _recorder, None
    if rec is not None:
        rec.close()


def tracing_active() -> bool:
    """True when trace events have somewhere to go — callers that must pay
    to *build* a context (mint an id) check this first; plain emission just
    calls :func:`trace_event`, which is a cheap no-op when off."""
    return _recorder is not None or _get_telemetry() is not None


def _emit_handshake_via(tel: Any) -> None:
    global _tel_ref
    if tel is not _tel_ref:
        _tel_active.clear()
    _tel_ref = tel
    tel.emit(
        "trace_handshake",
        role=current_role(),
        pid=os.getpid(),
        clock_offset=clock_offset(),
        t_mono=time.monotonic(),
    )


def trace_event(kind: str, trace_id: int = 0, **fields: Any) -> None:
    """Emit one trace event through whichever sink this process has: the
    standalone recorder if configured, else the active telemetry stream
    (handshaking it lazily), else nothing."""
    rec = _recorder
    if rec is not None:
        rec.emit(kind, trace_id, **fields)
        return
    tel = _get_telemetry()
    if tel is None:
        return
    if tel is not _tel_ref:
        _emit_handshake_via(tel)
    tid = int(trace_id)
    if tid:
        _tel_active.append(tid)
    tel.emit(
        "trace",
        kind=str(kind),
        trace_id=tid,
        role=current_role(),
        pid=os.getpid(),
        t_mono=time.monotonic(),
        **fields,
    )


def active_trace_ids() -> List[int]:
    """Recently-seen trace ids (newest last) — stamped into flight-recorder
    dumps so a crash artifact can be placed on the merged timeline."""
    if _recorder is not None:
        return _recorder.active_trace_ids()
    return list(_tel_active)
