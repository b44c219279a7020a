"""Triggered ``torch.profiler`` capture of single train windows (port of
``sheeprl_tpu/obs/profile.py``).

``metric.profiler.enabled`` (``utils/profiler.py::maybe_profile``) traces
a whole run. :class:`TriggeredProfiler` traces individual train windows
(one window is one ``telemetry_advance`` interval, one loop update) with
the JAX package's two triggers:

- **explicit**: ``metric.telemetry.profile_windows=[k..m]`` captures the
  listed 1-based windows; consecutive indices share one trace;
- **slow window**: with ``metric.telemetry.slow_window_factor=k`` (> 0),
  once a ``Time/train_time`` span exceeds ``k`` times the trailing median
  (after ``slow_window_min_history`` windows), the next window is captured,
  once a run.

A trace is ``trace.json`` (Chrome/Perfetto JSON, CPU activities and, for a
run on the card, CUDA activities) under ``profile_triggered/window_<k>``
beside ``telemetry.jsonl``; every capture is listed in the run record's
``profile_captures``.

Kineto runs one profiler session a process, and a second session started
inside another corrupts the first, so :func:`start_session` refuses to
open one while another is open (the whole-run trace owns the session for
its run). A failed start is swallowed, as in the JAX package: the window
runs untraced. Unlike the JAX package it is counted
(``failed_starts``, with the last error) and reported in the run record.
``start_trace`` / ``stop_trace`` are injectable for tests.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

_TRAIN_SPAN = "Time/train_time"
_HISTORY_WINDOW = 64
TRACE_FILE = "trace.json"

_session_lock = threading.Lock()
_session: Optional[Dict[str, Any]] = None


def _activities(device: Any) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_session(trace_dir: str, device: Any = "cpu") -> None:
    """Open the process's ``torch.profiler`` session, to be written to
    ``<trace_dir>/trace.json`` by :func:`stop_session`; ``RuntimeError``
    while another session is open."""
    global _session
    with _session_lock:
        if _session is not None:
            raise RuntimeError(f"a torch.profiler session is already open (writing to {_session['dir']})")
        prof = torch.profiler.profile(activities=_activities(device))
        prof.start()
        _session = {"prof": prof, "dir": trace_dir}


def stop_session() -> Optional[str]:
    """Close the open session and write its trace; the trace's path."""
    global _session
    with _session_lock:
        session, _session = _session, None
    if session is None:
        return None
    session["prof"].stop()
    path = os.path.join(session["dir"], TRACE_FILE)
    session["prof"].export_chrome_trace(path)
    return path


class TriggeredProfiler:
    """Per-train-window trace capture with explicit and slow-window
    triggers, driven by :class:`~sheeprl_tpu_torch.obs.telemetry.RunTelemetry`:
    :meth:`on_window` at every ``advance``, :meth:`observe_span` for every
    ``Time/train_time`` span, :meth:`finish` at shutdown."""

    def __init__(
        self,
        trace_root: str,
        *,
        windows: Optional[Sequence[int]] = None,
        slow_factor: float = 0.0,
        slow_min_history: int = 8,
        device: Any = "cpu",
        start_trace: Optional[Callable[[str], None]] = None,
        stop_trace: Optional[Callable[[], None]] = None,
    ) -> None:
        self.trace_root = trace_root
        self.windows = {int(w) for w in (windows or [])}
        self.slow_factor = float(slow_factor or 0.0)
        self.slow_min_history = max(1, int(slow_min_history))
        self.captures: List[Dict[str, Any]] = []
        self.failed_starts = 0
        self.last_error: Optional[str] = None
        self._start_trace = start_trace or (lambda path: start_session(path, device))
        self._stop_trace = stop_trace or stop_session
        self._active: Optional[Dict[str, Any]] = None
        self._history: deque = deque(maxlen=_HISTORY_WINDOW)
        self._slow_fired = False
        self._slow_pending: Optional[int] = None
        self._window = 0

    def on_window(self, index: int) -> None:
        """Window ``index`` (1-based) starts now: stop a capture whose
        windows are over, start or extend one the triggers ask for."""
        self._window = int(index)
        want = index in self.windows or index == self._slow_pending
        if self._active is not None:
            if want:
                self._active["windows"].append(index)
                return
            self._stop()
        if want:
            self._start(index)

    def observe_span(self, name: str, dur: float) -> None:
        if name != _TRAIN_SPAN:
            return
        if self.slow_factor > 0.0 and not self._slow_fired and len(self._history) >= self.slow_min_history:
            median = statistics.median(self._history)
            if median > 0.0 and dur > self.slow_factor * median:
                # capture the next window: this one already ran untraced
                self._slow_fired = True
                self._slow_pending = self._window + 1
        self._history.append(float(dur))

    def finish(self) -> List[Dict[str, Any]]:
        if self._active is not None:
            self._stop()
        return list(self.captures)

    def _start(self, index: int) -> None:
        trigger = "slow_window" if index == self._slow_pending else "explicit"
        path = os.path.join(self.trace_root, f"window_{index:05d}")
        try:
            os.makedirs(path, exist_ok=True)
            self._start_trace(path)
        except Exception as err:  # the session is busy or the profiler is unavailable
            self.failed_starts += 1
            self.last_error = repr(err)
            return
        self._active = {"trigger": trigger, "windows": [index], "trace_dir": path, "t_start": time.time()}

    def _stop(self) -> None:
        try:
            self._stop_trace()
        except Exception as err:
            self.last_error = repr(err)
        assert self._active is not None
        self._active["t_end"] = time.time()
        self.captures.append(self._active)
        self._active = None
