"""Span events: one section name, three sinks (port of
``sheeprl_tpu/obs/span.py``).

``span`` is the timer (``utils/timer.py`` re-exports it as ``timer``): a
context-decorator that sums wall-clock seconds per name in the class-level
``timers`` registry, silenced by the class-level ``disabled`` flag. When run
telemetry is configured it also

- wraps the block in ``torch.profiler.record_function(name)``, so the
  section shows up by the same name in a ``torch.profiler`` trace, and
- emits one ``span`` event per close to ``telemetry.jsonl`` (name,
  t_start, dur, step, process_index, attrs).

CUDA work is asynchronous: a span around device work measures the host's
enqueue unless the block waits for the device before it closes (the train
window does, through its dispatch fence).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.utils.metric import Metric, SumMetric, make_metric


class TimerError(Exception):
    pass


class span(ContextDecorator):
    """Context-decorator that accumulates wall-clock seconds per ``name`` in a
    class-level :class:`Metric` registry and mirrors the section into the
    profiler trace and the telemetry JSONL stream when telemetry is active.

    ``disabled`` only silences the metric registry (the old ``timer.disabled``
    contract, driven by ``metric.log_level`` / ``metric.disable_timer``);
    telemetry emission is governed independently by
    ``metric.telemetry.enabled`` so a low log level still yields JSONL spans.
    """

    disabled: bool = False
    timers: Dict[str, Metric] = {}

    def __init__(self, name: str, metric: Optional[object] = None, **attrs: Any) -> None:
        self.name = name
        self.attrs = attrs
        self._start_time: Optional[float] = None
        self._wall_start: Optional[float] = None
        self._annotation = None
        if not span.disabled and name is not None and name not in span.timers:
            span.timers[name] = make_metric(metric) if metric is not None else SumMetric()

    def start(self) -> None:
        if self._start_time is not None:
            raise TimerError("timer is running. Use .stop() to stop it")
        self._start_time = time.perf_counter()

    def stop(self) -> float:
        if self._start_time is None:
            raise TimerError("timer is not running. Use .start() to start it")
        elapsed = time.perf_counter() - self._start_time
        self._start_time = None
        if self.name and not span.disabled and self.name in span.timers:
            span.timers[self.name].update(elapsed)
        return elapsed

    @classmethod
    def reset(cls) -> None:
        for m in cls.timers.values():
            m.reset()

    @classmethod
    def compute(cls) -> Dict[str, float]:
        return {k: v.compute() for k, v in cls.timers.items()}

    def __enter__(self) -> "span":
        from sheeprl_tpu_torch.obs.telemetry import get_telemetry

        tel = get_telemetry()
        if tel is not None:
            self._wall_start = time.time()
            self._annotation = tel.trace_annotation(self.name)
            if self._annotation is not None:
                self._annotation.__enter__()
        if not span.disabled or tel is not None:
            # When only telemetry wants the span, still run the clock; stop()
            # skips the registry for names registered while disabled.
            if self.name is not None and not span.disabled and self.name not in span.timers:
                span.timers[self.name] = SumMetric()
            self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        from sheeprl_tpu_torch.obs.telemetry import get_telemetry

        tel = get_telemetry()
        elapsed: Optional[float] = None
        if self._start_time is not None:
            elapsed = self.stop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc_info)
            self._annotation = None
        if tel is not None and elapsed is not None:
            tel.emit_span(self.name, self._wall_start, elapsed, self.attrs)
        self._wall_start = None
