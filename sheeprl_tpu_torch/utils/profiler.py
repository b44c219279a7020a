"""The whole-run ``torch.profiler`` trace (port of
``sheeprl_tpu/utils/profiler.py::maybe_profile``).

``metric.profiler.enabled=True [metric.profiler.trace_dir=...]`` wraps the
training entry point in one profiler session (CPU activities, and CUDA
activities for a run on the card); the trace is Chrome/Perfetto JSON,
``<trace_dir>/trace.json``, by default ``<run root>/profile`` beside the
run's ``version_N`` directories. The session is the process's only one
(``obs/profile.py``): a triggered window inside it fails to start and is
counted in the run record.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Iterator, Mapping, Optional

from sheeprl_tpu_torch.obs.profile import start_session, stop_session


@contextmanager
def maybe_profile(cfg: Mapping[str, Any], log_dir: Optional[str] = None, device: Any = "cpu") -> Iterator[Optional[str]]:
    """Trace the block when ``metric.profiler.enabled`` is set (yields the
    trace directory); a no-op yielding ``None`` otherwise."""
    prof_cfg = (cfg.get("metric") or {}).get("profiler") or {}
    if not bool(prof_cfg.get("enabled", False)):
        yield None
        return
    trace_dir = prof_cfg.get("trace_dir") or os.path.join(log_dir or ".", "profile")
    os.makedirs(trace_dir, exist_ok=True)
    start_session(trace_dir, device)
    try:
        yield trace_dir
    finally:
        stop_session()
