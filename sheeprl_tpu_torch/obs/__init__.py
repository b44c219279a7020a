"""Run telemetry (port of ``sheeprl_tpu/obs``: the parts the Dreamer-V3 main,
``resilience/``, ``utils/callback.py`` and the CLI reach).

- :class:`~sheeprl_tpu_torch.obs.span.span`: one section name in the
  wall-clock timer registry, the ``torch.profiler`` trace and the
  ``telemetry.jsonl`` stream;
- :class:`~sheeprl_tpu_torch.obs.telemetry.RunTelemetry`: the per-run sink,
  with the CUDA-graph capture counter, the device memory poll and the
  heartbeat (SPS, duty cycle, MFU);
- :mod:`~sheeprl_tpu_torch.obs.registry`: the one-line run record in
  ``RUNS.jsonl``;
- :mod:`~sheeprl_tpu_torch.obs.trace`: the trace plane, causal ids for
  the replica fleet's requests, riding the telemetry stream or a
  standalone recorder, merged by the repo's ``tools/trace.py``.

Everything is inert unless ``metric.telemetry.enabled=True`` (or a
standalone trace recorder is configured). :mod:`~sheeprl_tpu_torch.obs.profile`
is the triggered profiler (``torch.profiler`` traces of chosen or slow
train windows). The actor-learner, rollout and net records are not ported
(ROADMAP.md).
"""

from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat
from sheeprl_tpu_torch.obs.registry import append_run_record, build_run_record, read_run_records, register_run
from sheeprl_tpu_torch.obs.span import TimerError, span
from sheeprl_tpu_torch.obs.telemetry import (
    RunTelemetry,
    configure_telemetry,
    get_telemetry,
    shutdown_telemetry,
    telemetry_advance,
    telemetry_child_file,
    telemetry_ckpt_commit,
    telemetry_ckpt_skipped,
    telemetry_crash_checkpoint,
    telemetry_dump_flight_record,
    telemetry_mark_warm,
    telemetry_nan_rollback,
    telemetry_preemption,
    telemetry_register_flops,
    telemetry_request_path,
    telemetry_resume_fallback,
    telemetry_run_metrics,
    telemetry_serve_event,
    telemetry_serve_stats,
    telemetry_train_window,
)
from sheeprl_tpu_torch.obs.trace import (
    TraceRecorder,
    active_trace_ids,
    clock_offset,
    configure_trace,
    current_role,
    get_trace,
    new_trace_id,
    set_trace_role,
    shutdown_trace,
    trace_event,
    tracing_active,
)

__all__ = [
    "RunTelemetry",
    "TimerError",
    "TraceRecorder",
    "active_trace_ids",
    "append_run_record",
    "build_run_record",
    "clock_offset",
    "configure_telemetry",
    "configure_trace",
    "current_role",
    "get_telemetry",
    "get_trace",
    "log_sps_and_heartbeat",
    "new_trace_id",
    "read_run_records",
    "register_run",
    "set_trace_role",
    "shutdown_telemetry",
    "shutdown_trace",
    "span",
    "telemetry_advance",
    "telemetry_child_file",
    "telemetry_ckpt_commit",
    "telemetry_ckpt_skipped",
    "telemetry_crash_checkpoint",
    "telemetry_dump_flight_record",
    "telemetry_mark_warm",
    "telemetry_nan_rollback",
    "telemetry_preemption",
    "telemetry_register_flops",
    "telemetry_request_path",
    "telemetry_resume_fallback",
    "telemetry_run_metrics",
    "telemetry_serve_event",
    "telemetry_serve_stats",
    "telemetry_train_window",
    "trace_event",
    "tracing_active",
]
