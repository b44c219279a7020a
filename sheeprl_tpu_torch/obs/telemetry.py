"""Per-run telemetry sink: JSONL event stream, device poller, heartbeat
(port of ``sheeprl_tpu/obs/telemetry.py``: the parts the Dreamer-V3 main,
``resilience/``, ``utils/callback.py`` and the CLI reach).

One :class:`RunTelemetry` per run, created by :func:`configure_telemetry`
from ``cfg.metric.telemetry`` and torn down by :func:`shutdown_telemetry`
(both wired in ``cli.run_algorithm``). Events go to an append-only
``telemetry.jsonl`` in the run's base directory; every event carries
``event``, ``t`` (unix seconds), ``step`` (the policy step) and
``process_index``. The kinds written here: ``run_start``, ``span``,
``compile``, ``device_poll``, ``heartbeat``, ``ckpt_committed``,
``ckpt_skipped``, ``nan_rollback``, ``preempt``, ``crash_checkpoint``,
``resume_fallback`` and ``run_end``, with the JAX package's field names.

What differs from the TPU package:

- the device poll reads ``torch.cuda.memory_stats`` (allocated bytes now
  and at peak) and ``device_kind`` is ``torch.cuda.get_device_name()``;
- the compile counter counts CUDA-graph captures (``ops/graph.py``), the
  port's compile step; a capture after :meth:`RunTelemetry.mark_warm` is a
  recompile;
- MFU: the FLOPs of one gradient step are counted once, by
  ``torch.utils.flop_counter.FlopCounterMode`` over an eager step plus the
  fused RSSM kernel's own count (``obs/flops.py``), over the peak of the
  card's name and the run's precision in :data:`PEAK_FLOPS`. The counter
  counts products only (matrix products and convolutions), where XLA's cost
  analysis also counts elementwise work, so this MFU is not comparable with
  the TPU package's.

The accessor :func:`get_telemetry` returns ``None`` unless a run configured
telemetry: with telemetry off every hook is one global read.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from sheeprl_tpu_torch.ops import graph

_FLUSH_EVERY_EVENTS = 64
_FLUSH_EVERY_SECONDS = 5.0
_FLIGHTREC_EVENTS = 256

# dense peaks by card name and precision, FLOP/s (NVIDIA data sheet, H100
# SXM: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them)
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16-mixed": 989e12, "bf16-true": 989e12, "fp32": 67e12},
}

_active_telemetry: Optional["RunTelemetry"] = None


class TelemetryWriter:
    """Buffered, thread-safe JSONL appender.

    The checkpoint writer thread and the loop both emit; the lock keeps
    lines whole.  Events are buffered and flushed every
    ``_FLUSH_EVERY_EVENTS`` events or ``_FLUSH_EVERY_SECONDS`` seconds so the
    hot path never waits on the filesystem.

    ``max_bytes > 0`` enables size-capped rotation: when the current segment
    exceeds the cap it is renamed to ``<path>.1`` (overwriting any previous
    rotation) and a fresh segment starts, so a soak run's stream occupies at
    most ~2× the cap on disk."""

    def __init__(self, path: str, *, max_bytes: int = 0) -> None:
        self.path = path
        self.max_bytes = int(max_bytes or 0)
        self.rotations = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self._lock = threading.Lock()
        self._buf: list = []
        self._last_flush = time.time()

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            self._buf.append(line)
            if len(self._buf) >= _FLUSH_EVERY_EVENTS or time.time() - self._last_flush > _FLUSH_EVERY_SECONDS:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf:
            data = "\n".join(self._buf) + "\n"
            # rotate BEFORE a write that would cross the cap (not after): the
            # newest events — run_end, a crash's final flush — always land in
            # the CURRENT segment, never stranded at the tail of ``.1``
            if self.max_bytes > 0 and self._bytes > 0 and self._bytes + len(data) >= self.max_bytes:
                self._rotate_locked()
            self._fh.write(data)
            self._buf.clear()
            self._bytes += len(data)
        self._fh.flush()
        self._last_flush = time.time()

    def _rotate_locked(self) -> None:
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # someone removed the segment under us: just start fresh
        self._fh = open(self.path, "a", buffering=1)
        self._bytes = 0
        self.rotations += 1

    def segments(self) -> List[str]:
        """Existing stream segments, oldest first (``.1`` before current)."""
        return [p for p in (self.path + ".1", self.path) if os.path.exists(p)]

    def close(self) -> None:
        # under the lock: a racing write() could rotate and swap _fh between
        # a bare flush() and the close, leaking the fresh segment's handle
        with self._lock:
            self._flush_locked()
            self._fh.close()


class CaptureWatchdog:
    """Counts CUDA-graph captures (``ops/graph.py::capture_count``) since the
    run started, and those after :meth:`mark_warm` as recompiles; each new
    capture becomes one ``compile`` event when :meth:`poll` sees it."""

    def __init__(self, emit: Callable[..., None]) -> None:
        self._emit = emit
        self._start = graph.capture_count
        self._seen = graph.capture_count
        self._warm: Optional[int] = None
        self.deliberate_compiles: Dict[str, int] = {}

    @property
    def compiles(self) -> int:
        return graph.capture_count - self._start

    @property
    def recompiles(self) -> int:
        return 0 if self._warm is None else graph.capture_count - self._warm

    def mark_warm(self) -> None:
        if self._warm is None:
            self._warm = graph.capture_count

    def poll(self) -> None:
        now = graph.capture_count
        for _ in range(now - self._seen):
            self._emit("compile", kind="cuda_graph_capture", warm=self._warm is not None)
        self._seen = now


class RunTelemetry:
    """The per-run telemetry hub: the JSONL writer, the capture counter,
    the low-rate device poller and the heartbeat assembly. ``step`` is
    advanced by the train loop (:func:`telemetry_advance`)."""

    def __init__(
        self,
        jsonl_path: str,
        *,
        device: Any = "cuda",
        precision: str = "fp32",
        poll_interval: float = 30.0,
        max_bytes: int = 0,
        flightrec_events: int = _FLIGHTREC_EVENTS,
    ) -> None:
        self.device = torch.device(device)
        self.precision = precision
        self.process_index = 0
        self.step = 0
        self.poll_interval = float(poll_interval)
        self.writer = TelemetryWriter(jsonl_path, max_bytes=max_bytes)
        self.watchdog = CaptureWatchdog(self.emit)
        self._flightrec: Optional[deque] = deque(maxlen=int(flightrec_events)) if int(flightrec_events or 0) > 0 else None
        self.flightrec_path = os.path.join(os.path.dirname(jsonl_path) or ".", "flightrec.json")
        self._last_poll: Optional[float] = None
        self._hbm_peak_bytes = 0
        self._device_polls = 0
        self._flops_source: Optional[Callable[[], Optional[float]]] = None
        self._flops_per_train_step: Optional[float] = None
        self._flops_resolved = False
        # per-train-window dispatch accounting: "window_*" since the last
        # heartbeat, "total_*" over the run
        self._window_train_windows = 0
        self._window_train_dispatches = 0
        self._window_train_gradient_steps = 0
        self._total_train_windows = 0
        self._total_train_dispatches = 0
        self._total_train_gradient_steps = 0
        # resilience accounting: an event at each occurrence + run_end totals
        self._total_ckpt_commits = 0
        self._total_ckpt_skipped = 0
        self._total_nan_rollbacks = 0
        self._fused_fallbacks: Dict[str, int] = {}
        self._total_preemptions = 0
        self._total_crash_checkpoints = 0
        self._total_resume_fallbacks = 0
        # run-registry rollup: cumulative heartbeat-window sums and the
        # latest aggregator scalars
        self._cum_env_steps = 0.0
        self._cum_env_time = 0.0
        self._cum_train_steps = 0.0
        self._cum_train_time = 0.0
        self._last_mfu: Optional[float] = None
        self._last_train_flops_per_sec: Optional[float] = None
        self._final_metrics: Dict[str, float] = {}

    # -- core event plumbing -------------------------------------------------

    def emit(self, event: str, name: Optional[str] = None, **fields: Any) -> None:
        record: Dict[str, Any] = {"event": event, "t": time.time(), "step": self.step, "process_index": self.process_index}
        if name is not None:
            record["name"] = name
        record.update(fields)
        self.writer.write(record)
        if self._flightrec is not None:
            self._flightrec.append(record)

    def emit_span(self, name: str, t_start: Optional[float], dur: float, attrs: Mapping[str, Any]) -> None:
        fields: Dict[str, Any] = {"t_start": t_start, "dur": dur}
        if attrs:
            fields["attrs"] = dict(attrs)
        self.emit("span", name=name, **fields)

    def trace_annotation(self, name: Optional[str]):
        return None if name is None else torch.profiler.record_function(name)

    # -- loop hooks ----------------------------------------------------------

    def advance(self, step: int) -> None:
        self.step = int(step)
        self.watchdog.poll()
        self.maybe_poll_devices()

    def mark_warm(self) -> None:
        self.watchdog.mark_warm()

    def set_flops_source(self, source: Callable[[], Optional[float]]) -> None:
        if not self._flops_resolved:
            self._flops_source = source

    def record_train_window(self, dispatches: int, gradient_steps: int) -> None:
        """One train window: ``dispatches`` host launches of captured graphs
        (and target refreshes) ran ``gradient_steps`` gradient steps."""
        self._window_train_windows += 1
        self._window_train_dispatches += int(dispatches)
        self._window_train_gradient_steps += int(gradient_steps)
        self._total_train_windows += 1
        self._total_train_dispatches += int(dispatches)
        self._total_train_gradient_steps += int(gradient_steps)

    def record_ckpt_commit(self, path: str, step: int, backend: str, emergency: bool = False, **fields: Any) -> None:
        self._total_ckpt_commits += 1
        self.emit("ckpt_committed", path=path, ckpt_step=int(step), backend=backend, emergency=bool(emergency), **fields)
        self.writer.flush()

    def record_ckpt_skipped(self, path: str, step: int, **fields: Any) -> None:
        self._total_ckpt_skipped += 1
        self.emit("ckpt_skipped", path=path, ckpt_step=int(step), **fields)
        self.writer.flush()

    def record_fused_fallback(self, reason: str, detail: str = "", **fields: Any) -> None:
        """A fused path was asked for and the run took the host loop: one
        ``fused_fallback`` event and a run-end count by reason."""
        self._fused_fallbacks[reason] = self._fused_fallbacks.get(reason, 0) + 1
        self.emit("fused_fallback", reason=reason, detail=detail, **fields)
        self.writer.flush()

    def record_nan_rollback(self, path: Optional[str], reason: str, remaining: int, **fields: Any) -> None:
        self._total_nan_rollbacks += 1
        self.emit("nan_rollback", path=path, reason=reason, remaining=int(remaining), **fields)
        self.writer.flush()
        self.dump_flight_record("nan_rollback")

    def record_preemption(self, signum: int, **fields: Any) -> None:
        self._total_preemptions += 1
        self.emit("preempt", signum=int(signum), **fields)
        self.writer.flush()
        self.dump_flight_record("preempt")

    def record_crash_checkpoint(self, path: str, error: str, **fields: Any) -> None:
        self._total_crash_checkpoints += 1
        self.emit("crash_checkpoint", path=path, error=error, **fields)
        self.writer.flush()
        self.dump_flight_record("crash")

    def record_resume_fallback(self, path: str, error: str, **fields: Any) -> None:
        self._total_resume_fallbacks += 1
        self.emit("resume_fallback", path=path, error=error, **fields)
        self.writer.flush()

    def record_run_metrics(self, metrics: Mapping[str, Any]) -> None:
        """Keep the newest finite aggregator scalars: the last ones become
        the registry record's ``final_metrics``."""
        for key, value in dict(metrics).items():
            try:
                num = float(value)
            except (TypeError, ValueError):
                continue
            if num == num:
                self._final_metrics[str(key)] = num

    def dump_flight_record(self, trigger: str) -> Optional[str]:
        """Write the ring of the newest events to ``flightrec.json`` (atomic;
        oldest first, so the trigger event is last)."""
        ring = self._flightrec
        if ring is None:
            return None
        payload = {
            "schema": 1,
            "trigger": trigger,
            "t": time.time(),
            "step": self.step,
            "process_index": self.process_index,
            "pid": os.getpid(),
            "ring_capacity": ring.maxlen,
            "events": list(ring),
        }
        tmp = f"{self.flightrec_path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, self.flightrec_path)
        except OSError:
            return None
        return self.flightrec_path

    def _resolve_flops(self) -> Optional[float]:
        if not self._flops_resolved and self._flops_source is not None:
            # a source whose step has not run yet is asked again next time
            self._flops_per_train_step = self._flops_source()
            if self._flops_per_train_step is not None:
                self._flops_source = None
                self._flops_resolved = True
        return self._flops_per_train_step

    # -- device poller -------------------------------------------------------

    def maybe_poll_devices(self, force: bool = False) -> None:
        now = time.time()
        if not force and self._last_poll is not None and now - self._last_poll < self.poll_interval:
            return
        self._last_poll = now
        entry: Dict[str, Any] = {"id": self.device.index or 0, "kind": self.device_kind(), "platform": self.device.type}
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            entry["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
            entry["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
            self._hbm_peak_bytes = max(self._hbm_peak_bytes, entry["peak_bytes_in_use"])
        self._device_polls += 1
        self.emit("device_poll", devices=[entry])

    def device_kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"

    def peak_flops(self) -> Optional[float]:
        return PEAK_FLOPS.get(self.device_kind(), {}).get(self.precision)

    # -- heartbeat -----------------------------------------------------------

    def heartbeat(
        self,
        logger,
        *,
        step: int,
        env_steps: float,
        train_steps: float,
        train_invocations: Optional[float],
        timer_window: Mapping[str, float],
    ) -> None:
        """The per-log-interval summary: SPS, the train duty cycle, MFU,
        the device memory peak, captures; one ``heartbeat`` event and
        ``Telemetry/*`` scalars."""
        self.watchdog.poll()
        self.maybe_poll_devices(force=True)
        env_t = float(timer_window.get("Time/env_interaction_time") or 0.0)
        train_t = float(timer_window.get("Time/train_time") or 0.0)
        self._cum_env_steps += float(env_steps or 0.0)
        self._cum_env_time += env_t
        self._cum_train_steps += float(train_steps or 0.0)
        self._cum_train_time += train_t
        fields: Dict[str, Any] = {
            "window_env_steps": env_steps,
            "window_train_steps": train_steps,
            "window_env_time": env_t,
            "window_train_time": train_t,
            "device_kind": self.device_kind(),
            "hbm_peak_bytes": self._hbm_peak_bytes,
            "recompiles": self.watchdog.recompiles,
            "compiles_total": self.watchdog.compiles,
        }
        scalars: Dict[str, float] = {"Counters/recompiles": float(self.watchdog.recompiles)}
        if self._window_train_windows:
            fields["window_train_windows"] = self._window_train_windows
            fields["window_train_dispatches"] = self._window_train_dispatches
            fields["window_train_gradient_steps"] = self._window_train_gradient_steps
            scalars["Telemetry/train_dispatches_per_window"] = self._window_train_dispatches / self._window_train_windows
            self._window_train_windows = 0
            self._window_train_dispatches = 0
            self._window_train_gradient_steps = 0
        ckpt_snap_t = float(timer_window.get("ckpt/snapshot") or 0.0)
        if ckpt_snap_t > 0:
            fields["window_ckpt_snapshot_time"] = ckpt_snap_t
            scalars["Telemetry/ckpt_snapshot_time"] = ckpt_snap_t
        for total, name in (
            (self._total_ckpt_commits, "ckpt_commits"),
            (self._total_ckpt_skipped, "ckpt_skipped"),
            (self._total_nan_rollbacks, "nan_rollbacks"),
        ):
            if total:
                fields[f"{name}_total"] = total
                scalars[f"Counters/{name}"] = float(total)
        if env_t > 0:
            fields["sps_env"] = env_steps / env_t
        if train_t > 0:
            fields["sps_train"] = train_steps / train_t
        if env_t + train_t > 0:
            fields["duty_cycle_train"] = train_t / (env_t + train_t)
            scalars["Telemetry/duty_cycle_train"] = fields["duty_cycle_train"]
        if self._hbm_peak_bytes:
            scalars["Telemetry/hbm_peak_bytes"] = float(self._hbm_peak_bytes)
        flops = self._resolve_flops()
        if flops is not None:
            fields["flops_per_train_step"] = flops
            if train_invocations is not None:
                fields["window_train_invocations"] = train_invocations
                if train_t > 0 and train_invocations > 0:
                    fps = flops * train_invocations / train_t
                    fields["train_flops_per_sec"] = fps
                    scalars["Telemetry/train_flops_per_sec"] = fps
                    self._last_train_flops_per_sec = fps
                    peak = self.peak_flops()
                    if peak:
                        fields["mfu"] = fps / peak
                        scalars["Telemetry/mfu"] = fields["mfu"]
                        self._last_mfu = fields["mfu"]
        self.emit("heartbeat", **fields)
        self.writer.flush()
        if logger is not None:
            logger.log_metrics(scalars, step)

    # -- run-registry rollup -------------------------------------------------

    def run_summary(self) -> Dict[str, Any]:
        """The run condensed for the registry record, with the JAX
        package's keys (the counters of planes the port does not have yet,
        worker restarts and the executable cache, are 0)."""
        summary: Dict[str, Any] = {
            "backend": self.device.type,
            "device_kind": self.device_kind(),
            "local_device_count": 1,
            "process_count": 1,
            "hbm_peak_bytes": self._hbm_peak_bytes,
            "compiles_total": self.watchdog.compiles,
            "recompiles": self.watchdog.recompiles,
            "deliberate_compiles": dict(self.watchdog.deliberate_compiles),
            "train_windows": self._total_train_windows,
            "train_dispatches": self._total_train_dispatches,
            "train_gradient_steps": self._total_train_gradient_steps,
            "fused_fallbacks": dict(self._fused_fallbacks),
            "worker_restarts": 0,
            "masked_slots": 0,
            "ckpt_commits": self._total_ckpt_commits,
            "ckpt_skipped": self._total_ckpt_skipped,
            "nan_rollbacks": self._total_nan_rollbacks,
            "preemptions": self._total_preemptions,
            "crash_checkpoints": self._total_crash_checkpoints,
            "resume_fallbacks": self._total_resume_fallbacks,
            "aot_cache_hits": 0,
            "aot_cache_misses": 0,
            "aot_cache_stores": 0,
            "aot_cache_errors": 0,
        }
        if self._cum_env_time > 0:
            summary["sps_env"] = self._cum_env_steps / self._cum_env_time
        if self._cum_train_time > 0:
            summary["sps_train"] = self._cum_train_steps / self._cum_train_time
        if self._cum_env_time + self._cum_train_time > 0:
            summary["duty_cycle_train"] = self._cum_train_time / (self._cum_env_time + self._cum_train_time)
        loop_t = self._cum_env_time + self._cum_train_time
        if loop_t > 0 and self._cum_env_steps > 0:
            summary["sps_end_to_end"] = self._cum_env_steps / loop_t
        if self._flops_per_train_step is not None:
            summary["flops_per_train_step"] = self._flops_per_train_step
        if self._last_train_flops_per_sec is not None:
            summary["train_flops_per_sec"] = self._last_train_flops_per_sec
        if self._last_mfu is not None:
            summary["mfu"] = self._last_mfu
        if self._final_metrics:
            summary["final_metrics"] = dict(self._final_metrics)
        summary["telemetry_jsonl"] = self.writer.path
        summary["telemetry_segments"] = [os.path.basename(p) for p in self.writer.segments()]
        summary["telemetry_files"] = list(self.writer.segments())
        return summary

    # -- lifecycle -----------------------------------------------------------

    def start(self, run_info: Optional[Mapping[str, Any]] = None) -> None:
        self.emit("run_start", **dict(run_info or {}))
        self.maybe_poll_devices(force=True)

    def close(self) -> None:
        self.watchdog.poll()
        self.emit(
            "run_end",
            compiles_total=self.watchdog.compiles,
            recompiles=self.watchdog.recompiles,
            device_polls=self._device_polls,
            hbm_peak_bytes=self._hbm_peak_bytes,
            train_windows=self._total_train_windows,
            train_dispatches=self._total_train_dispatches,
            train_gradient_steps=self._total_train_gradient_steps,
            ckpt_commits=self._total_ckpt_commits,
            ckpt_skipped=self._total_ckpt_skipped,
            nan_rollbacks=self._total_nan_rollbacks,
            preemptions=self._total_preemptions,
            crash_checkpoints=self._total_crash_checkpoints,
            resume_fallbacks=self._total_resume_fallbacks,
            fused_fallbacks=dict(self._fused_fallbacks),
            deliberate_compiles=dict(self.watchdog.deliberate_compiles),
            telemetry_rotations=self.writer.rotations,
            telemetry_segments=[os.path.basename(p) for p in self.writer.segments()],
        )
        self.writer.close()


# -- module-level accessors (cheap no-ops when telemetry is off) -------------


def get_telemetry() -> Optional[RunTelemetry]:
    return _active_telemetry


def configure_telemetry(cfg: Mapping[str, Any], log_dir: Optional[str] = None, device: Any = None) -> Optional[RunTelemetry]:
    """Build the process-wide :class:`RunTelemetry` from
    ``cfg.metric.telemetry`` (``enabled``, ``jsonl``, ``poll_interval``,
    ``max_bytes``, ``flightrec_events``) for the run on ``device`` (by
    default the one ``fabric.accelerator`` names); ``None``, and the
    subsystem inert, unless enabled."""
    global _active_telemetry
    tel_cfg = ((cfg.get("metric") or {}).get("telemetry")) or {}
    if not bool(tel_cfg.get("enabled", False)):
        return None
    if _active_telemetry is not None:
        shutdown_telemetry()
    from sheeprl_tpu_torch.device import Precision
    from sheeprl_tpu_torch.parallel.fabric import accelerator_device

    fabric_cfg = cfg.get("fabric") or {}
    device = torch.device(device) if device is not None else accelerator_device(fabric_cfg.get("accelerator", "auto"))
    path = tel_cfg.get("jsonl") or os.path.join(log_dir or ".", "telemetry.jsonl")
    tel = RunTelemetry(
        path,
        device=device,
        precision=Precision(fabric_cfg.get("precision", "fp32")).name,
        poll_interval=float(tel_cfg.get("poll_interval", 30.0) or 0.0),
        max_bytes=int(tel_cfg.get("max_bytes", 0) or 0),
        flightrec_events=int(tel_cfg.get("flightrec_events", _FLIGHTREC_EVENTS) or 0),
    )
    tel.start(run_info={"backend": device.type, "local_device_count": 1, "process_count": 1})
    _active_telemetry = tel
    return tel


def shutdown_telemetry() -> None:
    global _active_telemetry
    tel = _active_telemetry
    _active_telemetry = None
    if tel is not None:
        tel.close()


def telemetry_advance(step: int) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.advance(step)


def telemetry_mark_warm() -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.mark_warm()


def telemetry_run_metrics(metrics: Mapping[str, Any]) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_run_metrics(metrics)


def telemetry_dump_flight_record(trigger: str) -> Optional[str]:
    tel = _active_telemetry
    return tel.dump_flight_record(trigger) if tel is not None else None


def telemetry_train_window(dispatches: int, gradient_steps: int) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_train_window(dispatches, gradient_steps)


def telemetry_ckpt_commit(path: str, step: int, backend: str, emergency: bool = False, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_ckpt_commit(path, step, backend, emergency, **fields)


def telemetry_ckpt_skipped(path: str, step: int, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_ckpt_skipped(path, step, **fields)


def telemetry_nan_rollback(path: Optional[str], reason: str, remaining: int, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_nan_rollback(path, reason, remaining, **fields)


def telemetry_preemption(signum: int, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_preemption(signum, **fields)


def telemetry_fused_fallback(reason: str, detail: str = "", **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_fused_fallback(reason, detail, **fields)


def telemetry_crash_checkpoint(path: str, error: str, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_crash_checkpoint(path, error, **fields)


def telemetry_resume_fallback(path: str, error: str, **fields: Any) -> None:
    tel = _active_telemetry
    if tel is not None:
        tel.record_resume_fallback(path, error, **fields)


def telemetry_register_flops(source: Callable[[], Optional[float]], scale: float = 1.0) -> None:
    """Register the FLOP source of MFU: ``source()`` gives the FLOPs of the
    program the loop launches (read once, at the first heartbeat that
    needs it); ``scale`` turns them into FLOPs a gradient step (a superstep
    of K steps registers ``1/K``)."""
    tel = _active_telemetry
    if tel is None:
        return

    def scaled() -> Optional[float]:
        flops = source()
        return None if flops is None else flops * float(scale)

    tel.set_flops_source(scaled)
