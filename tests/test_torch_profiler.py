"""The port's profilers (``obs/profile.py::TriggeredProfiler`` under
``metric.telemetry.profile_windows`` / ``slow_window_factor``, and
``utils/profiler.py::maybe_profile`` under ``metric.profiler``) against the
JAX package's.

- A CPU run of ``exp=ppo`` with ``metric.telemetry.profile_windows=[2]``
  writes ``profile_triggered/window_00002`` (a Chrome trace here, XLA's
  files there) and one ``profile_captures`` entry in the run record, as the
  JAX run does (before this slice the port dropped the key without a word).
- Fed the same windows and ``Time/train_time`` durations, with the trace
  calls stubbed, the port and the JAX package capture the same windows:
  the explicit ones, consecutive windows in one trace, and one slow-window
  capture after ``slow_window_min_history`` windows.
- A start that fails is swallowed in both; the port counts it and names
  the error in the run record. The whole-run trace owns the process's one
  profiler session, so a window inside it fails to start.

Nothing here goes through the JAX package's profiler-listener path
(``tests/test_utils/test_profiler.py::test_watchdog_stop_unregisters_cache_listener``
is one of the reference suite's known failures).
"""

import json
import os

import pytest

from sheeprl_tpu.obs.profile import TriggeredProfiler as JaxTriggeredProfiler
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.obs import profile as tprofile
from sheeprl_tpu_torch.obs.profile import TriggeredProfiler
from sheeprl_tpu_torch.obs.registry import read_run_records
from sheeprl_tpu_torch.obs.telemetry import RunTelemetry
from sheeprl_tpu_torch.utils.profiler import maybe_profile

# tests/test_obs/test_profile.py's run: a tiny CartPole PPO, window 2 traced
PPO_WINDOW_RUN = [
    "exp=ppo",
    "env.capture_video=False",
    "env.backend=sync",
    "buffer.memmap=False",
    "algo.total_steps=256",
    "algo.rollout_steps=32",
    "algo.per_rank_batch_size=8",
    "algo.update_epochs=1",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.encoder.cnn_features_dim=16",
    "algo.encoder.mlp_features_dim=8",
    "env.num_envs=2",
    "algo.run_test=False",
    "checkpoint.save_last=False",
    "metric.log_level=1",
    "metric.telemetry.enabled=True",
    "metric.telemetry.poll_interval=0.0",
    "metric.telemetry.profile_windows=[2]",
    "run_name=evidence",
]


class Tracer:
    """Stub trace calls: the paths started, the stops, an optional fault."""

    def __init__(self, fail_starts=()):
        self.started, self.stops, self.fail_starts = [], 0, set(fail_starts)

    def start(self, path):
        if len(self.started) in self.fail_starts:
            self.started.append(None)
            raise RuntimeError("profiler busy")
        self.started.append(os.path.basename(path))

    def stop(self):
        self.stops += 1


def _drive(cls, tmp, script, **kw):
    """Run ``script`` (("window", i) / ("span", name, dur)) through a
    profiler of ``cls`` with stubbed trace calls; its captures without the
    wall times and the trace root, and the tracer."""
    tracer = Tracer(kw.pop("fail_starts", ()))
    prof = cls(str(tmp), start_trace=tracer.start, stop_trace=tracer.stop, **kw)
    for ev in script:
        if ev[0] == "window":
            prof.on_window(ev[1])
        else:
            prof.observe_span(ev[1], ev[2])
    caps = prof.finish()
    return [{**{k: c[k] for k in ("trigger", "windows")}, "dir": os.path.basename(c["trace_dir"])} for c in caps], tracer, prof


def _script(durations, windows_from=1):
    out = []
    for i, dur in enumerate(durations, start=windows_from):
        out.append(("window", i))
        out.append(("span", "Time/env_interaction_time", 0.5))
        out.append(("span", "Time/train_time", dur))
    return out


@pytest.mark.parametrize(
    "windows, durations, slow, history",
    [
        ([2], [1.0] * 5, 0.0, 8),
        ([2, 3, 7], [1.0] * 9, 0.0, 8),  # 2 and 3 share one trace
        ([], [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 9.0, 1.0], 3.0, 4),  # one slow capture, the second spike ignored
        ([], [1.0, 9.0, 1.0, 1.0, 1.0], 3.0, 4),  # a spike before the history is full
        ([6], [1.0, 1.0, 1.0, 1.0, 5.0, 1.0, 1.0], 3.0, 4),  # the slow window is an explicit one too
        ([1, 9], [1.0] * 4, 0.0, 8),  # the first window; one past the run
    ],
)
def test_captures_match_the_jax_packages(tmp_path, windows, durations, slow, history):
    kw = dict(windows=windows, slow_factor=slow, slow_min_history=history)
    jcaps, jtracer, _ = _drive(JaxTriggeredProfiler, tmp_path / "jax", _script(durations), **kw)
    tcaps, ttracer, _ = _drive(TriggeredProfiler, tmp_path / "port", _script(durations), **kw)
    assert tcaps == jcaps
    assert (ttracer.started, ttracer.stops) == (jtracer.started, jtracer.stops)
    if slow:
        assert sum(c["trigger"] == "slow_window" for c in tcaps) <= 1


def test_a_failed_start_is_swallowed_and_counted(tmp_path):
    script = _script([1.0] * 4)
    jcaps, _, _ = _drive(JaxTriggeredProfiler, tmp_path / "jax", script, windows=[2, 4], fail_starts={0})
    tcaps, _, prof = _drive(TriggeredProfiler, tmp_path / "port", script, windows=[2, 4], fail_starts={0})
    assert tcaps == jcaps == [{"trigger": "explicit", "windows": [4], "dir": "window_00004"}]
    assert prof.failed_starts == 1 and "profiler busy" in prof.last_error


def test_the_whole_run_trace_owns_the_session(tmp_path):
    """A window inside ``maybe_profile`` fails to start and is counted;
    the whole-run trace is written; a window after it traces."""
    import torch

    cfg = {"metric": {"profiler": {"enabled": True, "trace_dir": str(tmp_path / "whole")}}}
    prof = TriggeredProfiler(str(tmp_path / "triggered"), windows=[1, 3])
    with maybe_profile(cfg) as trace_dir:
        assert tprofile._session is not None
        prof.on_window(1)
        torch.ones(4).sum()
        prof.on_window(2)
    assert tprofile._session is None
    assert trace_dir == str(tmp_path / "whole") and os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
    assert prof.failed_starts == 1 and "already open" in prof.last_error
    prof.on_window(3)
    torch.ones(4).sum()
    (capture,) = prof.finish()
    assert capture["windows"] == [3] and os.path.isfile(os.path.join(capture["trace_dir"], "trace.json"))


def test_maybe_profile_is_inert_when_disabled(tmp_path):
    with maybe_profile({"metric": {"profiler": {"enabled": False}}}, log_dir=str(tmp_path)) as trace_dir:
        assert trace_dir is None and tprofile._session is None
    with maybe_profile({}) as trace_dir:
        assert trace_dir is None
    assert os.listdir(tmp_path) == []


def test_telemetry_drives_the_profiler_and_reports_it(tmp_path):
    """``advance`` is the window boundary, ``Time/train_time`` spans feed
    the watchdog, ``close`` stops a straddling capture before ``run_end``
    lists the captures, and the failed starts reach the run's summary."""
    tracer = Tracer(fail_starts={1})
    prof = TriggeredProfiler(str(tmp_path / "t"), windows=[2, 4], start_trace=tracer.start, stop_trace=tracer.stop)
    tel = RunTelemetry(str(tmp_path / "telemetry.jsonl"), device="cpu", profiler=prof)
    for step in range(4):
        tel.advance(step * 2)
        tel.emit_span("Time/train_time", None, 0.1, {})
    summary = tel.run_summary()
    assert [c["windows"] for c in summary["profile_captures"]] == [[2]]
    assert summary["profile_failed_starts"] == 1 and "profiler busy" in summary["profile_last_error"]
    tel.close()
    events = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl")]
    (end,) = [e for e in events if e["event"] == "run_end"]
    assert [c["windows"] for c in end["profile_captures"]] == [[2]] and end["profile_failed_starts"] == 1


def test_profile_windows_trace_a_cli_run_as_the_jax_package(tmp_path, monkeypatch):
    """``metric.telemetry.profile_windows=[2]`` on a CPU run of ``exp=ppo``:
    the port's record and trace against the JAX package's run of the same
    command."""
    from sheeprl_tpu.cli import run as jax_run

    records = {}
    # the JAX package runs on the CPU here; the port is asked for it
    for name, run, device in (("jax", jax_run, []), ("port", cli.run, ["fabric=cpu"])):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        runs = work / "RUNS.jsonl"
        run(PPO_WINDOW_RUN + device + [f"metric.telemetry.runs_jsonl={runs}", f"log_base_dir={work}/logs"])
        (records[name],) = read_run_records(str(runs))
    jcap, tcap = (records[n]["profile_captures"] for n in ("jax", "port"))
    assert len(tcap) == len(jcap) == 1
    assert {k: tcap[0][k] for k in ("trigger", "windows")} == {k: jcap[0][k] for k in ("trigger", "windows")} == {
        "trigger": "explicit",
        "windows": [2],
    }
    rel = lambda cap, n: os.path.relpath(cap["trace_dir"], tmp_path / n)  # noqa: E731
    assert rel(tcap[0], "port") == rel(jcap[0], "jax")
    assert tcap[0]["trace_dir"].endswith(os.path.join("profile_triggered", "window_00002"))
    with open(os.path.join(tcap[0]["trace_dir"], "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "Time/train_time" in names  # the spans ride the trace as record_function ranges
    assert "profile_failed_starts" not in records["port"]
