"""The trace plane on the port (``sheeprl_tpu_torch/obs/trace.py``) held to
the JAX package's (``sheeprl_tpu/obs/trace.py``) on the CPU: the same
events through either package's sinks carry the same record kinds and
fields, and a fleet load run through the port's CLI with telemetry on is
read back by the repo's merger (``python -m tools.trace summary``, in its
own process, from the run record's ``telemetry_files``): every request one
complete causal chain with exactly one ``request_done``, hedged twins
included."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.obs.registry import read_run_records
from tests.test_torch_serve_fleet import commit_linear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["sheeprl_tpu", "sheeprl_tpu_torch"]
PUBLIC = (
    "new_trace_id",
    "clock_offset",
    "TraceRecorder",
    "current_role",
    "set_trace_role",
    "configure_trace",
    "get_trace",
    "shutdown_trace",
    "tracing_active",
    "trace_event",
    "active_trace_ids",
)


@pytest.fixture(autouse=True)
def _no_role_left_over(monkeypatch):
    """The trace role is process state: a serve CLI run earlier in this
    worker leaves it at ``serve``. Each test starts from none."""
    for name in PACKAGES:
        monkeypatch.setattr(importlib.import_module(f"{name}.obs.trace"), "_role", None)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(record):
    """A record's kind and field names, without the values that differ from
    run to run."""
    return (record["event"], record.get("kind"), tuple(sorted(record)))


def _standalone_records(name, path):
    trace = importlib.import_module(f"{name}.obs.trace")
    trace.configure_trace("serve", path, generation=0)
    try:
        assert trace.tracing_active() and trace.current_role() == "serve"
        tid = trace.new_trace_id()
        assert 0 < tid < 2**63
        trace.trace_event("request_admit", tid, rid=1, priority="interactive", idempotent=True, deadline_ms=400.0)
        trace.trace_event("request_done", tid, rid=1, replica=0, batch=1, queue_wait_ms=0.1, assembly_ms=0.01, compute_ms=0.2, hedged=False, rerouted=False)
        trace.trace_event("request_reroute", replica=1, reason="drill", moved=1, trace_ids=[tid])
        trace.trace_event("replica_killed", replica=1)
        trace.set_trace_role("fleet")
        assert trace.active_trace_ids() == [tid, tid]
        assert trace.get_trace() is not None
    finally:
        trace.shutdown_trace()
    assert trace.get_trace() is None
    return _read(path)


def test_the_port_exports_the_jax_public_functions():
    from sheeprl_tpu_torch import obs

    jax_trace = importlib.import_module("sheeprl_tpu.obs.trace")
    port_trace = importlib.import_module("sheeprl_tpu_torch.obs.trace")
    for name in PUBLIC:
        assert hasattr(jax_trace, name) and hasattr(port_trace, name), name
        assert getattr(obs, name) is getattr(port_trace, name), name


def test_standalone_records_match_the_jax_recorder(tmp_path):
    """The same events through each package's standalone recorder: the
    same handshake, the same kinds, the same fields, in the same order, and
    the role change re-handshakes."""
    jax = _standalone_records("sheeprl_tpu", str(tmp_path / "jax.jsonl"))
    port = _standalone_records("sheeprl_tpu_torch", str(tmp_path / "port.jsonl"))
    assert [_shape(r) for r in port] == [_shape(r) for r in jax]
    assert [r.get("role") for r in port] == [r.get("role") for r in jax] == ["serve"] * 5 + ["fleet"]
    assert port[0]["event"] == "trace_handshake" and port[0]["generation"] == 0
    assert abs(port[0]["clock_offset"] - (port[0]["t"] - port[0]["t_mono"])) < 1.0


def _telemetry_records(name, tmp_path):
    telemetry = importlib.import_module(f"{name}.obs.telemetry")
    trace = importlib.import_module(f"{name}.obs.trace")
    path = str(tmp_path / name / "telemetry.jsonl")
    cfg = {"metric": {"telemetry": {"enabled": True, "jsonl": path, "poll_interval": 0.0}}, "fabric": {"accelerator": "cpu"}}
    if name == "sheeprl_tpu_torch":
        telemetry.configure_telemetry(cfg, device="cpu")
    else:
        telemetry.configure_telemetry(cfg)
    try:
        trace.set_trace_role("serve")
        tid = trace.new_trace_id()
        trace.trace_event("request_admit", tid, rid=1, priority="batch", idempotent=True, deadline_ms=400.0)
        trace.trace_event("model_swap", ckpt_step=7, attempt=1)
        telemetry.telemetry_request_path(queue_wait_ms=1.0, assembly_ms=0.5, compute_ms=2.0, hedged=True, rerouted=False)
        summary = telemetry.get_telemetry().run_summary()
    finally:
        telemetry.shutdown_telemetry()
    records = [r for r in _read(path) if r["event"] in ("trace_handshake", "trace", "run_end")]
    return records, summary


def test_telemetry_sink_records_match_the_jax_telemetry(tmp_path):
    """Trace events riding each package's telemetry stream: the handshake
    at start and again on the role change, then the events, with the JAX
    fields; the request critical-path rollup in run_end and the run summary
    with the JAX keys, and the stream in ``telemetry_files``."""
    jax, jax_summary = _telemetry_records("sheeprl_tpu", tmp_path)
    port, port_summary = _telemetry_records("sheeprl_tpu_torch", tmp_path)
    trace_shape = lambda r: (r["event"], r.get("kind"), tuple(sorted(k for k in r if k not in ("step", "process_index"))))  # noqa: E731
    assert [trace_shape(r) for r in port if r["event"] != "run_end"] == [trace_shape(r) for r in jax if r["event"] != "run_end"]
    assert [r["role"] for r in port if r["event"] == "trace_handshake"] == ["proc", "serve"]
    (jax_end,), (port_end,) = ([r for r in rs if r["event"] == "run_end"] for rs in (jax, port))
    assert port_end["request_critical_path"] == jax_end["request_critical_path"]
    assert port_summary["request_critical_path"] == jax_summary["request_critical_path"]
    assert port_summary["request_critical_path"]["hedged"] == 1
    assert port_summary["telemetry_files"] == [str(tmp_path / "sheeprl_tpu_torch" / "telemetry.jsonl")]


def test_tracing_is_off_without_a_sink():
    from sheeprl_tpu_torch.obs import trace

    assert trace.get_trace() is None and not trace.tracing_active()
    trace.trace_event("request_admit", 5, rid=1)  # a no-op, not an error
    assert trace.current_role() == "proc"


def test_fleet_load_through_the_cli_merges_into_complete_chains(tmp_path, capsys, monkeypatch):
    """``serve ... serve.fleet.enabled=true serve.load.enabled=true`` with
    telemetry on, replica 0 slowed so requests wait past the hedge threshold
    and are hedged to replica 1: ``tools.trace summary --from-registry``
    over the run record's files reports one chain a request, each ending in
    exactly one ``request_done``, and the hedged twins counted once."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    cfg = {"algo": {"name": "linear"}, "seed": 1, "metric": {"telemetry": {"enabled": True, "poll_interval": 0.0}}}
    (run_dir / "config.yaml").write_text(json.dumps(cfg))
    commit_linear(str(run_dir / "checkpoint"), 100)
    runs = tmp_path / "RUNS.jsonl"
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(runs))
    cli.run(
        [
            "serve",
            f"ckpt_dir={run_dir / 'checkpoint'}",
            "fabric.accelerator=cpu",
            "serve.slo_ms=40",
            "serve.batch_ladder=[1,2,4]",
            "serve.fleet.enabled=true",
            "serve.fleet.num_replicas=2",
            "serve.fleet.max_replicas=2",
            "serve.fleet.hedge_scan_ms=2",
            "serve.fault_injection.enabled=true",
            "serve.fault_injection.faults=[{kind: slow_inference, replica: 0, at_batch: 0, duration_s: 0.08, for_batches: 8}]",
            "serve.load.enabled=true",
            "serve.load.duration_s=0.6",
            "serve.load.concurrency=4",
            "serve.load.timeout_ms=2000",
        ]
    )
    out = capsys.readouterr().out
    assert "fleet replicas=2" in out
    (record,) = read_run_records(str(runs))
    assert record["kind"] == "serve" and record["variant"] == "fleet" and record["outcome"] == "completed"
    stats = record["serve_stats"]
    assert stats["fleet"]["router"]["hedged"] >= 1
    assert record["telemetry_files"] == [str(run_dir / "telemetry.jsonl")]
    proc = subprocess.run(
        [sys.executable, "-m", "tools.trace", "summary", "--from-registry", str(runs)],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    requests = summary["requests"]
    assert requests["traces"] == stats["fleet"]["router"]["routed"] > 0
    assert requests["terminals"] == {"request_done": requests["traces"]}
    assert requests["hedged"] >= 1 and "hedge_winner_dupes" not in requests
    assert [p["role"] for p in summary["processes"]] == ["serve"]
    # each chain, merged in this process too: admitted first, done once
    from tools import trace as trace_tool

    merged = trace_tool.merge(record["telemetry_files"])
    for evs in merged["traces"].values():
        kinds = trace_tool.trace_kinds(evs)
        assert kinds[0] == "request_admit" and kinds.count("request_done") == 1, kinds
    assert record["request_critical_path"]["samples"] == requests["traces"]
    assert np.isfinite(record["request_critical_path"]["p95_ms"])
