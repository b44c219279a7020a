"""``python -m sheeprl_tpu_torch serve`` (``cli_serve.serving``, through
``cli.run``) on the CPU, held against the JAX package's CLI tests
(tests/test_serve/test_cli.py, without the fleet and ``bench.py``): a
committed checkpoint served by its manifest, the ladder ready before
traffic, the scripted load run whose report has the JAX report's keys and
meets the SLO, its ``serve_stats`` telemetry and the ``kind: "serve"``
run record; the newest commit from ``ckpt_dir``; the torn-checkpoint
refusal; a source required; no CPU fallback; and a PPO checkpoint the port
wrote (a ``dry_run`` of ``exp=ppo``) served, its actions against the JAX
``build_ppo_policy`` on the same file."""

import json
import os

import numpy as np
import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.obs.registry import read_run_records
from sheeprl_tpu_torch.serve.errors import SwapRejected
from tests.test_torch_serve_drills import DRILL_SERVE, commit_linear


@pytest.fixture(autouse=True)
def _restore_metric_switches():
    """``cli.run`` of a training run sets the class-level ``span.disabled``
    and ``MetricAggregator.disabled`` from ``metric.log_level``: put them
    back, so the dry run below cannot silence later tests' timers."""
    from sheeprl_tpu_torch.obs.span import span
    from sheeprl_tpu_torch.utils.metric import MetricAggregator

    saved = span.disabled, MetricAggregator.disabled
    yield
    span.disabled, MetricAggregator.disabled = saved


def _serve_run(tmp_path, step=100):
    """A run directory the serve CLI can consume: config.yaml + a committed
    linear checkpoint under <run>/checkpoint/."""
    run_dir = tmp_path / "run"
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg = {"algo": {"name": "linear"}, "seed": 42, "metric": {"telemetry": {"enabled": True, "poll_interval": 0.0}}}
    (run_dir / "config.yaml").write_text(json.dumps(cfg))
    path, state = commit_linear(str(run_dir / "checkpoint"), step)
    return run_dir, path, state


def _parse_serve_stats(stdout):
    return json.loads(stdout[stdout.index('{\n  "serve_stats"') :])["serve_stats"]


def _jax_report_keys(tmp_path):
    """The keys of a JAX ``run_load`` report (a short load run on the JAX
    server over the same linear checkpoint)."""
    from sheeprl_tpu.serve.config import serve_config_from_cfg
    from sheeprl_tpu.serve.loadgen import run_load
    from sheeprl_tpu.serve.policy import build_linear_policy
    from sheeprl_tpu.serve.server import PolicyServer

    path, state = commit_linear(str(tmp_path / "jax"), 100)
    cfg = serve_config_from_cfg({"serve": {**DRILL_SERVE, "batch_ladder": [1], "load": {"duration_s": 0.1, "concurrency": 1}}})
    server = PolicyServer(build_linear_policy({"algo": {"name": "linear"}}, state), cfg, step=100, path=path)
    try:
        server.start()
        return set(run_load(server, cfg.load))
    finally:
        server.close()


def test_cli_load_run_meets_slo_with_the_jax_report(tmp_path, capsys, monkeypatch):
    run_dir, ckpt_path, _ = _serve_run(tmp_path)
    runs = tmp_path / "RUNS.jsonl"
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(runs))
    cli.run(
        [
            "serve",
            f"checkpoint_path={ckpt_path}",
            "fabric.accelerator=cpu",
            "serve.slo_ms=150",
            "serve.num_replicas=2",
            "serve.load.enabled=true",
            "serve.load.duration_s=0.5",
            "serve.load.concurrency=4",
        ]
    )
    out = capsys.readouterr().out
    assert "serving linear step=100" in out and "on cpu" in out
    snap = _parse_serve_stats(out)
    report = snap["load_report"]
    assert set(report) == _jax_report_keys(tmp_path)
    assert report["ok"] > 0 and report["qps"] > 0 and report["errors"] == 0
    assert report["p95_ms"] is not None and report["p95_ms"] <= 150.0
    assert report["slo_met"] is True
    assert snap["completed"] >= report["ok"]
    assert sorted(int(k) for k in snap["warmup_s"]) == [1, 2, 4, 8]  # every rung ready before traffic
    # the run's own telemetry stream: the final serve_stats and run_end's serve section
    stream = [json.loads(line) for line in (run_dir / "telemetry.jsonl").read_text().splitlines()]
    stats = [e for e in stream if e["event"] == "serve_stats"]
    assert stats[-1]["completed"] == snap["completed"] and stats[-1]["load_report"]["ok"] == report["ok"]
    assert stream[-1]["event"] == "run_end" and stream[-1]["serve"]["stats"]["completed"] == snap["completed"]
    (record,) = read_run_records(str(runs))
    assert (record["kind"], record["outcome"], record["algo"]) == ("serve", "completed", "linear")
    assert record["checkpoint"] == ckpt_path
    assert record["serve_stats"]["load_report"]["ok"] == report["ok"]
    assert record["serve"]["stats"]["completed"] == snap["completed"]


def test_cli_serves_newest_commit_from_ckpt_dir(tmp_path, capsys):
    run_dir, _, _ = _serve_run(tmp_path, step=100)
    commit_linear(str(run_dir / "checkpoint"), 250, seed=5)
    with open(run_dir / "checkpoint" / "ckpt_300_0.ckpt", "wb") as f:
        f.write(b"torn: no manifest")  # never a candidate
    cli.run(
        [
            "serve",
            f"ckpt_dir={run_dir / 'checkpoint'}",
            "fabric.accelerator=cpu",
            "serve.load.enabled=true",
            "serve.load.duration_s=0.2",
            "serve.load.concurrency=2",
        ]
    )
    out = capsys.readouterr().out
    assert "serving linear step=250" in out
    assert _parse_serve_stats(out)["serving_step"] == 250


def test_cli_refuses_torn_checkpoint(tmp_path):
    run_dir, _, _ = _serve_run(tmp_path)
    torn = str(run_dir / "checkpoint" / "ckpt_999_0.ckpt")
    with open(torn, "wb") as f:
        f.write(b"half a checkpoint")
    with pytest.raises(SwapRejected, match="manifest"):
        cli.run(["serve", f"checkpoint_path={torn}"])


def test_cli_requires_a_source():
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.run(["serve", "serve.slo_ms=50"])


def test_cli_serves_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without ``fabric.accelerator=cpu`` the server asks for the CUDA card,
    whatever the training run's placement (this run's config says cpu):
    without one it raises, no CPU fallback."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_dir, ckpt_path, _ = _serve_run(tmp_path)
    cfg = json.loads((run_dir / "config.yaml").read_text())
    (run_dir / "config.yaml").write_text(json.dumps({**cfg, "fabric": {"accelerator": "cpu"}}))
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.run(["serve", f"checkpoint_path={ckpt_path}", "serve.load.enabled=true"])


def test_cli_serves_a_checkpoint_the_port_wrote(tmp_path, capsys):
    """A ``dry_run`` of ``exp=ppo`` on the CPU writes a committed checkpoint;
    the CLI serves its run dir's newest commit, and the port's served
    forward equals the JAX ``build_ppo_policy`` on the same file."""
    from sheeprl_tpu.serve.model import CompiledLadder as JaxLadder
    from sheeprl_tpu.serve.policy import build_ppo_policy as jax_build_ppo_policy
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from sheeprl_tpu.utils.utils import dotdict as jdotdict
    from sheeprl_tpu_torch.config.compose import load_config_file
    from sheeprl_tpu_torch.serve.loadgen import random_obs
    from sheeprl_tpu_torch.serve.model import CompiledLadder
    from sheeprl_tpu_torch.serve.policy import build_served_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cli.run(
        [
            "exp=ppo",
            "fabric=cpu",
            "dry_run=True",
            "env.capture_video=False",
            "env.backend=sync",
            "env.num_envs=1",
            "algo.rollout_steps=8",
            "algo.per_rank_batch_size=8",
            "algo.update_epochs=1",
            "metric.log_level=0",
            "run_name=served",
            f"log_base_dir={tmp_path / 'logs'}",
        ]
    )
    ckpt_dir = tmp_path / "logs" / "ppo" / "CartPole-v1" / "served" / "version_0" / "checkpoint"
    capsys.readouterr()
    cli.run(["serve", f"ckpt_dir={ckpt_dir}", "fabric.accelerator=cpu", "serve.load.enabled=true", "serve.load.duration_s=0.2"])
    out = capsys.readouterr().out
    assert "serving ppo step=8" in out
    report = _parse_serve_stats(out)["load_report"]
    assert report["ok"] > 0 and report["errors"] == 0
    (ckpt,) = [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir) if f.endswith(".ckpt")]
    cfg = load_config_file(os.path.join(os.path.dirname(ckpt_dir), "config.yaml"))
    policy = build_served_policy(cfg, load_checkpoint(ckpt), device="cpu")
    jpolicy = jax_build_ppo_policy(jdotdict(cfg.to_dict()), jax_load_checkpoint(ckpt))
    make, rng = random_obs(policy.obs_spec), np.random.default_rng(0)
    obs = [make(rng) for _ in range(8)]
    forward = policy.bind(policy.params)
    got = CompiledLadder(policy, [8], forward).run(obs)
    want = JaxLadder(jpolicy, [8]).run(jpolicy.params, obs)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
