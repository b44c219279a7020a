"""The port's logger, telemetry and run registry against the JAX package's:
TensorBoard event files read back by tensorboard's ``EventAccumulator``, a
scripted heartbeat window, ``run_summary`` and ``build_run_record`` keys,
the registry's path rules, the span and timer, and the FLOP count of one
gradient step (the counter's products against an analytic count, the fused
RSSM kernel's own count included)."""

import contextlib
import json
import math
import os
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from sheeprl_tpu.obs import registry as jax_registry
from sheeprl_tpu.obs.telemetry import RunTelemetry as JaxRunTelemetry
from sheeprl_tpu.utils.logger import TensorBoardLogger as JaxTensorBoardLogger
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.configs import compose
from sheeprl_tpu_torch.models import blocks
from sheeprl_tpu_torch.obs import flops as port_flops
from sheeprl_tpu_torch.obs import registry
from sheeprl_tpu_torch.obs.span import span
from sheeprl_tpu_torch.obs.telemetry import RunTelemetry, configure_telemetry, get_telemetry, shutdown_telemetry
from sheeprl_tpu_torch.ops import fused_gru
from sheeprl_tpu_torch.utils import logger as port_logger
from sheeprl_tpu_torch.utils import utils as port_utils

SCALARS = [
    ({"Loss/world_model_loss": 1.25, "Time/sps_train": 3.0e5}, 64),
    ({"Loss/world_model_loss": -0.1, "State/kl": 1e-7, "Grads/actor": 123456.789}, 128),
    ({"Rewards/rew_avg": float("nan"), "Game/ep_len_avg": float("inf")}, 192),
]


def _accumulated(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_event_files_read_back_as_the_jax_loggers(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    loggers = [JaxTensorBoardLogger(jax_dir), port_logger.TensorBoardLogger(port_dir)]
    for logger in loggers:
        logger.log_hyperparams({"algo": {"name": "dreamer_v3"}, "seed": 5})
        for metrics, step in SCALARS:
            logger.log_metrics(metrics, step)
        logger.finalize()
    want, got = _accumulated(jax_dir), _accumulated(port_dir)
    assert sorted(got) == sorted(want) and len(got) == 6
    for tag in want:
        steps = [s for s, _ in got[tag]]
        assert steps == [s for s, _ in want[tag]], tag
        for (_, g), (_, w) in zip(got[tag], want[tag]):
            assert (math.isnan(g) and math.isnan(w)) or g == w == np.float32(w), tag
    # the port's own reader decodes the same file
    (path,) = [os.path.join(port_dir, f) for f in os.listdir(port_dir)]
    mine = port_logger.read_scalars(path)
    assert [(s, t) for s, t, _ in mine] == [(step, tag) for metrics, step in SCALARS for tag in metrics]


def test_a_torn_record_is_refused(tmp_path):
    logger = port_logger.TensorBoardLogger(str(tmp_path))
    logger.log_metrics({"a": 1.0}, 1)
    logger.finalize()
    with open(logger.path, "r+b") as f:
        f.seek(-2, os.SEEK_END)
        f.write(b"\x00\x00")
    with pytest.raises(ValueError):
        port_logger.read_scalars(logger.path)


def test_get_logger_follows_the_config(tmp_path):
    cfg = compose("XS", env="dummy_discrete")
    assert isinstance(port_logger.get_logger({**cfg, "metric": {"log_level": 0}}, str(tmp_path)), port_logger.NoOpLogger)
    assert isinstance(port_logger.get_logger(cfg, str(tmp_path)), port_logger.TensorBoardLogger)
    with pytest.raises(ModuleNotFoundError, match="mlflow"):
        port_logger.get_logger({**cfg, "logger": {"name": "mlflow"}}, str(tmp_path))
    # get_log_dir and run_base_dir live in the logger and stay importable from utils
    assert port_utils.get_log_dir is port_logger.get_log_dir and port_utils.run_base_dir is port_logger.run_base_dir


WINDOW = {"Time/env_interaction_time": 2.0, "Time/train_time": 6.0, "ckpt/snapshot": 0.5}


def _heartbeat(tel, path):
    tel.record_train_window(3, 4)
    tel.record_ckpt_commit("c", 64, "pickle")
    tel.heartbeat(None, step=64, env_steps=64, train_steps=4, train_invocations=None, timer_window=WINDOW)
    tel.writer.flush()
    return [json.loads(line) for line in open(path) if '"heartbeat"' in line][-1]


def test_heartbeat_has_the_jax_fields_and_values(tmp_path):
    jax_tel = JaxRunTelemetry(str(tmp_path / "j.jsonl"))
    port_tel = RunTelemetry(str(tmp_path / "p.jsonl"), device="cpu")
    want = _heartbeat(jax_tel, tmp_path / "j.jsonl")
    got = _heartbeat(port_tel, tmp_path / "p.jsonl")
    assert sorted(got) == sorted(want)
    for key in ("sps_env", "sps_train", "duty_cycle_train", "window_env_steps", "window_train_time", "window_train_dispatches"):
        assert got[key] == want[key], key
    assert got["sps_env"] == 32.0 and got["duty_cycle_train"] == 0.75
    # the rollup and the registry record carry the JAX keys
    want_summary, got_summary = jax_tel.run_summary(), port_tel.run_summary()
    assert set(got_summary) <= set(want_summary)
    assert set(want_summary) - set(got_summary) <= {"net", "serve", "slab_lag", "request_critical_path", "profile_captures"}
    for key in ("sps_env", "sps_train", "duty_cycle_train", "sps_end_to_end", "train_dispatches", "ckpt_commits"):
        assert got_summary[key] == want_summary[key], key
    cfg = compose("XS", env="dummy_discrete")
    got_record = registry.build_run_record(cfg, kind="train", outcome="completed", summary=got_summary)
    want_record = jax_registry.build_run_record(cfg, kind="train", outcome="completed", summary=want_summary)
    assert set(got_record) <= set(want_record)
    assert set(want_record) - set(got_record) == set(want_summary) - set(got_summary)
    assert got_record["config_digest"] == want_record["config_digest"]
    jax_tel.close()
    port_tel.close()


def test_mfu_uses_the_card_peak_at_the_run_precision(tmp_path):
    tel = RunTelemetry(str(tmp_path / "t.jsonl"), device="cpu", precision="bf16-mixed")
    tel.set_flops_source(lambda: 2.0e12)
    with mock.patch.object(RunTelemetry, "device_kind", lambda self: "NVIDIA H100 80GB HBM3"):
        tel.heartbeat(None, step=1, env_steps=4, train_steps=1, train_invocations=10, timer_window=WINDOW)
    beat = [json.loads(line) for line in open(tmp_path / "t.jsonl") if '"heartbeat"' in line][-1]
    assert beat["flops_per_train_step"] == 2.0e12
    assert beat["mfu"] == pytest.approx(2.0e12 * 10 / 6.0 / 989e12)
    tel.close()


def test_registry_path_rules(tmp_path, monkeypatch):
    cfg = {"metric": {"telemetry": {"runs_jsonl": str(tmp_path / "cfg.jsonl")}}}
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", str(tmp_path / "env.jsonl"))
    for rules in (registry, jax_registry):
        assert rules.runs_jsonl_path(cfg) == str(tmp_path / "cfg.jsonl")
        assert rules.runs_jsonl_path({}) == str(tmp_path / "env.jsonl")
        assert rules.runs_jsonl_path({"metric": {"telemetry": {"runs_jsonl": False}}}) is None
        assert rules.runs_jsonl_path({}, path=str(tmp_path / "x.jsonl")) == str(tmp_path / "x.jsonl")
    monkeypatch.setenv("SHEEPRL_TPU_RUNS_JSONL", "")
    assert registry.runs_jsonl_path({}) is None and registry.register_run({}, kind="train", outcome="completed") is None
    monkeypatch.delenv("SHEEPRL_TPU_RUNS_JSONL")
    assert registry.runs_jsonl_path({}) == os.path.join(os.getcwd(), "RUNS.jsonl")
    path = str(tmp_path / "runs.jsonl")
    registry.append_run_record({"schema": 1, "kind": "train"}, path)
    with open(path, "a") as f:
        f.write("{torn\n")
        f.write(json.dumps({"schema": 99}) + "\n")
    registry.append_run_record({"schema": 1, "kind": "eval"}, path)
    assert [r["kind"] for r in registry.read_run_records(path)] == ["train", "eval"]
    assert registry.read_run_records(path) == jax_registry.read_run_records(path)


def test_span_times_and_emits(tmp_path):
    cfg = {"metric": {"telemetry": {"enabled": True, "jsonl": str(tmp_path / "t.jsonl")}}, "fabric": {"accelerator": "cpu"}}
    span.reset()
    configure_telemetry(cfg)
    try:
        with mock.patch("torch.profiler.record_function") as record:
            with span("Time/train_time", attrs_kind="x"):
                pass
        record.assert_called_once_with("Time/train_time")
        assert span.compute()["Time/train_time"] >= 0
    finally:
        shutdown_telemetry()
    assert get_telemetry() is None
    events = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert [e["event"] for e in events][0] == "run_start" and events[-1]["event"] == "run_end"
    assert any(e["event"] == "span" and e["name"] == "Time/train_time" for e in events)
    span.disabled = True
    try:
        with span("Time/other"):
            pass
        assert "Time/other" not in span.timers
    finally:
        span.disabled = False


@pytest.mark.parametrize("batch, in_dim, dense, hidden", [(4, 19, 8, 8), (3, 1027, 16, 32)])
def test_b1_count_is_the_plain_steps_products(batch, in_dim, dense, hidden):
    gen = torch.Generator().manual_seed(0)
    args = [
        torch.randn(batch, in_dim, generator=gen),
        torch.randn(batch, hidden, generator=gen),
        torch.randn(in_dim, dense, generator=gen),
        torch.randn(dense, generator=gen),
        torch.ones(dense),
        torch.zeros(dense),
        torch.randn(hidden + dense, 3 * hidden, generator=gen),
        torch.ones(3 * hidden),
        torch.zeros(3 * hidden),
    ]
    counter = FlopCounterMode(display=False)
    with counter:
        fused_gru.reference_step(*args)
    assert counter.get_total_flops() == fused_gru.step_flops(batch, in_dim, dense, hidden)


TINY = {
    "algo.dense_units": 8,
    "algo.mlp_layers": 1,
    "algo.world_model.encoder.cnn_channels_multiplier": 2,
    "algo.world_model.recurrent_model.recurrent_state_size": 8,
    "algo.world_model.representation_model.hidden_size": 8,
    "algo.world_model.transition_model.hidden_size": 8,
    "algo.world_model.discrete_size": 4,
    "algo.world_model.stochastic_size": 4,
    "env.screen_size": 16,
    "env.num_envs": 2,
    "algo.per_rank_sequence_length": 1,
    "algo.per_rank_batch_size": 2,
    "algo.horizon": 3,
    "fabric.precision": "32-true",
    "algo.cnn_keys.encoder": ["rgb"],
    "algo.mlp_keys.encoder": ["state"],
    "dry_run": True,
    "buffer.memmap": False,
    "algo.learning_starts": 0,
    "buffer.size": 8,
    "metric.log_level": 0,
}


def _product_flops(module, x, out):
    if isinstance(module, blocks.ConvTranspose2d):
        return 2 * x.numel() * module.out_channels * math.prod(module.kernel_size) // module.groups
    if isinstance(module, blocks.Conv2d):
        return 2 * out.numel() * (module.in_channels // module.groups) * math.prod(module.kernel_size)
    return 2 * (x.numel() // x.shape[-1]) * module.in_features * module.out_features


@pytest.mark.parametrize("kernel", ["visible", "opaque"])
def test_gradient_step_flops_equal_the_analytic_count(kernel):
    """One gradient step's count, as ``main`` registers it for MFU, against
    the products of every Dense, conv and fused-step call in it: each call's
    forward, plus its weight gradient and, where the input needs one, its
    input gradient (each the forward's products). ``opaque`` hides the fused
    step's forward from the counter, as a kernel on the card is hidden, so
    the step's count comes from the kernel's own report."""
    calls = []

    def on_forward(module, inputs, out):
        if isinstance(module, (blocks.Dense, blocks.Conv2d, blocks.ConvTranspose2d)):
            x = inputs[0]
            calls.append((_product_flops(module, x, out), torch.is_grad_enabled(), x.requires_grad, module.weight.requires_grad))

    fused_apply = fused_gru._FusedStep.apply
    fused_forward = fused_gru._FusedStep.forward

    def apply(eps1, eps2, x, h, w1, *rest):
        if counted.get("active"):
            flops = fused_gru.step_flops(x.shape[0], x.shape[1], w1.shape[1], h.shape[1])
            calls.append((flops, torch.is_grad_enabled(), x.requires_grad or h.requires_grad, w1.requires_grad))
        return fused_apply(eps1, eps2, x, h, w1, *rest)

    def opaque_forward(ctx, eps1, eps2, *args):
        with _disable_current_modes():
            out = fused_forward(ctx, eps1, eps2, *args)
        if fused_gru.flop_hook is not None:
            fused_gru.flop_hook(fused_gru.step_flops(args[0].shape[0], args[0].shape[1], args[2].shape[1], args[1].shape[1]))
        return out

    counted = {}
    real_count = port_flops.count_flops

    def count(fn, *args, **kwargs):
        handle = torch.nn.modules.module.register_module_forward_hook(on_forward)
        counted["active"] = True
        try:
            out, counted["flops"] = real_count(fn, *args, **kwargs)
        finally:
            counted["active"] = False
            handle.remove()
        return out, counted["flops"]

    cfg = compose("XS", env="dummy_discrete", overrides={**TINY, "log_base_dir": tempfile.mkdtemp()})
    patches = [
        mock.patch.object(port_flops, "count_flops", count),
        mock.patch.object(fused_gru._FusedStep, "apply", apply),
        mock.patch.object(dv3, "get_telemetry", lambda: object()),  # count as a telemetry run does
    ]
    if kernel == "opaque":
        patches.append(mock.patch.object(fused_gru._FusedStep, "forward", staticmethod(opaque_forward)))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        out = dv3.main(cfg, device="cpu")
    assert out["gradient_steps"] == 1
    forward = sum(f for f, _, _, _ in calls)
    backward = sum(f * (int(w) + int(x)) for f, grad, x, w in calls if grad)
    assert counted["flops"] == forward + backward
    assert any(grad and x for f, grad, x, w in calls)  # the scan's fused steps sit under a backward


def test_a_timer_idle_in_the_window_reports_no_rate(tmp_path):
    """A timer registered in an earlier window computes NaN when it did not
    run in this one: no NaN ``Time/sps_train`` and no NaN in the run's
    cumulative train time."""
    from sheeprl_tpu_torch.obs.heartbeat import log_sps_and_heartbeat

    class Logged:
        def __init__(self):
            self.metrics = {}

        def log_metrics(self, metrics, step):
            self.metrics.update(metrics)

    cfg = {"metric": {"telemetry": {"enabled": True, "jsonl": str(tmp_path / "t.jsonl")}}, "fabric": {"accelerator": "cpu"}}
    span.reset()
    with span("Time/train_time"):
        pass
    span.reset()
    configure_telemetry(cfg)
    try:
        logger = Logged()
        with span("Time/env_interaction_time"):
            pass
        log_sps_and_heartbeat(logger, policy_step=4, env_steps=4, train_steps=0, train_invocations=0)
        assert "Time/sps_env_interaction" in logger.metrics and "Time/sps_train" not in logger.metrics
        assert all(v == v for v in logger.metrics.values())
        with span("Time/train_time"):
            pass
        log_sps_and_heartbeat(logger, policy_step=8, env_steps=4, train_steps=1, train_invocations=1)
        summary = get_telemetry().run_summary()
        assert summary["sps_train"] == summary["sps_train"] > 0
    finally:
        shutdown_telemetry()


@pytest.mark.parametrize("poll_rtt", [False, True])
def test_poll_rtt_adds_a_fresh_round_trip_to_each_poll_off_the_cpu(tmp_path, monkeypatch, poll_rtt):
    """``metric.telemetry.poll_rtt`` adds ``rtt_ms`` to every ``device_poll``
    of a run off the CPU, each from a probe of its own (JAX
    ``obs/telemetry.py:714-721``); a CPU run's polls carry none."""
    from sheeprl_tpu_torch.parallel import fabric

    probes = iter([0.002, 0.003])
    monkeypatch.setattr(fabric, "tiny_op_roundtrip_seconds", lambda device=None: next(probes))
    monkeypatch.setattr(fabric, "_rtt_cache", {})
    path = tmp_path / "t.jsonl"
    cfg = {"metric": {"telemetry": {"enabled": True, "jsonl": str(path), "poll_rtt": poll_rtt}}, "fabric": {"accelerator": "cpu"}}
    tel = configure_telemetry(cfg)
    try:
        assert tel.poll_rtt is poll_rtt
        tel.maybe_poll_devices(force=True)
        # a device that is neither the CPU nor a card: no memory statistics,
        # but the probe's rule applies as it does on the card
        tel.device = torch.device("meta")
        tel.maybe_poll_devices(force=True)
        tel.maybe_poll_devices(force=True)
    finally:
        shutdown_telemetry()
    polls = [e for e in map(json.loads, open(path)) if e["event"] == "device_poll"][-3:]
    assert [p.get("rtt_ms") for p in polls] == ([None, 2.0, 3.0] if poll_rtt else [None] * 3)
    assert fabric._rtt_cache == {}


def test_the_link_probe_is_measured_anew_and_the_placement_probe_once(monkeypatch):
    import itertools

    from sheeprl_tpu_torch.parallel import fabric

    monkeypatch.setattr(fabric, "_rtt_cache", {})
    clock = itertools.count(0.0, 0.25)
    monkeypatch.setattr(fabric.time, "perf_counter", lambda: next(clock))
    assert fabric.tiny_op_roundtrip_seconds("cpu") == fabric.tiny_op_roundtrip_seconds("cpu") == pytest.approx(0.25 / 3)
    assert next(clock) == 1.0
    assert fabric.dispatch_roundtrip_seconds("cpu") == pytest.approx(0.25 / 3)
    assert fabric.dispatch_roundtrip_seconds("cpu") == pytest.approx(0.25 / 3)
    assert next(clock) == 1.75
