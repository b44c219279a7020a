"""The port's resilience plane (sheeprl_tpu_torch/resilience,
utils/callback.py, utils/checkpoint.py) held to the cases of the JAX
package's tests/test_resilience/{test_manifest,test_async_writer,
test_autoresume,test_sentinel}.py, merged into parametrised cases, and the
drills on the port's Dreamer-V3 ``main`` on the CPU at tiny sizes:
a forced NaN rolls back once to the newest committed checkpoint and the run
finishes; past ``resilience.max_rollbacks`` the run raises; a run to N env
steps resumes to 2N with the JAX counters; ``keep_last`` prunes; ``auto``
skips a torn write; a preemption writes an emergency checkpoint and exits
with ``PREEMPTED_EXIT_CODE``.
"""

import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.resilience import async_writer as aw
from sheeprl_tpu_torch.resilience import manager
from sheeprl_tpu_torch.resilience.async_writer import AsyncCheckpointWriter, drain_async_checkpoints, get_async_writer
from sheeprl_tpu_torch.resilience.autoresume import resolve_auto_resume, scan_run_checkpoints
from sheeprl_tpu_torch.resilience.manager import RunResilience
from sheeprl_tpu_torch.resilience.manifest import (
    MANIFEST_SUFFIX,
    TMP_PREFIX,
    build_manifest,
    checkpoint_step,
    committed_checkpoints,
    gc_torn,
    is_committed,
    read_manifest,
    torn_checkpoints,
    write_manifest,
)
from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE
from sheeprl_tpu_torch.resilience.sentinel import all_finite, host_all_finite, parse_nan_faults
from sheeprl_tpu_torch.utils.callback import CheckpointCallback
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_dv3_train import tiny_cfg


@pytest.fixture(autouse=True)
def _fresh_async_writer():
    """The writer is a process-wide singleton: every case starts with none."""
    aw.drain_async_checkpoints(timeout=30.0)
    with aw._writer_lock:
        aw._writer = None
    yield
    aw.drain_async_checkpoints(timeout=30.0)
    with aw._writer_lock:
        aw._writer = None


def _state(step=7, batch_size=64):
    return {"agent": {"w": np.random.rand(4, 3).astype(np.float32), "b": np.zeros(3)}, "update": step, "batch_size": batch_size}


def _save_committed(ckpt_dir, step, batch_size=64, world_size=1):
    os.makedirs(ckpt_dir, exist_ok=True)
    state = _state(step, batch_size)
    path = os.path.join(ckpt_dir, f"ckpt_{step}_0.ckpt")
    save_checkpoint(path, state, manifest=build_manifest(step=step, backend="pickle", world_size=world_size, state=state))
    return path


# --------------------------------------------------------------------------- #
# manifests (test_manifest.py)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "name, step",
    [("ckpt_128_0.ckpt", 128), ("/a/b/ckpt_5_3.ckpt", 5), ("notes.txt", None), ("ckpt_abc_0.ckpt", None), ("ckpt_5.ckpt", None)],
)
def test_checkpoint_step_parsing(name, step):
    assert checkpoint_step(name) == step


def test_manifest_roundtrip(tmp_path):
    path = _save_committed(str(tmp_path), step=42, batch_size=96, world_size=2)
    man = read_manifest(path)
    assert is_committed(path)
    assert (man["step"], man["backend"], man["world_size"], man["batch_size"]) == (42, "pickle", 2, 96)
    assert man["leaf_count"] == 4 and len(man["tree_digest"]) == 12
    assert load_checkpoint(path)["update"] == 42
    assert os.path.isfile(path + MANIFEST_SUFFIX)


@pytest.mark.parametrize("marker", [None, "{ not json", json.dumps({"backend": "pickle"})])
def test_a_checkpoint_without_a_valid_manifest_is_not_committed(tmp_path, marker):
    path = str(tmp_path / "ckpt_3_0.ckpt")
    save_checkpoint(path, _state(3))
    if marker is not None:
        (tmp_path / ("ckpt_3_0.ckpt" + MANIFEST_SUFFIX)).write_text(marker)
    assert read_manifest(path) is None and not is_committed(path)
    assert committed_checkpoints(str(tmp_path)) == []
    write_manifest(path, build_manifest(step=3, backend="pickle", world_size=1))
    assert [c.step for c in committed_checkpoints(str(tmp_path))] == [3]


def test_committed_checkpoints_order_and_foreign_skip(tmp_path):
    d = str(tmp_path)
    for step in (30, 2, 10):
        _save_committed(d, step)
    (tmp_path / "notes.txt").write_text("keep me")
    save_checkpoint(os.path.join(d, "ckpt_99_0.ckpt"), _state(99))
    out = committed_checkpoints(d)
    assert [c.step for c in out] == [2, 10, 30]
    assert all(c.manifest["step"] == c.step for c in out)


def test_torn_detection_and_gc(tmp_path):
    d = str(tmp_path)
    good = _save_committed(d, 10)
    os.makedirs(os.path.join(d, TMP_PREFIX + "ckpt_20_0.ckpt"))
    (tmp_path / ".manifest-x.tmp").write_text("")
    save_checkpoint(os.path.join(d, "ckpt_30_0.ckpt"), _state(30))
    write_manifest(os.path.join(d, "ckpt_40_0.ckpt"), build_manifest(step=40, backend="pickle", world_size=1))
    (tmp_path / "notes.txt").write_text("keep me")
    torn = torn_checkpoints(d)
    assert len(torn) == 4 and good not in torn
    assert sorted(gc_torn(d)) == sorted(torn)
    assert is_committed(good) and (tmp_path / "notes.txt").exists()
    assert torn_checkpoints(d) == []


def test_prune_keeps_newest_by_manifest_step_not_mtime(tmp_path):
    d = str(tmp_path)
    paths = {step: _save_committed(d, step) for step in (10, 2, 30)}
    now = time.time()
    os.utime(paths[30], (now - 1000, now - 1000))
    os.utime(paths[30] + MANIFEST_SUFFIX, (now - 1000, now - 1000))
    os.utime(paths[2], (now, now))
    save_checkpoint(os.path.join(d, "ckpt_99_0.ckpt"), _state(99))
    (tmp_path / "notes.txt").write_text("keep me")
    CheckpointCallback(keep_last=2)._prune(d)
    assert not os.path.exists(paths[2]) and not os.path.exists(paths[2] + MANIFEST_SUFFIX)
    assert (tmp_path / "notes.txt").exists()
    assert not os.path.exists(os.path.join(d, "ckpt_99_0.ckpt"))
    assert [c.step for c in committed_checkpoints(d)] == [10, 30]


# --------------------------------------------------------------------------- #
# the async writer and the callback (test_async_writer.py)
# --------------------------------------------------------------------------- #


def test_single_inflight_skip_and_drain():
    w = AsyncCheckpointWriter()
    release, done = threading.Event(), []
    assert w.submit(lambda: (release.wait(timeout=30), done.append(True)), path="a.ckpt")
    assert w.busy
    assert w.submit(lambda: done.append("overlap"), path="b.ckpt") is False
    assert (w.skipped, w.submitted) == (1, 1)
    release.set()
    assert w.drain(timeout=30) and done == [True]
    assert w.submit(lambda: done.append("next"), path="c.ckpt") and w.drain(timeout=30)
    assert done == [True, "next"] and w.submitted == 2
    w.record_skip()
    assert w.skipped == 2


def test_write_error_never_raises():
    w = AsyncCheckpointWriter()

    def boom():
        raise OSError("disk full")

    with pytest.warns(UserWarning, match="disk full"):
        assert w.submit(boom, path="bad.ckpt") and w.drain(timeout=30)
    assert isinstance(w.last_error, OSError)
    ok = []
    assert w.submit(lambda: ok.append(1), path="good.ckpt") and w.drain(timeout=30) and ok == [1]


@pytest.mark.parametrize("case", ["async_isolation", "busy_drops", "emergency_sync"])
def test_callback_saves(tmp_path, case):
    """Async saves snapshot before returning (a later mutation does not leak
    into the file); a request finding a write in flight is dropped unwritten;
    an emergency save is committed synchronously and flagged."""
    path = str(tmp_path / "ckpt_64_0.ckpt")
    cb = CheckpointCallback(async_save=True)
    if case == "async_isolation":
        state = {"agent": {"w": np.ones((4, 3), np.float32)}, "update": 1, "batch_size": 8}
        cb.on_checkpoint_coupled(path, state)
        state["agent"]["w"] *= 0.0
        assert drain_async_checkpoints(timeout=60) and is_committed(path)
        assert read_manifest(path)["step"] == 64 and not read_manifest(path).get("emergency")
        np.testing.assert_array_equal(load_checkpoint(path)["agent"]["w"], np.ones((4, 3), np.float32))
    elif case == "busy_drops":
        writer, release = get_async_writer(), threading.Event()
        writer.submit(lambda: release.wait(timeout=30), path="inflight.ckpt")
        try:
            cb.on_checkpoint_coupled(path, {"update": 2})
            assert writer.skipped == 1 and not os.path.exists(path)
        finally:
            release.set()
            writer.drain(timeout=30)
    else:
        cb.on_checkpoint_coupled(path, {"update": 3}, emergency=True)
        assert is_committed(path) and read_manifest(path)["emergency"] is True
        assert get_async_writer().submitted == 0


@pytest.mark.parametrize("async_save", [True, False])
def test_buffer_in_checkpoint_flags_last_step_truncated(tmp_path, async_save):
    """The saved buffer ends every env's episode (last step truncated); the
    live buffer is restored by the time the hook returns."""
    rb = EnvIndependentReplayBuffer(8, n_envs=2, obs_keys=("obs",), buffer_cls=SequentialReplayBuffer, seed=0)
    rb.add({"obs": np.zeros((3, 2, 4), np.float32), "truncated": np.zeros((3, 2, 1), np.float32)})
    path = str(tmp_path / "ckpt_32_0.ckpt")
    CheckpointCallback(async_save=async_save).on_checkpoint_coupled(path, {"update": 1}, replay_buffer=rb)
    assert all(b.buffer["truncated"][(b._pos - 1) % b.buffer_size].sum() == 0 for b in rb.buffer)
    assert drain_async_checkpoints(timeout=60)
    saved = load_checkpoint(path)["rb"]
    assert all(b.buffer["truncated"][(b._pos - 1) % b.buffer_size].sum() == 1 for b in saved.buffer)


# --------------------------------------------------------------------------- #
# resume_from=auto (test_autoresume.py)
# --------------------------------------------------------------------------- #


def _auto_cfg(tmp_path):
    return {"root_dir": "dv3/env", "run_name": "drill", "log_base_dir": str(tmp_path / "logs")}


def _add_ckpt(tmp_path, version, step, with_config=True):
    vdir = os.path.join(str(tmp_path), "logs", "dv3", "env", "drill", f"version_{version}")
    if with_config:
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "config.yaml"), "w") as f:
            f.write("{}")
    return _save_committed(os.path.join(vdir, "checkpoint"), step)


@pytest.mark.parametrize(
    "case", ["newest_across_versions", "corrupted_newest", "missing_config", "no_candidates", "all_rejected"]
)
def test_auto_resume(tmp_path, case):
    cfg = _auto_cfg(tmp_path)
    if case == "newest_across_versions":
        _add_ckpt(tmp_path, 0, 64)
        _add_ckpt(tmp_path, 0, 128)
        newest = _add_ckpt(tmp_path, 1, 192)
        assert resolve_auto_resume(cfg) == newest
    elif case == "corrupted_newest":
        older, newest = _add_ckpt(tmp_path, 0, 64), _add_ckpt(tmp_path, 0, 128)
        with open(newest, "wb") as f:
            f.write(b"\x00garbage")
        with pytest.warns(UserWarning, match="falling back"):
            assert resolve_auto_resume(cfg) == older
    elif case == "missing_config":
        older = _add_ckpt(tmp_path, 0, 64)
        _add_ckpt(tmp_path, 1, 128, with_config=False)
        with pytest.warns(UserWarning, match="config.yaml"):
            assert resolve_auto_resume(cfg) == older
    elif case == "no_candidates":
        with pytest.warns(UserWarning, match="fresh run"):
            assert resolve_auto_resume(cfg) is None
    else:
        with open(_add_ckpt(tmp_path, 0, 64), "wb") as f:
            f.write(b"nope")
        with pytest.warns(UserWarning, match="rejected"):
            assert resolve_auto_resume(cfg) is None


def test_scan_ignores_uncommitted_and_gcs_torn(tmp_path):
    good = _add_ckpt(tmp_path, 0, 64)
    ckpt_dir = os.path.dirname(good)
    torn = os.path.join(ckpt_dir, "ckpt_128_0.ckpt")
    save_checkpoint(torn, {"agent": {"w": np.zeros(3)}})
    os.makedirs(os.path.join(ckpt_dir, ".tmp-ckpt_192_0.ckpt"))
    with pytest.warns(UserWarning, match="garbage-collected"):
        found = scan_run_checkpoints(os.path.dirname(os.path.dirname(ckpt_dir)))
    assert [c.step for c in found] == [64]
    assert not os.path.exists(torn) and not os.path.exists(os.path.join(ckpt_dir, ".tmp-ckpt_192_0.ckpt"))


# --------------------------------------------------------------------------- #
# the sentinel and the rollback manager (test_sentinel.py)
# --------------------------------------------------------------------------- #


def _res_cfg(**res):
    # preemption=False: unit cases install no signal handler
    return {"resilience": {"enabled": True, "preemption": False, **res}, "checkpoint": {}}


@pytest.mark.parametrize(
    "tree, finite",
    [
        ({"a": torch.ones(3), "b": (torch.zeros(2), torch.arange(4))}, True),
        ({"a": torch.tensor([1.0, float("nan"), 1.0]), "b": (torch.zeros(2),)}, False),
        ({"x": torch.tensor([1.0, float("inf")])}, False),
        ({"count": torch.arange(3)}, True),
    ],
)
def test_all_finite_on_device_tensors(tree, finite):
    assert bool(all_finite(tree)) is finite
    assert host_all_finite(tree) is finite


@pytest.mark.parametrize(
    "tree, finite",
    [
        ({"a": [1.0, 2.0], "b": {"c": np.ones(3)}}, True),
        ({"a": [1.0, float("nan")]}, False),
        ([np.asarray([np.inf])], False),
        ({"name": "run", "n": np.arange(5)}, True),
    ],
)
def test_host_all_finite_nested(tree, finite):
    assert host_all_finite(tree) is finite


@pytest.mark.parametrize(
    "res, want",
    [
        ({}, set()),
        ({"fault_injection": {"enabled": False, "faults": [{"at_update": 1}]}}, set()),
        ({"fault_injection": {"enabled": True, "faults": [{"kind": "nan", "at_update": 3}, {"at_update": 7}]}}, {3, 7}),
        ({"fault_injection": {"enabled": True, "faults": [{"kind": "crash", "at_update": 1}]}}, "kind"),
        ({"fault_injection": {"enabled": True, "faults": [{"kind": "nan"}]}}, "at_update"),
        ({"fault_injection": {"enabled": True, "faults": ["nan@3"]}}, "mappings"),
    ],
)
def test_parse_nan_faults(res, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            parse_nan_faults(res)
    else:
        assert parse_nan_faults(res) == want


def test_check_finite_and_fault_injection(tmp_path):
    resil = RunResilience(_res_cfg(fault_injection={"enabled": True, "faults": [{"kind": "nan", "at_update": 3}]}), str(tmp_path))
    assert resil.check_finite({"loss": 1.0}, update=1)
    assert not resil.check_finite({"loss": float("nan")}, update=2)
    with pytest.warns(UserWarning, match="fault_injection"):
        assert not resil.check_finite({"loss": 1.0}, update=3)
    assert resil.check_finite({"loss": 1.0}, update=3)
    assert resil.window_ok(True, update=4) and not resil.window_ok(False, update=4)
    inert = RunResilience(_res_cfg(check_finite=False), str(tmp_path))
    assert inert.check_finite({"loss": float("nan")}, update=1) and inert.window_ok(False, update=1)


@pytest.mark.parametrize("max_rollbacks, match", [(0, "max_rollbacks"), (2, "no committed checkpoint")])
def test_rollback_refuses(tmp_path, max_rollbacks, match):
    with pytest.raises(RuntimeError, match=match):
        RunResilience(_res_cfg(max_rollbacks=max_rollbacks), str(tmp_path)).rollback(update=5)


def test_rollback_restores_newest_committed_and_resalts(tmp_path):
    ckpt_dir = os.path.join(str(tmp_path), "checkpoint")
    for step, val in ((64, 1.0), (128, 2.0)):
        state = {"agent": {"w": np.full(3, val, np.float32)}, "update": step // 64}
        os.makedirs(ckpt_dir, exist_ok=True)
        save_checkpoint(
            os.path.join(ckpt_dir, f"ckpt_{step}_0.ckpt"),
            state,
            manifest=build_manifest(step=step, backend="pickle", world_size=1, state=state),
        )
    save_checkpoint(os.path.join(ckpt_dir, "ckpt_192_0.ckpt"), {"agent": {"w": np.zeros(3)}})  # torn
    resil = RunResilience(_res_cfg(max_rollbacks=2), str(tmp_path))
    with pytest.warns(UserWarning, match="rolled back"):
        restored = resil.rollback(update=9)
    np.testing.assert_array_equal(restored["agent"]["w"], np.full(3, 2.0, np.float32))
    assert resil.rollbacks == 1
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state().clone()
    resil.resalt_key(gen)
    assert not torch.equal(before, gen.get_state())
    with pytest.warns(UserWarning, match="rolled back"):
        resil.rollback(update=10)
    with pytest.raises(RuntimeError, match="max_rollbacks"):
        resil.rollback(update=11)


# --------------------------------------------------------------------------- #
# drills on main (the CPU runs the same callable the card replays)
# --------------------------------------------------------------------------- #


def drill_cfg(tmp_path, **extra):
    return tiny_cfg(
        (),
        ("state",),
        env="dummy_discrete",
        **{
            "env.num_envs": 2,
            "buffer.size": 64,
            "algo.learning_starts": 8,
            "algo.total_steps": 24,
            "log_base_dir": str(tmp_path),
            "run_name": "drill",
            "metric.log_every": 8,
            **extra,
        },
    )


def _faults(*updates):
    return {"enabled": True, "faults": [{"kind": "nan", "at_update": u} for u in updates]}


def test_nan_rollback_drill_on_main(tmp_path):
    """A forced NaN at update 10 rolls back once, to the checkpoint of
    update 8 (policy step 16), and the run finishes with finite metrics."""
    cfg = drill_cfg(tmp_path, **{"checkpoint.every": 8, "resilience.fault_injection": _faults(10)})
    with pytest.warns(UserWarning, match="rolled back to .*ckpt_16_0.ckpt"):
        out = tdv3.main(cfg, device="cpu")
    assert out["rollbacks"] == 1 and out["env_steps"] == 24
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert [c.step for c in committed_checkpoints(os.path.join(out["log_dir"], "checkpoint"))][-1] == 24


def test_nan_rollbacks_past_the_budget_raise(tmp_path):
    cfg = drill_cfg(
        tmp_path,
        **{"checkpoint.every": 8, "resilience.max_rollbacks": 1, "resilience.fault_injection": _faults(9, 11)},
    )
    with pytest.warns(UserWarning, match="rolled back"), pytest.raises(RuntimeError, match="max_rollbacks=1"):
        tdv3.main(cfg, device="cpu")


def test_resume_drill_on_main(tmp_path):
    """Run to N = 24 env steps with save_last, then resume to 2N from
    ``auto``: the counters continue (update, policy step, last log and
    checkpoint, learning_starts pushed past the resume point), the weights,
    optimizers, Moments and streams are the saved ones, ``keep_last``
    prunes, and ``auto`` skips a torn newer write."""
    cfg = drill_cfg(tmp_path, **{"checkpoint.every": 8, "checkpoint.keep_last": 2})
    first = tdv3.main(cfg, device="cpu")
    ckpt_dir = os.path.join(first["log_dir"], "checkpoint")
    assert [c.step for c in committed_checkpoints(ckpt_dir)] == [16, 24]
    saved = load_checkpoint(os.path.join(ckpt_dir, "ckpt_24_0.ckpt"))
    assert (saved["update"], saved["last_checkpoint"], saved["batch_size"]) == (12, 24, 2)
    assert [int(np.asarray(s[1][0].count)) for s in (saved["world_optimizer"],)] == [first["gradient_steps"]]
    torn = os.path.join(ckpt_dir, "ckpt_40_0.ckpt")
    save_checkpoint(torn, {"update": 20})  # a crashed save: no manifest
    resumed = drill_cfg(tmp_path, **{"checkpoint.resume_from": "auto", "algo.total_steps": 48})
    with pytest.warns(UserWarning, match="garbage-collected"):
        second = tdv3.main(resumed, device="cpu")
    assert not os.path.exists(torn)
    assert second["start_update"] == 13 and second["env_steps"] == 48
    # learning_starts 8 / 2 envs + start 13: training resumes at update 17
    # (policy step 34), where the restored Ratio (last call at policy step
    # 24) owes 34 - 24 steps, then 2 an update to update 24
    assert second["gradient_steps"] == (34 - 24) + 2 * (24 - 17)
    assert second["log_dir"] != first["log_dir"]
    assert [c.step for c in committed_checkpoints(os.path.join(second["log_dir"], "checkpoint"))] == [48]


def test_preemption_drill_on_main(tmp_path, monkeypatch):
    """A preemption request at the top of update 7 drains, writes a
    committed emergency checkpoint of update 6 and exits with
    PREEMPTED_EXIT_CODE."""
    polls = itertools.count(1)
    monkeypatch.setattr(manager.RunResilience, "preempt_requested", lambda self: next(polls) >= 7)
    with pytest.raises(SystemExit) as exit_info:
        tdv3.main(drill_cfg(tmp_path), device="cpu")
    assert exit_info.value.code == PREEMPTED_EXIT_CODE
    (ckpt,) = committed_checkpoints(os.path.join(str(tmp_path), "dreamer_v3", "dummy_discrete", "drill", "version_0", "checkpoint"))
    assert ckpt.step == 12 and ckpt.manifest["emergency"] is True
    assert load_checkpoint(ckpt.path)["update"] == 6
