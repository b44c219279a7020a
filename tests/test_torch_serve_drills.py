"""The serving tier's fault drills on the port's server (the JAX package's
tests/test_serve/test_drills.py over ``sheeprl_tpu_torch.serve``), on the
CPU with the env-free ``linear`` policy: warmup before traffic, coalescing,
slow-inference shedding, crash -> restart serving the requeued request,
budget masking, all-masked failing by deadline, hot swap with zero dropped,
the swap watcher, a poisoned swap rejected then a clean retry promoted, a
torn checkpoint refused, a structure mismatch, rollback. Also: the
snapshot's keys against the JAX server's, the version stamped on each
request, and checkpoint discovery against the JAX package's. Every wait is
bounded."""

import dataclasses
import itertools
import os
import pickle
import threading
import time

import numpy as np
import pytest

from sheeprl_tpu_torch.resilience.manifest import build_manifest
from sheeprl_tpu_torch.serve.errors import DeadlineExceeded, Overloaded, ServeError, SwapRejected
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

DRILL_SERVE = {
    "batch_ladder": [1, 2, 4],
    "slo_ms": 200.0,
    "monitor_interval_s": 0.01,
    "backoff_base_s": 0.01,
    "backoff_max_s": 0.05,
    "replica_timeout_s": 5.0,
}


def commit_linear(ckpt_dir, step, *, seed=0, state=None):
    from sheeprl_tpu_torch.serve.policy import make_linear_state

    os.makedirs(ckpt_dir, exist_ok=True)
    state = state if state is not None else make_linear_state(seed=seed)
    path = os.path.join(ckpt_dir, f"ckpt_{step}_0.ckpt")
    save_checkpoint(path, state, manifest=build_manifest(step=step, backend="pickle", world_size=1, state=state))
    return path, state


def linear_obs(state, value=1.0):
    return {"vector": np.full((state["agent"]["w"].shape[0],), value, dtype=np.float32)}


def expected_action(state, obs):
    return np.asarray(obs["vector"]) @ state["agent"]["w"] + state["agent"]["b"]


def _wait_until(predicate, timeout_s=2.0, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


@pytest.fixture
def make_server(tmp_path):
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.policy import build_linear_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    servers = []

    def build(wrap=None, **serve_overrides):
        ckpt_dir = str(tmp_path / "checkpoint")
        path, state = commit_linear(ckpt_dir, 100, seed=0)
        policy = build_linear_policy({}, state, device="cpu")
        if wrap is not None:
            policy = wrap(policy)
        cfg = serve_config_from_cfg({"serve": {**DRILL_SERVE, **serve_overrides}})
        server = PolicyServer(policy, cfg, step=100, path=path, ckpt_dir=ckpt_dir)
        servers.append(server)
        return server, ckpt_dir, state

    yield build
    for server in servers:
        server.close()


def test_warmup_before_traffic_and_correct_actions(make_server):
    server, _, state = make_server()
    with pytest.raises(ServeError):
        server.submit(linear_obs(state))
    server.start()
    assert sorted(server.warmup_s) == [1, 2, 4]
    assert all(dt >= 0 for dt in server.warmup_s.values())
    obs = linear_obs(state, value=0.5)
    req = server.submit(obs)
    np.testing.assert_allclose(server.wait(req), expected_action(state, obs), rtol=1e-5)
    assert req.served_step == 100  # the version that computed it
    snap = server.snapshot()
    assert snap["completed"] == 1 and snap["submitted"] == 1
    assert snap["serving_step"] == 100
    assert snap["replicas_alive"] == 2 and not snap["degraded"]


def test_concurrent_requests_coalesce_into_batches(make_server):
    server, _, state = make_server(num_replicas=1, gather_window_ms=20.0)
    server.start()
    results, errors = [], []

    def one(i):
        try:
            obs = linear_obs(state, value=float(i))
            results.append((server.infer(obs), expected_action(state, obs)))
        except Exception as err:  # noqa: BLE001 — the drill collects everything
            errors.append(err)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 8
    for got, want in results:  # distinct requests, each its own answer
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    snap = server.snapshot()
    assert snap["batches"] < 8
    assert snap["mean_batch"] > 1.0


def test_slow_inference_drill_bounded_queue_and_typed_shedding(make_server):
    server, _, state = make_server(
        num_replicas=1,
        max_queue=3,
        slo_ms=50.0,
        fault_injection={
            "enabled": True,
            "faults": [{"kind": "slow_inference", "replica": 0, "at_batch": 0, "duration_s": 0.15, "for_batches": 200}],
        },
    )
    server.start()
    obs = linear_obs(state)
    overloads, admitted = 0, []
    for _ in range(30):
        t0 = time.monotonic()
        try:
            admitted.append(server.submit(obs, deadline_s=0.4))
        except Overloaded as err:
            overloads += 1
            assert err.depth >= err.bound == 3
            assert err.retry_after_s > 0
        assert time.monotonic() - t0 < 0.1
        assert server.batcher.depth() <= 3
    assert overloads > 0, "the bounded queue never shed under a slow replica"
    t0 = time.monotonic()
    for req in admitted:
        try:
            server.wait(req)
        except DeadlineExceeded:
            pass
    assert time.monotonic() - t0 < 2.0
    snap = server.snapshot()
    assert snap["shed_overloaded"] == overloads
    assert snap["shed_overloaded"] + snap["shed_expired"] > 0


def test_replica_crash_restart_serves_requeued_request(make_server):
    server, _, state = make_server(
        num_replicas=1,
        slo_ms=500.0,
        fault_injection={"enabled": True, "faults": [{"kind": "replica_crash", "replica": 0, "at_batch": 1}]},
    )
    server.start()
    obs = linear_obs(state, value=2.0)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)
    out = server.infer(obs)  # batch 1 crashes mid-flight; the restart re-serves it
    np.testing.assert_allclose(out, expected_action(state, obs), rtol=1e-5)
    assert _wait_until(lambda: server.replicas.total_restarts == 1)
    snap = server.snapshot()
    assert snap["restarts"] == 1 and not snap["degraded"]
    assert snap["events"].get("replica_restart") == 1


def test_budget_exhausted_masks_slot_and_serves_degraded(make_server):
    server, _, state = make_server(
        num_replicas=2,
        max_restarts=1,
        restart_refund_s=None,
        slo_ms=500.0,
        fault_injection={
            "enabled": True,
            "faults": [
                {"kind": "replica_crash", "replica": 0, "at_batch": 0},
                {"kind": "replica_crash", "replica": 0, "at_batch": 1},
            ],
        },
    )
    server.start()
    obs = linear_obs(state)

    def drive():
        try:
            server.infer(obs, deadline_s=0.5)
        except ServeError:
            pass

    assert _wait_until(lambda: (drive(), server.replicas.masked_count == 1)[-1], timeout_s=2.5)
    snap = server.snapshot()
    assert snap["replicas_masked"] == 1 and snap["degraded"]
    assert snap["events"].get("replica_masked") == 1
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)


def test_all_masked_fails_by_deadline_not_hang(make_server):
    server, _, state = make_server(
        num_replicas=1,
        max_restarts=0,
        fault_injection={"enabled": True, "faults": [{"kind": "replica_crash", "replica": 0, "at_batch": 0}]},
    )
    server.start()
    obs = linear_obs(state)
    try:
        server.infer(obs, deadline_s=0.3)
    except ServeError:
        pass
    assert _wait_until(lambda: server.replicas.all_masked)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded):
        server.infer(obs, deadline_s=0.3)
    assert time.monotonic() - t0 < 1.5


def test_hung_replica_is_replaced_only_once_it_leaves_its_graphs(make_server):
    """A forward that stalls past ``replica_timeout_s`` without a heartbeat
    gets its replica abandoned as hung. The stalled thread wakes inside the
    slot's rung (one rung of 4 here, so every batch shares its buffers, and
    twice as many clients, so a batch waits while one stalls), and the
    replacement must not stage into it before it has left: every answer is
    the plain forward of its own observation."""
    calls = itertools.count(1)

    def stalling(policy):
        def bind(params):
            forward = policy.bind(params)

            def slow(obs):
                if next(calls) % 4 == 0:
                    time.sleep(0.25)  # hung, and before the inputs are read
                return forward(obs)

            return slow

        return dataclasses.replace(policy, bind=bind)

    server, _, state = make_server(
        wrap=stalling, num_replicas=1, batch_ladder=[4], replica_timeout_s=0.08, max_restarts=20, slo_ms=500.0
    )
    server.start()
    failures, results = [], []

    def traffic(t):
        for k in range(4):
            obs = linear_obs(state, value=1.0 + 100 * t + k)
            try:
                results.append((server.infer(obs), expected_action(state, obs)))
            except Exception as err:  # noqa: BLE001 — the drill counts everything
                failures.append(err)

    threads = [threading.Thread(target=traffic, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:3]
    assert len(results) == 32
    for got, want in results:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    snap = server.snapshot()
    assert snap["events"].get("replica_hung", 0) >= 1 and snap["restarts"] >= 1


def test_hot_swap_zero_dropped_in_flight_and_each_answer_stamped(make_server):
    server, ckpt_dir, state = make_server(num_replicas=2, slo_ms=500.0)
    server.start()
    new_path, new_state = commit_linear(ckpt_dir, 200, seed=7)
    obs = linear_obs(state, value=1.0)
    expected = {100: expected_action(state, obs), 200: expected_action(new_state, obs)}
    stop = threading.Event()
    failures, outputs = [], []

    def traffic():
        while not stop.is_set():
            try:
                req = server.submit(obs)
                outputs.append((server.wait(req), req.served_step))
            except Exception as err:  # noqa: BLE001 — the drill counts everything
                failures.append(err)

    threads = [threading.Thread(target=traffic) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    promoted = server.request_swap(new_path)
    time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert promoted.step == 200
    assert not failures, f"hot swap dropped in-flight requests: {failures[:3]}"
    assert {step for _, step in outputs} == {100, 200}
    for out, step in outputs:  # every answer came from the version stamped on it
        np.testing.assert_allclose(out, expected[step], rtol=1e-5)
    snap = server.snapshot()
    assert snap["serving_step"] == 200 and snap["swaps"] == 1
    assert snap["events"].get("swap") == 1


def test_swap_watcher_promotes_newer_commit(make_server):
    server, ckpt_dir, state = make_server(swap_poll_s=0.02)
    server.start()
    assert server.snapshot()["serving_step"] == 100
    commit_linear(ckpt_dir, 300, seed=3)
    assert _wait_until(lambda: server.snapshot()["serving_step"] == 300)


def test_poisoned_swap_rejected_then_clean_retry_promotes(make_server):
    server, ckpt_dir, state = make_server(
        fault_injection={"enabled": True, "faults": [{"kind": "poison_swap", "at_swap": 1}]},
    )
    server.start()
    new_path, new_state = commit_linear(ckpt_dir, 200, seed=7)
    with pytest.raises(SwapRejected, match="non-finite"):
        server.request_swap(new_path)
    snap = server.snapshot()
    assert snap["serving_step"] == 100 and snap["swap_rejects"] == 1 and snap["swaps"] == 0
    assert snap["events"].get("swap_rejected") == 1
    obs = linear_obs(state)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)
    assert server.request_swap(new_path).step == 200
    assert server.snapshot()["serving_step"] == 200
    np.testing.assert_allclose(server.infer(obs), expected_action(new_state, obs), rtol=1e-5)


def test_torn_checkpoint_refused(make_server, tmp_path):
    server, ckpt_dir, _ = make_server()
    server.start()
    torn = str(tmp_path / "checkpoint" / "ckpt_999_0.ckpt")
    with open(torn, "wb") as f:
        pickle.dump({"agent": {}}, f)
    with pytest.raises(SwapRejected, match="manifest"):
        server.request_swap(torn)
    assert server.snapshot()["serving_step"] == 100


@pytest.mark.parametrize("bad", ["shape", "digest"])
def test_structure_or_digest_mismatch_rejected(make_server, bad):
    from sheeprl_tpu_torch.serve.policy import make_linear_state

    server, ckpt_dir, _ = make_server()
    server.start()
    if bad == "shape":
        bad_path, _ = commit_linear(ckpt_dir, 400, state=make_linear_state(in_dim=9))
        match = "structure|shape"
    else:  # a valid-looking manifest over a state of another layout
        bad_path, _ = commit_linear(ckpt_dir, 400, seed=1)
        with open(bad_path, "wb") as f:
            pickle.dump({"agent": {"w": np.zeros((4, 2), np.float32)}, "update": 0}, f)
        match = "digest"
    with pytest.raises(SwapRejected, match=match):
        server.request_swap(bad_path)
    snap = server.snapshot()
    assert snap["serving_step"] == 100 and snap["swap_rejects"] == 1


def test_rollback_restores_previous_version(make_server):
    server, ckpt_dir, state = make_server()
    server.start()
    assert server.store.rollback() is None  # nothing to roll back yet
    new_path, new_state = commit_linear(ckpt_dir, 200, seed=7)
    server.request_swap(new_path)
    assert server.snapshot()["serving_step"] == 200
    restored = server.store.rollback()
    assert restored.step == 100
    snap = server.snapshot()
    assert snap["serving_step"] == 100 and snap["rollbacks"] == 1
    assert snap["events"].get("rollback") == 1
    obs = linear_obs(state)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)


def test_snapshot_has_the_jax_servers_keys(tmp_path):
    from sheeprl_tpu.serve.config import serve_config_from_cfg as jax_cfg
    from sheeprl_tpu.serve.policy import build_linear_policy as jax_linear
    from sheeprl_tpu.serve.server import PolicyServer as JaxServer
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.policy import build_linear_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    path, state = commit_linear(str(tmp_path), 100)
    node = {"serve": {**DRILL_SERVE, "batch_ladder": [1], "num_replicas": 1}}
    jax_server = JaxServer(jax_linear({"algo": {"name": "linear"}}, state), jax_cfg(node), step=100, path=path)
    server = PolicyServer(build_linear_policy({}, state, device="cpu"), serve_config_from_cfg(node), step=100, path=path)
    snaps = []
    for s in (jax_server, server):
        try:
            s.start()
            s.infer(linear_obs(state))
            snaps.append(s.snapshot())
        finally:
            s.close()
    assert sorted(snaps[0]) == sorted(snaps[1])
    assert sorted(snaps[0]["warmup_s"]) == sorted(snaps[1]["warmup_s"]) == [1]
    assert snaps[0]["completed"] == snaps[1]["completed"] == 1


def test_unported_serving_options_raise(make_server):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        make_server(aot_cache_dir="/nonexistent")


@pytest.mark.parametrize("pkg", ["sheeprl_tpu", "sheeprl_tpu_torch"])
def test_discovery_walks_newest_first_through_gates(tmp_path, pkg):
    """newest_committed / newest_valid / validation_load_gate, as the JAX
    package's discovery gives them, on checkpoints the port wrote."""
    import importlib

    discovery = importlib.import_module(f"{pkg}.resilience.discovery")
    manifest = importlib.import_module(f"{pkg}.resilience.manifest")
    ckpt_dir = str(tmp_path)
    for step in (10, 30, 20):
        commit_linear(ckpt_dir, step, seed=step)
    with open(os.path.join(ckpt_dir, "ckpt_40_0.ckpt"), "wb") as f:
        f.write(b"torn")  # no manifest: never a candidate
    with open(os.path.join(ckpt_dir, "ckpt_30_0.ckpt"), "wb") as f:
        f.write(b"corrupt")  # committed but unloadable
    assert discovery.newest_committed(ckpt_dir).step == 30
    rejected = []
    newest = discovery.newest_committed(
        ckpt_dir, gates=(discovery.validation_load_gate,), on_reject=lambda c, r: rejected.append((c.step, r))
    )
    assert newest.step == 20
    assert [s for s, _ in rejected] == [30] and "validation load failed" in rejected[0][1]
    assert [c.step for c in discovery.sort_newest_first(manifest.committed_checkpoints(ckpt_dir))] == [30, 20, 10]
    assert discovery.newest_valid([], gates=()) is None
