"""The replica fleet on the port (tests/test_serve/test_fleet.py and
test_ordering.py over ``sheeprl_tpu_torch.serve``), on the CPU with the
env-free ``linear`` policy and the JAX drills' fleet settings (DRILL_FLEET),
plus the port held against the JAX fleet:

- answers of the two fleets on one committed linear checkpoint (written as
  the JAX tests commit it, loaded by each package's ``load_checkpoint``)
  within ``ANSWER_TOL``;
- for scripted pool depths, healths, kinds and priorities: identical
  ``_ranked_targets`` orders; identical ``hedge_threshold_s`` for the same
  latency history; identical ``resolved_max_pending``;
- identical single-threaded ``SlotPool`` offer/take/complete/requeue/drain
  sequences from seeded numpy draws, staged rows included.

The router and slot-pool bodies run on both packages (``pkg``), so the same
assertions hold for each. Only the chaos ramp is ``slow``, as in JAX. Every
wait is bounded.
"""

import importlib
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from sheeprl_tpu_torch.resilience.manifest import build_manifest
from sheeprl_tpu_torch.serve.errors import Overloaded
from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["sheeprl_tpu", "sheeprl_tpu_torch"]
ANSWER_TOL = 1e-6
FAR = 3600.0  # deadlines far enough that only a bug could expire a request

# tests/test_serve/conftest.py's drill nodes: fast monitor, near-zero
# backoff, a small ladder; a small fleet with fast autoscale and hedge scans
DRILL_SERVE = {
    "batch_ladder": [1, 2, 4],
    "slo_ms": 200.0,
    "monitor_interval_s": 0.01,
    "backoff_base_s": 0.01,
    "backoff_max_s": 0.05,
    "replica_timeout_s": 5.0,
}
DRILL_FLEET = {
    "enabled": True,
    "num_replicas": 2,
    "min_replicas": 1,
    "max_replicas": 2,
    "backlog_per_replica": 64,
    "hedge_scan_ms": 2.0,
    "autoscale_interval_s": 0.05,
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


def _wait_until(predicate, timeout_s=5.0, interval_s=0.005):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


@pytest.fixture
def make_fleet(tmp_path):
    """A port FleetServer over a committed linear checkpoint at step 100.
    ``fleet=`` overrides merge into DRILL_FLEET, other keywords into the
    serve node; every fleet is closed at teardown."""
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.fleet import FleetServer
    from sheeprl_tpu_torch.serve.policy import build_linear_policy

    servers = []

    def build(*, fleet=None, **serve_overrides):
        ckpt_dir = str(tmp_path / "checkpoint")
        path, state = commit_linear(ckpt_dir, 100, seed=0)
        policy = build_linear_policy({}, state, device="cpu")
        node = {**DRILL_SERVE, **serve_overrides, "fleet": {**DRILL_FLEET, **(fleet or {})}}
        server = FleetServer(policy, serve_config_from_cfg({"serve": node}), step=100, path=path, ckpt_dir=ckpt_dir)
        servers.append(server)
        return server, ckpt_dir, state

    yield build
    for server in servers:
        server.close()


@pytest.fixture(params=PACKAGES)
def pkg(request):
    mod = lambda name: importlib.import_module(f"{request.param}.serve.{name}")  # noqa: E731
    return SimpleNamespace(
        name=request.param,
        batching=mod("batching"),
        faults=mod("fault_injection"),
        router=mod("router"),
        slots=mod("slots"),
    )


# ------------------------------------------------------------------ fleet ----


def test_fleet_warmup_then_correct_actions_and_snapshot(make_fleet):
    server, _, state = make_fleet()
    server.start()
    assert sorted(server.warmup_s) == [1, 2, 4]
    obs = linear_obs(state, value=0.5)
    out = server.infer(obs)
    np.testing.assert_allclose(out, expected_action(state, obs), rtol=1e-5)
    snap = server.snapshot()
    assert snap["completed"] == 1 and snap["serving_step"] == 100
    assert snap["replicas_alive"] == 2 and not snap["degraded"]
    fleet = snap["fleet"]
    assert fleet["active_device_replicas"] == 2
    assert fleet["router"]["routed"] == 1 and fleet["router"]["shed"] == 0
    assert len(fleet["replicas"]) == 2
    assert all(r["health"] > 0 for r in fleet["replicas"] if r["active"])


def test_fleet_admission_bound_sheds_typed(make_fleet):
    server, _, state = make_fleet(
        fleet={"max_pending": 1, "num_replicas": 1, "max_replicas": 1},
        fault_injection={
            "enabled": True,
            "faults": [{"kind": "slow_inference", "replica": 0, "at_batch": 0, "duration_s": 0.2, "for_batches": 50}],
        },
    )
    server.start()
    reqs = []
    shed = 0
    for _ in range(6):
        try:
            reqs.append(server.submit(linear_obs(state), deadline_s=5.0))
        except Overloaded:
            shed += 1
    assert shed >= 1  # past the fleet-wide pending bound: typed, immediate
    for req in reqs:
        server.wait(req)  # admitted requests still complete
    assert server.router.shed == shed


def _trace_summary(path):
    from tools import trace as trace_tool

    merged = trace_tool.merge([path])
    return merged, trace_tool.summarize(merged)


def test_kill_replica_mid_burst_zero_dropped(make_fleet, tmp_path):
    """The fast chaos drill: kill a replica while a burst is in flight —
    every admitted request completes (re-route-at-front), the fleet restarts
    the dead replica, and the survivors keep serving. Runs under the trace
    plane: the merged timeline shows one complete causal chain per request
    and the kill's stranded batch attributed re-routed (or hedged)."""
    from sheeprl_tpu_torch.obs.trace import configure_trace, shutdown_trace

    trace_path = str(tmp_path / "trace.serve.jsonl")
    configure_trace("serve", trace_path)
    try:
        server, _, state = make_fleet(
            fleet={"num_replicas": 2, "max_replicas": 2, "max_pending": 10_000},
            # pin a batch in flight on replica 0 so the kill strands it
            fault_injection={
                "enabled": True,
                "faults": [{"kind": "slow_inference", "replica": 0, "at_batch": 0, "duration_s": 0.25, "for_batches": 50}],
            },
        )
        server.start()
        results, errors = [], []

        def client(n):
            for i in range(n):
                try:
                    obs = linear_obs(state, value=float(i % 7))
                    out = server.infer(obs, deadline_s=10.0)
                    np.testing.assert_allclose(out, expected_action(state, obs), rtol=1e-5)
                    results.append(out)
                except Exception as err:  # noqa: BLE001 — the drill collects everything
                    errors.append(err)

        threads = [threading.Thread(target=client, args=(30,)) for _ in range(4)]
        for t in threads:
            t.start()
        assert _wait_until(lambda: len(server.slots[0].pool._inflight) > 0)
        assert server.kill_replica(0)
        for t in threads:
            t.join(20.0)
        assert not errors and len(results) == 120
        assert _wait_until(lambda: server.slots[0].alive)  # budgeted restart
        snap = server.snapshot()
        assert snap["failed"] == 0 and snap["restarts"] >= 1
        router_snap = snap["fleet"]["router"]
        assert router_snap["rerouted_requests"] + router_snap["hedged"] >= 1

        def done_count():
            with open(trace_path) as f:
                return sum(1 for line in f if '"request_done"' in line)

        assert _wait_until(lambda: done_count() >= 120)
    finally:
        shutdown_trace()

    from tools import trace as trace_tool

    merged, summary = _trace_summary(trace_path)
    req = summary["requests"]
    assert req["traces"] == 120
    assert req["terminals"] == {"request_done": 120}
    assert req["rerouted"] + req["hedged"] >= 1
    assert "hedge_winner_dupes" not in req
    for tid, evs in merged["traces"].items():
        kinds = trace_tool.trace_kinds(evs)
        assert kinds[0] == "request_admit", (tid, kinds)
        assert kinds.count("request_done") == 1, (tid, kinds)
    victims = [evs for evs in merged["traces"].values() if any(e["kind"] in ("request_reroute", "request_hedge") for e in evs)]
    assert victims
    for evs in victims:
        done = [e for e in evs if e["kind"] == "request_done"][0]
        if "request_reroute" in [e["kind"] for e in evs]:
            assert done["rerouted"] is True
        else:
            assert done["hedged"] is True
    assert any(e["kind"] == "replica_killed" for e in merged["untraced"])
    for key in ("total_ms", "queue_wait_ms", "assembly_ms", "compute_ms"):
        assert "p50" in req[key] and "p95" in req[key]


def test_stress_many_clients_hedges_and_a_kill_lose_nothing(make_fleet):
    """More client threads than cores, a switch interval cut to 10 us, a
    slowed replica (hedges), a CPU-spill slot taking ``batch`` traffic and a
    kill mid-run: every admitted request is answered once with its own
    product, and once the fleet is idle every pool holds every staging row
    again (a hedge twin lost in one pool, or a lost update on the shared
    request, would leave a row held or an answer wrong)."""
    server, _, state = make_fleet(
        fleet={"num_replicas": 2, "max_replicas": 2, "cpu_spill_replicas": 1, "spill_depth": 1, "max_pending": 10_000},
        fault_injection={
            "enabled": True,
            "faults": [{"kind": "slow_inference", "replica": 1, "at_batch": 0, "duration_s": 0.02, "for_batches": 20}],
        },
    )
    server.start()
    n_threads = 2 * (os.cpu_count() or 1) + 4
    results, errors = [], []

    def client(k):
        for i in range(25):
            obs = linear_obs(state, value=float(k * 100 + i) / 100.0)
            try:
                out = server.infer(obs, deadline_s=30.0, priority="batch" if i % 3 == 0 else "interactive")
                results.append((obs, out))
            except Exception as err:  # noqa: BLE001 — the test counts every failure
                errors.append(err)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(n_threads)]
        for t in threads:
            t.start()
        assert _wait_until(lambda: server.router.routed >= 40, timeout_s=20.0)
        server.kill_replica(0)
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[:3]
    assert len(results) == 25 * n_threads
    for obs, out in results:
        np.testing.assert_allclose(out, expected_action(state, obs), rtol=1e-5)
    snap = server.snapshot()
    assert snap["failed"] == 0 and snap["fleet"]["router"]["hedged"] >= 1
    idle = _wait_until(lambda: all(s.pool.outstanding() == 0 for s in server.slots), timeout_s=5.0)
    pools = [(len(s.pool._waiting), len(s.pool._backlog), [(r.rid, r.future.done()) for r in s.pool._inflight.values()], s.alive, s.restart_at, s.masked, s.mask_reason, s.restarts) for s in server.slots]
    assert idle, (pools, snap["events"])
    assert [s.pool.free_rows() for s in server.slots] == [2 * server.config.max_batch] * 3


def test_budget_exhaustion_masks_and_fleet_serves_degraded(make_fleet):
    server, _, state = make_fleet(max_restarts=1, restart_refund_s=None, fleet={"num_replicas": 2, "max_replicas": 2})
    server.start()
    for _ in range(2):  # budget of 1: second death masks the slot
        assert _wait_until(lambda: server.slots[0].alive)
        server.kill_replica(0)
        assert _wait_until(lambda: not server.slots[0].alive, timeout_s=2.0)
        _wait_until(lambda: server.slots[0].masked or server.slots[0].restart_at is not None or server.slots[0].alive)
    assert _wait_until(lambda: server.slots[0].masked)
    obs = linear_obs(state)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)
    snap = server.snapshot()
    assert snap["degraded"] and snap["replicas_masked"] == 1
    assert snap["fleet"]["active_device_replicas"] == 1  # N-1, still serving


def test_emergency_floor_reactivates_standby_after_last_replica_masked(make_fleet):
    """Losing the LAST active replica must not strand the fleet at zero
    capacity: the emergency floor activates (and captures) a standby slot
    at once, and the hedge scan re-places the stranded request on it."""
    server, _, state = make_fleet(
        max_restarts=0,
        restart_refund_s=None,
        fleet={"num_replicas": 1, "min_replicas": 1, "max_replicas": 2, "max_pending": 10_000},
    )
    server.start()
    assert not server.store.has_graphs(1)  # standby: captured at activation
    obs = linear_obs(state)
    server.infer(obs)
    server.kill_replica(0)
    assert _wait_until(lambda: server.slots[0].masked, timeout_s=5.0)
    req = server.submit(obs, deadline_s=10.0)
    np.testing.assert_allclose(server.wait(req), expected_action(state, obs), rtol=1e-5)
    assert server.slots[1].alive and server.slots[1].active and server.store.has_graphs(1)
    snap = server.snapshot()
    assert snap["degraded"] and snap["fleet"]["active_device_replicas"] == 1
    assert snap["fleet"]["scale_ups"] >= 1
    assert [c["replica"] for c in snap["fleet"]["slot_captures"]] == [1]


def test_cpu_spill_absorbs_batch_priority(make_fleet):
    server, _, state = make_fleet(
        fleet={
            "num_replicas": 1,
            "max_replicas": 1,
            "cpu_spill_replicas": 1,
            "spill_depth": 0,  # device "saturated" immediately: spill opens
        }
    )
    server.start()
    spill_index = server.config.fleet.max_replicas  # spill slots follow device slots
    assert str(server.slots[spill_index].device) == "cpu" and server.slots[spill_index].kind == "cpu_spill"
    obs = linear_obs(state)
    req = server.submit(obs, deadline_s=5.0, priority="batch")
    assert req.placements == [spill_index]
    np.testing.assert_allclose(server.wait(req), expected_action(state, obs), rtol=1e-5)
    assert server.router.spilled == 1
    # interactive traffic never lands on the spill tier while a device
    # replica is routable
    req = server.submit(obs, deadline_s=5.0)
    assert req.placements and req.placements[0] != spill_index
    server.wait(req)


def test_batch_priority_load_rides_the_spill_tier(make_fleet):
    """``run_load(priority="batch")`` tags every request through the client,
    so a saturated device tier spills the loadgen's traffic."""
    from sheeprl_tpu_torch.serve.config import LoadConfig
    from sheeprl_tpu_torch.serve.loadgen import run_load

    # hedging off: a hedge twin would count a second placement
    server, _, _ = make_fleet(fleet={"num_replicas": 1, "max_replicas": 1, "cpu_spill_replicas": 1, "spill_depth": 0, "hedge_max": 0})
    server.start()
    report = run_load(server, LoadConfig(enabled=True, duration_s=0.3, concurrency=2, seed=0), priority="batch")
    assert report["ok"] > 0 and report["errors"] == 0
    assert server.router.spilled == server.router.routed == server.snapshot()["fleet"]["replicas"][1]["requests"]


def test_autoscale_up_under_pressure_then_down_when_idle(make_fleet):
    server, _, state = make_fleet(
        fleet={
            "num_replicas": 1,
            "min_replicas": 1,
            "max_replicas": 2,
            "max_pending": 10_000,
            "scale_up_depth": 2.0,
            "scale_down_depth": 0.5,
            "scale_patience": 1,
            "autoscale_interval_s": 0.02,
        },
        fault_injection={
            "enabled": True,
            "faults": [{"kind": "slow_inference", "replica": 0, "at_batch": 0, "duration_s": 0.1, "for_batches": 30}],
        },
    )
    server.start()
    assert server.snapshot()["fleet"]["active_device_replicas"] == 1
    reqs = [server.submit(linear_obs(state, value=float(i)), deadline_s=30.0) for i in range(24)]
    assert _wait_until(lambda: server.scale_ups >= 1, timeout_s=5.0)
    for req in reqs:
        server.wait(req)
    assert _wait_until(lambda: server.scale_downs >= 1, timeout_s=5.0)
    snap = server.snapshot()
    assert snap["fleet"]["scale_ups"] >= 1 and snap["fleet"]["scale_downs"] >= 1
    assert snap["fleet"]["active_device_replicas"] == 1  # back at the floor
    assert snap["failed"] == 0
    # the activated slot was captured before it took traffic, the pause counted
    (capture,) = snap["fleet"]["slot_captures"]
    assert capture["replica"] == 1 and sum(capture["pauses_s"]) >= capture["capture_s"] >= 0
    assert capture["pause_s"] == max(capture["pauses_s"])


def test_hot_swap_reaches_every_slot(make_fleet):
    """One swap flips every captured slot (device and spill) to the new
    version: each slot's answers after it are the new weights'."""
    from sheeprl_tpu_torch.serve.policy import make_linear_state

    server, ckpt_dir, state = make_fleet(fleet={"num_replicas": 2, "max_replicas": 2, "cpu_spill_replicas": 1})
    server.start()
    new_state = make_linear_state(seed=5)
    path, _ = commit_linear(ckpt_dir, 200, state=new_state)
    server.request_swap(path)
    obs = linear_obs(state, value=0.25)
    for slot in server.slots:
        ladder = server.store.current.ladders[slot.index]
        np.testing.assert_allclose(ladder.run([obs])[0], expected_action(new_state, obs), rtol=1e-5)
    req = server.submit(obs, deadline_s=5.0)
    np.testing.assert_allclose(server.wait(req), expected_action(new_state, obs), rtol=1e-5)
    assert req.served_step == 200 and server.snapshot()["serving_step"] == 200


def test_serving_resumes_between_the_pauses_of_a_swap():
    """A swap captures one slot's set at a time under the gate held alone;
    a replica held back by one pause enters before the next pause begins,
    so no request waits out every slot's captures at once."""
    from sheeprl_tpu_torch.serve.model import ServingGate

    gate = ServingGate()
    entered = threading.Event()

    def replica():
        with gate.shared():
            entered.set()

    thread = threading.Thread(target=replica, daemon=True)
    with gate.exclusive():
        thread.start()
        assert _wait_until(lambda: gate._held_back == 1)
    with gate.exclusive():  # the next slot's pause, asked for at once
        assert entered.is_set()
    thread.join(5.0)
    assert not thread.is_alive()


def test_a_fleet_swap_pauses_once_a_slot_then_for_the_flip(make_fleet):
    from sheeprl_tpu_torch.serve.policy import make_linear_state

    server, ckpt_dir, _ = make_fleet(fleet={"num_replicas": 2, "max_replicas": 3, "cpu_spill_replicas": 1})
    events = []
    server._on_event = lambda kind, info: events.append((kind, info))
    server.start()
    path, _ = commit_linear(ckpt_dir, 200, state=make_linear_state(seed=7))
    server.request_swap(path)
    ((_, info),) = [e for e in events if e[0] == "swap"]
    assert len(info["pauses_s"]) == 3 + 1  # two device slots, the spill slot (the standby has none), the flip
    assert info["pause_s"] == max(info["pauses_s"]) and info["capture_s"] <= sum(info["pauses_s"])


def test_a_slow_graph_build_in_a_swap_beside_an_activation_expires_nothing(make_fleet, monkeypatch):
    """A swap whose first slot's graph set takes 0.6 s to build (slowed
    here), past the requests' 0.4 s deadline, while the standby slot is
    activated: the sets are built while the old version serves, so each of
    the swap's pauses (the slot's captures, then the flip) and each of the
    activation's stays short and no request expires. The activation waits
    for the swap and captures the standby in pauses of its own, never
    inside one of the swap's."""
    from sheeprl_tpu_torch.serve import model
    from sheeprl_tpu_torch.serve.policy import make_linear_state

    server, ckpt_dir, state = make_fleet(fleet={"num_replicas": 1, "max_replicas": 2, "scale_up_depth": 1e9})
    events = []
    server._on_event = lambda kind, info: events.append((kind, info))
    server.start()
    real, building = model.ModelStore._ladder, threading.Event()

    def slow_first_slot(self, slot, params, forwards):
        if slot == 0 and params is not self._current.params:  # the candidate's set
            building.set()
            time.sleep(0.6)
        return real(self, slot, params, forwards)

    monkeypatch.setattr(model.ModelStore, "_ladder", slow_first_slot)
    path, _ = commit_linear(ckpt_dir, 200, state=make_linear_state(seed=7))
    stop, served, failures = threading.Event(), [], []

    def traffic(i):
        while not stop.is_set():
            try:
                served.append(server.wait(server.submit(linear_obs(state, value=float(i)), deadline_s=0.4)))
            except Exception as err:  # counted: a drill's failure
                failures.append(repr(err))

    threads = [threading.Thread(target=traffic, args=(i,), daemon=True) for i in range(4)]
    swap = threading.Thread(target=server.request_swap, args=(path,), daemon=True)
    try:
        for t in threads:
            t.start()
        swap.start()
        assert building.wait(5.0)
        server._activate(server.slots[1], {"drill": "overlap"})  # waits for the swap
        swap.join(10.0)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads + [swap]:
            t.join(10.0)
    assert not any(t.is_alive() for t in threads + [swap])
    snap = server.snapshot()
    assert not failures and snap["shed_expired"] == 0 and snap["failed"] == 0 and served
    assert snap["serving_step"] == 200 and server.store.has_graphs(1)
    ((_, swap_info),) = [e for e in events if e[0] == "swap"]
    ((_, capture),) = [e for e in events if e[0] == "slot_capture"]
    # the swap paused for slot 0's captures and the flip; the standby, not
    # captured then, paused in its own capture for each version
    assert len(swap_info["pauses_s"]) == 2 and [p["slot"] for p in swap_info["pause_parts"]] == [0]
    assert len(capture["pauses_s"]) == 2 and {p["slot"] for p in capture["pause_parts"]} == {1}
    assert max(swap_info["pauses_s"] + capture["pauses_s"]) < 0.3
    assert [kind for kind, _ in events if kind in ("swap", "slot_capture")] == ["swap", "slot_capture"]


def test_a_failed_capture_raises_rather_than_falling_back(make_fleet, monkeypatch):
    """A slot's ladder that fails to capture raises: the fleet does not
    start (no replica thread runs), and no other device's ladder stands in
    (the JAX fleet's ``_ladder_for`` falls back to the default device). The
    failure is injected into the ladder constructor, the step that captures
    the graphs on the card."""
    from sheeprl_tpu_torch.serve import model

    real = model.CompiledLadder.__init__
    built = []

    def capture_fails_on_slot_1(self, policy, ladder, forward, stream=None, device=None):
        built.append(device)
        if len(built) == 2:
            raise RuntimeError("injected capture failure")
        real(self, policy, ladder, forward, stream, device)

    monkeypatch.setattr(model.CompiledLadder, "__init__", capture_fails_on_slot_1)
    server, _, _ = make_fleet()
    with pytest.raises(RuntimeError, match="injected capture failure"):
        server.start()
    assert len(built) == 2 and server.store is None
    assert not any(s.alive for s in server.slots)


def test_a_failed_standby_capture_leaves_the_slot_on_standby(make_fleet, monkeypatch):
    from sheeprl_tpu_torch.serve import model

    server, _, state = make_fleet(fleet={"num_replicas": 1, "max_replicas": 2})
    server.start()

    def fails(*args, **kwargs):
        raise RuntimeError("injected capture failure")

    monkeypatch.setattr(model.CompiledLadder, "__init__", fails)
    with pytest.raises(RuntimeError, match="injected capture failure"):
        server._activate(server.slots[1], {})
    assert not server.slots[1].active and not server.slots[1].alive
    assert not server.store.has_graphs(1) and server.store.current.ladders[1] is None
    obs = linear_obs(state)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)


def test_restart_waits_for_the_previous_incarnation_to_leave_the_slot(make_fleet):
    """While a slot's graphs are held (a hung incarnation inside them), its
    restart is deferred, not doubled up; it respawns once they are free."""
    server, _, state = make_fleet(fleet={"num_replicas": 2, "max_replicas": 2})
    server.start()
    lock = server.store._slot_locks[0]
    lock.acquire()  # an abandoned incarnation still inside slot 0's graphs
    try:
        server.kill_replica(0)
        assert _wait_until(lambda: server.slots[0].restart_deferrals >= 1, timeout_s=5.0)
        assert not server.slots[0].alive
        assert server.snapshot()["events"].get("replica_restart_deferred") == 1
    finally:
        lock.release()
    assert _wait_until(lambda: server.slots[0].alive, timeout_s=5.0)
    obs = linear_obs(state)
    np.testing.assert_allclose(server.infer(obs), expected_action(state, obs), rtol=1e-5)


@pytest.mark.parametrize("how", ["retired", "masked"])
def test_work_landing_on_a_retired_or_masked_slot_is_rehomed(make_fleet, how):
    """The router ranks targets, then offers: a slot retired or masked (and
    drained) in between can still receive the request. The monitor re-homes
    such stranded work to a live sibling, where it is served."""
    from sheeprl_tpu_torch.serve.batching import Request

    server, _, state = make_fleet(max_restarts=0, restart_refund_s=None, fleet={"num_replicas": 2, "min_replicas": 1, "max_replicas": 2})
    server.start()
    slot = server.slots[1]
    if how == "retired":
        slot.retiring, slot.active = True, False
        slot.thread.request_stop()
    else:
        server.kill_replica(1)
        assert _wait_until(lambda: slot.masked)
    assert _wait_until(lambda: not slot.alive)
    now = time.monotonic()
    obs = linear_obs(state, 0.75)
    req = Request(obs, now, now + 10.0)
    assert slot.pool.offer(req)  # the late placement
    np.testing.assert_allclose(req.future.result(timeout=5.0), expected_action(state, obs), rtol=1e-5)
    assert _wait_until(lambda: slot.pool.outstanding() == 0)
    assert server.snapshot()["events"].get("reroute", 0) >= 1


def test_the_fleet_cli_asks_for_the_card_unless_given_the_cpu(tmp_path, monkeypatch):
    """``serve ... serve.fleet.enabled=true`` without
    ``fabric.accelerator=cpu`` asks for the CUDA card: without one it
    raises, no CPU fallback (the spill slots' CPU is configuration, not a
    fallback)."""
    import json

    import torch

    from sheeprl_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "config.yaml").write_text(json.dumps({"algo": {"name": "linear"}, "seed": 1, "fabric": {"accelerator": "cpu"}}))
    path, _ = commit_linear(str(tmp_path / "checkpoint"), 5)
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.run(["serve", f"checkpoint_path={path}", "serve.fleet.enabled=true", "serve.fleet.cpu_spill_replicas=1", "serve.load.enabled=true"])


def test_fleet_refuses_what_is_not_ported(make_fleet):
    with pytest.raises(NotImplementedError, match="A10"):
        make_fleet(fleet={"remote_agents": ["localhost:1"]})
    with pytest.raises(NotImplementedError, match="A10"):
        make_fleet(aot_cache_dir="/nonexistent")


# ----------------------------------------------------------- the JAX fleet ----


def _jax_fleet(ckpt_path, node):
    from sheeprl_tpu.serve.config import serve_config_from_cfg as jax_cfg
    from sheeprl_tpu.serve.fleet import FleetServer as JaxFleet
    from sheeprl_tpu.serve.policy import build_linear_policy as jax_linear
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as jax_load

    policy = jax_linear({"algo": {"name": "linear"}}, jax_load(ckpt_path))
    return JaxFleet(policy, jax_cfg({"serve": node}), step=100, path=ckpt_path)


def test_answers_match_the_jax_fleet(tmp_path):
    """Both fleets serve the checkpoint the JAX tests commit (JAX's
    ``build_manifest`` + ``save_checkpoint``); each package loads it with its
    own ``load_checkpoint``. 64 seeded observations, each through both
    fleets (single requests and concurrent bursts): equal within
    ``ANSWER_TOL``."""
    from sheeprl_tpu.resilience.manifest import build_manifest as jax_manifest
    from sheeprl_tpu.serve.policy import make_linear_state as jax_state
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.fleet import FleetServer
    from sheeprl_tpu_torch.serve.policy import build_linear_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    os.makedirs(tmp_path / "checkpoint")
    path = str(tmp_path / "checkpoint" / "ckpt_100_0.ckpt")
    state = jax_state(seed=3)
    jax_save(path, state, backend="pickle", manifest=jax_manifest(step=100, backend="pickle", world_size=1, state=state))
    node = {**DRILL_SERVE, "fleet": dict(DRILL_FLEET)}
    port = FleetServer(build_linear_policy({}, load_checkpoint(path), device="cpu"), serve_config_from_cfg({"serve": node}), step=100, path=path)
    jax = _jax_fleet(path, node)
    rng = np.random.default_rng(0)
    obs = [{"vector": rng.standard_normal(4).astype(np.float32)} for _ in range(64)]
    try:
        port.start()
        jax.start()
        got = {}
        for name, server in (("port", port), ("jax", jax)):
            single = [np.asarray(server.infer(o)) for o in obs[:16]]
            reqs = [server.submit(o, 10.0) for o in obs[16:]]
            got[name] = np.stack(single + [np.asarray(server.wait(r)) for r in reqs])
    finally:
        port.close()
        jax.close()
    assert got["port"].shape == got["jax"].shape == (64, 2)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=ANSWER_TOL)


def _scripted_targets(pkg, rng, n_targets):
    """``n_targets`` pools with seeded depths (slot window and backlog),
    healths and kinds, over requests of ``pkg``'s own ``Request``."""
    now = time.monotonic()
    pools, healths, kinds = [], [], []
    for i in range(n_targets):
        pool = pkg.slots.SlotPool(capacity=int(rng.integers(1, 5)), backlog_bound=64)
        for _ in range(int(rng.integers(0, 9))):
            pool.offer(pkg.batching.Request(None, now, now + FAR))
        if rng.random() < 0.3:
            pool.take_batch(0.0)  # some of it in flight
        pools.append(pool)
        healths.append(float(rng.choice([0.0, 0.05, 0.3, 0.7, 1.0])))
        kinds.append("cpu_spill" if rng.random() < 0.3 else "device")
    return lambda: [pkg.router.RouteTarget(i, p, h, k) for i, (p, h, k) in enumerate(zip(pools, healths, kinds))]


@pytest.mark.parametrize("seed", range(8))
def test_ranked_targets_match_the_jax_router(seed):
    """For the same scripted fleet state (pool depths, healths, kinds) and
    request (priority, earlier placements), the port's router ranks the
    targets in exactly the JAX router's order."""
    orders = {}
    for name in PACKAGES:
        pkg = SimpleNamespace(
            batching=importlib.import_module(f"{name}.serve.batching"),
            router=importlib.import_module(f"{name}.serve.router"),
            slots=importlib.import_module(f"{name}.serve.slots"),
        )
        rng = np.random.default_rng(seed)
        targets = _scripted_targets(pkg, rng, int(rng.integers(2, 7)))
        router = pkg.router.Router(targets=targets, max_pending=10_000, slo_s=0.1, spill_depth=int(rng.integers(0, 4)))
        order = []
        for _ in range(12):
            now = time.monotonic()
            priority = pkg.router.BATCH if rng.random() < 0.5 else pkg.router.INTERACTIVE
            req = pkg.router.RoutedRequest(None, now, now + FAR, priority=priority)
            req.placements = [int(i) for i in rng.choice(len(targets()), size=int(rng.integers(0, 2)), replace=False)]
            order.append([t.index for t in router._ranked_targets(req)])
        order.append([t.index for t in router._ranked_targets_any()])
        orders[name] = order
    assert orders["sheeprl_tpu_torch"] == orders["sheeprl_tpu"]


@pytest.mark.parametrize("samples", [0, 15, 16, 100, 2048, 3000])
def test_hedge_threshold_matches_the_jax_router(samples):
    """The same completed-latency history (seeded, past the reservoir's
    wrap at the largest count) gives the same hedge threshold, at several
    quantiles and floors."""
    rng = np.random.default_rng(samples)
    lats = rng.exponential(0.02, size=samples).tolist()
    for quantile, floor in ((0.95, 0.0), (0.5, 0.01), (1.0, 0.0), (0.99, 0.5)):
        got = {}
        for name in PACKAGES:
            router_mod = importlib.import_module(f"{name}.serve.router")
            router = router_mod.Router(targets=lambda: [], max_pending=1, slo_s=0.1, hedge_quantile=quantile, hedge_floor_s=floor)
            for lat in lats:
                router.record_latency(lat)
            got[name] = router.hedge_threshold_s()
        assert got["sheeprl_tpu_torch"] == got["sheeprl_tpu"], (quantile, floor)


@pytest.mark.parametrize(
    "fleet",
    [
        {},
        {"num_replicas": 2, "max_replicas": 4, "cpu_spill_replicas": 1, "backlog_per_replica": 8},
        {"max_pending": 5},
        {"num_replicas": 3, "max_replicas": 3, "remote_agents": ["h:1", "h:2"]},
    ],
)
def test_resolved_max_pending_matches_the_jax_fleet(fleet):
    bounds = []
    for name in PACKAGES:
        cfg = importlib.import_module(f"{name}.serve.config").serve_config_from_cfg(
            {"serve": {"batch_ladder": [1, 2, 4, 8], "fleet": {"enabled": True, **fleet}}}
        )
        bounds.append(cfg.fleet.resolved_max_pending(cfg))
    assert bounds[0] == bounds[1]


def _pool_script(name, seed):
    """One single-threaded run of seeded pool operations against ``name``'s
    SlotPool with staging on; each step's outcome in creation indices (the
    two packages number their requests apart)."""
    batching = importlib.import_module(f"{name}.serve.batching")
    slots = importlib.import_module(f"{name}.serve.slots")
    router = importlib.import_module(f"{name}.serve.router")
    if name == "sheeprl_tpu":
        import jax

        spec = {"vector": jax.ShapeDtypeStruct((3,), np.float32)}
    else:
        spec = {"vector": ((3,), np.dtype(np.float32))}
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([1, 2, 4]))
    pool = slots.SlotPool(capacity=cap, backlog_bound=int(rng.integers(2, 8)), obs_spec=spec)
    made, index = [], {}
    inflight = []
    log = []

    def new_req():
        now = time.monotonic()
        k = len(made)
        req = router.RoutedRequest({"vector": np.full((3,), float(k), np.float32)}, now, now + FAR, idempotent=bool(rng.random() < 0.7))
        made.append(req)
        index[req.rid] = k
        return req

    ids = lambda reqs: [index[r.rid] for r in reqs]  # noqa: E731
    for _ in range(int(rng.integers(30, 70))):
        op = rng.random()
        if op < 0.45:
            log.append(("offer", pool.offer(new_req(), front=bool(rng.random() < 0.1))))
        elif op < 0.65:
            batch = pool.take_batch(0.0)
            if batch:
                staged = pool.staged_batch(batch, cap)
                log.append(("take", ids(batch), np.asarray(staged["vector"])[:, 0].tolist()))
                inflight.append(batch)
            else:
                log.append(("take", []))
        elif op < 0.8 and inflight:
            batch = inflight.pop(int(rng.integers(0, len(inflight))))
            if rng.random() < 0.7:
                for r in batch:
                    slots.safe_complete(r, "ok")
                pool.complete_batch(batch)
                log.append(("complete", ids(batch)))
            else:
                pool.requeue_failed(batch)
                log.append(("requeue", ids(batch)))
        elif op < 0.88:
            scope = str(rng.choice(["all", "idempotent", "none"]))
            drained = pool.drain(inflight=scope)
            log.append(("drain", scope, ids(drained)))
            if drained and rng.random() < 0.5:
                pool.offer_front(drained)
                log.append(("offer_front", ids(drained)))
        elif op < 0.95 and made:
            victim = made[int(rng.integers(0, len(made)))]
            log.append(("cancel", index[victim.rid], slots.safe_complete(victim, "twin")))
        log.append(("depth", pool.depth(), pool.outstanding()))
    pool.close()
    return log


@pytest.mark.parametrize("seed", range(10))
def test_slot_pool_sequences_match_the_jax_pool(seed):
    """The same seeded operations (offers, some at the front, dispatches
    with their staged rows, completions, failed-dispatch requeues, drains
    in each ``inflight`` scope, re-route blocks, hedge-twin cancellations)
    give the same outcome at every step on both pools."""
    assert _pool_script("sheeprl_tpu_torch", seed) == _pool_script("sheeprl_tpu", seed)


# ----------------------------------------------------------------- router ----


def _pools(pkg, n, capacity=4):
    return [pkg.slots.SlotPool(capacity=capacity, backlog_bound=64) for _ in range(n)]


def _targets(pkg, pools, healths=None, kinds=None):
    healths = healths or [1.0] * len(pools)
    kinds = kinds or ["device"] * len(pools)
    return lambda: [pkg.router.RouteTarget(i, p, h, k) for i, (p, h, k) in enumerate(zip(pools, healths, kinds))]


def test_router_health_weighted_least_loaded(pkg):
    pools = _pools(pkg, 3)
    now = time.monotonic()
    for _ in range(2):
        pools[0].offer(pkg.batching.Request(None, now, now + 60.0))
    pools[1].offer(pkg.batching.Request(None, now, now + 60.0))
    router = pkg.router.Router(targets=_targets(pkg, pools, [1.0, 0.1, 1.0]), max_pending=100, slo_s=0.1)
    req = router.submit(None, 60.0)
    assert req.placements == [2]  # least loaded wins outright
    # the sick-but-emptier pool 1 (1/0.1 = 10) loses to the healthy-but-
    # busier pool 0 (2/1.0 = 2)
    for _ in range(3):
        pools[2].offer(pkg.batching.Request(None, now, now + 60.0))
    assert router.submit(None, 60.0).placements == [0]
    router.close()


def test_hedged_retry_first_completion_wins(pkg):
    pools = _pools(pkg, 2)
    router = pkg.router.Router(targets=_targets(pkg, pools), max_pending=100, slo_s=0.02, hedge_scan_s=0.002).start()
    req = router.submit(np.float32(7.0), 60.0)
    assert req.placements == [0]
    assert _wait_until(lambda: req.hedges == 1, timeout_s=5.0)
    assert req.placements == [0, 1]
    batch = pools[1].take_batch(1.0)
    assert [r.rid for r in batch] == [req.rid]
    assert pkg.slots.safe_complete(batch[0], "served-by-1")
    pools[1].complete_batch(batch)
    assert req.future.result(timeout=1.0) == "served-by-1"
    assert pools[0].take_batch(0.05) == []  # the loser's copy is skipped
    assert _wait_until(lambda: router.hedged_won == 1, timeout_s=2.0)
    assert router.hedged == 1
    router.close()


def test_an_expiry_racing_a_twins_delivery_does_not_raise():
    """A hedged request expires at one pool's assembly while its twin is
    delivered on another replica: the late expiry must not raise out of the
    assembly (it would kill that replica's thread) and the answer stands."""
    from sheeprl_tpu_torch.serve.batching import Request

    req = Request(None, 0.0, 1.0)
    req.future.set_result("twin")
    req.future.done = lambda: False  # the twin's result lands after the check
    req.fail_expired(5.0)
    assert req.future.result(timeout=0) == "twin"


def test_hedged_twin_frees_its_staging_rows_in_both_pools():
    """A hedged request is staged in two pools at once; after the winner
    delivers, the loser is dropped at its pool's next assembly and both
    pools get every staging row back (the row-exhaustion collapse the JAX
    acceptance ramp found)."""
    from sheeprl_tpu_torch.serve.router import RouteTarget, Router
    from sheeprl_tpu_torch.serve.slots import SlotPool, safe_complete

    spec = {"vector": ((3,), np.dtype(np.float32))}
    pools = [SlotPool(capacity=2, backlog_bound=8, obs_spec=spec) for _ in range(2)]
    router = Router(targets=lambda: [RouteTarget(i, p, 1.0, "device") for i, p in enumerate(pools)], max_pending=100, slo_s=0.02, hedge_scan_s=0.002).start()
    try:
        for k in range(6):  # more twins than the 2 x 2 rows either pool has
            req = router.submit({"vector": np.full(3, float(k), np.float32)}, 60.0)
            assert _wait_until(lambda: req.hedges == 1, timeout_s=5.0)
            winner = pools[req.placements[1]]
            batch = winner.take_batch(1.0)
            assert winner.staged_batch(batch, 2)["vector"][0].tolist() == [float(k)] * 3
            assert safe_complete(batch[0], "ok")
            winner.complete_batch(batch)
            assert pools[req.placements[0]].take_batch(0.0) == []
            assert [p.free_rows() for p in pools] == [4, 4]
    finally:
        router.close()


def test_the_scan_never_places_a_request_submit_is_still_placing():
    """A request enters the in-flight map before ``submit`` offers it to a
    pool, and the scan rescues in-flight requests with no placement: while
    a slow offer is under way the scan must leave the request alone, or it
    would sit in two pools at once (a non-idempotent request served twice).
    The JAX router has this race; the port closes it."""
    from sheeprl_tpu_torch.serve.router import RouteTarget, Router
    from sheeprl_tpu_torch.serve.slots import SlotPool

    class SlowPool(SlotPool):
        def offer(self, req, *, front=False):
            time.sleep(0.05)  # 25 scan passes
            return super().offer(req, front=front)

    pools = [SlowPool(capacity=4, backlog_bound=8), SlotPool(capacity=4, backlog_bound=8)]
    router = Router(targets=lambda: [RouteTarget(i, p, 1.0, "device") for i, p in enumerate(pools)], max_pending=100, slo_s=60.0, hedge_scan_s=0.002).start()
    try:
        reqs = [router.submit(None, 60.0, idempotent=False) for _ in range(4)]
        time.sleep(0.02)
        assert [len(r.placements) for r in reqs] == [1, 1, 1, 1] and not any(r.routing for r in reqs)
        assert sum(p.outstanding() for p in pools) == 4 and pools[0].outstanding() >= 1
    finally:
        router.close()


def test_router_blackhole_rescued_by_scan(pkg):
    schedule = pkg.faults.ServeFaultSchedule(pkg.faults.parse_serve_faults([{"kind": "router_blackhole", "at_request": 0, "duration_s": 0.05}]))
    pools = _pools(pkg, 2)
    router = pkg.router.Router(targets=_targets(pkg, pools), max_pending=100, slo_s=60.0, hedge_scan_s=0.002, fault_schedule=schedule).start()
    req = router.submit(None, 60.0)
    assert req.placements == []  # swallowed at the front door
    assert router.blackholed == 1
    assert _wait_until(lambda: req.placements != [], timeout_s=5.0)  # rescued
    assert pools[req.placements[0]].outstanding() == 1
    router.close()


def test_reroute_at_front_lands_on_healthiest_sibling(pkg):
    pools = _pools(pkg, 3, capacity=2)
    now = time.monotonic()
    pools[2].offer(pkg.batching.Request(None, now, now + 60.0))  # sibling 2 is busier
    router = pkg.router.Router(targets=_targets(pkg, pools), max_pending=100, slo_s=60.0)
    victims = [router.submit(None, 60.0) for _ in range(2)]
    assert all(v.placements in ([1], [0]) for v in victims)
    dead = victims[0].placements[0]
    moved = router.reroute(dead, pools[dead], "drill")
    survivors = [v for v in victims if v.placements[0] == dead]
    assert moved == len(survivors)
    for v in survivors:
        assert v.rerouted == 1 and v.placements[-1] not in (dead, 2)
    assert router.rerouted_requests == moved
    router.close()


def test_stale_incarnation_cannot_clobber_live_inflight_window(pkg):
    pool = pkg.slots.SlotPool(capacity=2, backlog_bound=8)
    now = time.monotonic()
    a, b = pkg.batching.Request(None, now, now + 60.0), pkg.batching.Request(None, now, now + 60.0)
    pool.offer(a), pool.offer(b)
    stale = pool.take_batch(0.0)
    assert [r.rid for r in stale] == [a.rid, b.rid]
    assert [r.rid for r in pool.drain()] == [a.rid, b.rid]
    c = pkg.batching.Request(None, now, now + 60.0)
    pool.offer(c)
    assert [r.rid for r in pool.take_batch(0.0)] == [c.rid]
    pool.complete_batch(stale)  # stale thread wakes late: releases nothing
    assert pool.outstanding() == 1
    pool.requeue_failed(stale)  # ...and requeues nothing it no longer owns
    assert pool.depth() == 0 and pool.outstanding() == 1
    assert [r.rid for r in pool.drain()] == [c.rid]


def test_drain_scopes_inflight_by_executor_liveness(pkg):
    pool = pkg.slots.SlotPool(capacity=4, backlog_bound=8)
    now = time.monotonic()
    idem = pkg.router.RoutedRequest(None, now, now + 60.0, idempotent=True)
    nonidem = pkg.router.RoutedRequest(None, now, now + 60.0, idempotent=False)
    pool.offer(idem), pool.offer(nonidem)
    assert len(pool.take_batch(0.0)) == 2
    queued = pkg.router.RoutedRequest(None, now, now + 60.0, idempotent=False)
    pool.offer(queued)
    assert [r.rid for r in pool.drain(inflight="none")] == [queued.rid]
    assert pool.outstanding() == 2
    assert [r.rid for r in pool.drain(inflight="idempotent")] == [idem.rid]
    assert pool.outstanding() == 1
    assert [r.rid for r in pool.drain()] == [nonidem.rid]
    assert pool.outstanding() == 0


def test_router_expires_unplaced_requests_at_deadline(pkg):
    errors = importlib.import_module(f"{pkg.name}.serve.errors")
    schedule = pkg.faults.ServeFaultSchedule(pkg.faults.parse_serve_faults([{"kind": "router_blackhole", "at_request": 0, "duration_s": 30.0}]))
    router = pkg.router.Router(targets=_targets(pkg, _pools(pkg, 2)), max_pending=100, slo_s=60.0, hedge_scan_s=0.002, fault_schedule=schedule).start()
    req = router.submit(None, 0.05)
    assert req.placements == []
    with pytest.raises(errors.DeadlineExceeded):
        req.future.result(timeout=5.0)
    assert _wait_until(lambda: router.inflight_count() == 0, timeout_s=5.0)
    assert router.expired == 1
    router.close()


def test_admission_bound_counts_unplaced_inflight(pkg):
    errors = importlib.import_module(f"{pkg.name}.serve.errors")
    schedule = pkg.faults.ServeFaultSchedule(pkg.faults.parse_serve_faults([{"kind": "router_blackhole", "at_request": 0, "duration_s": 30.0}]))
    router = pkg.router.Router(targets=_targets(pkg, _pools(pkg, 2)), max_pending=2, slo_s=60.0, fault_schedule=schedule).start()
    for _ in range(2):
        assert router.submit(None, 60.0).placements == []
    assert router.unplaced_inflight() == 2
    with pytest.raises(errors.Overloaded):
        router.submit(None, 60.0)
    router.close()


def test_hedge_scan_reports_its_lag():
    from sheeprl_tpu_torch.serve.router import Router

    router = Router(targets=lambda: [], max_pending=1, slo_s=0.1, hedge_scan_s=0.002).start()
    try:
        assert _wait_until(lambda: router.scan_lag_ms()["passes"] >= 5)
    finally:
        router.close()
    lag = router.snapshot()["scan_lag_ms"]
    assert 0.0 <= lag["p50"] <= lag["p95"] <= lag["max"]


# --------------------------------------------------------------- ordering ----


def _req(pkg):
    now = time.monotonic()
    return pkg.batching.Request(None, now, now + FAR)


def _dispatch_all(pkg, pool):
    order = []
    while pool.depth() or pool.outstanding():
        batch = pool.take_batch(0.0)
        if not batch:
            break
        order.extend(batch)
        for req in batch:
            pkg.slots.safe_complete(req, "ok")
        pool.complete_batch(batch)
    return order


def test_admission_order_is_dispatch_order_across_interleavings(pkg):
    import random

    for seed in range(25):
        rng = random.Random(seed)
        pool = pkg.slots.SlotPool(capacity=rng.choice([1, 2, 4]), backlog_bound=128)
        admitted, dispatched = [], []
        for _ in range(rng.randrange(20, 60)):
            if rng.random() < 0.6:
                req = _req(pkg)
                assert pool.offer(req)
                admitted.append(req)
            else:
                batch = pool.take_batch(0.0)
                dispatched.extend(batch)
                for req in batch:
                    pkg.slots.safe_complete(req, "ok")
                pool.complete_batch(batch)
        dispatched.extend(_dispatch_all(pkg, pool))
        assert [r.rid for r in dispatched] == [r.rid for r in admitted], f"seed {seed}"
        assert all(r.future.result(timeout=0) == "ok" for r in admitted)
        pool.close()


def test_staging_survives_admission_during_inflight_batch():
    """Continuous batching admits into slots while the previous dispatch
    still holds its staged rows — the pool stages BOTH windows at once, and
    the assembly writes them into the caller's staging (a rung's host
    buffers) with the padding rows zeroed."""
    import random

    from sheeprl_tpu_torch.serve.batching import Request
    from sheeprl_tpu_torch.serve.slots import SlotPool, safe_complete

    spec = {"vector": ((3,), np.dtype(np.float32))}
    for seed in range(25):
        rng = random.Random(seed)
        cap = rng.choice([1, 2, 4])
        pool = SlotPool(capacity=cap, backlog_bound=64, obs_spec=spec)
        host = {"vector": np.full((cap, 3), -1.0, np.float32)}  # a rung's staging, dirty
        value = {}

        def req():
            now = time.monotonic()
            r = Request({"vector": np.full((3,), float(len(value)), np.float32)}, now, now + FAR)
            value[r.rid] = float(len(value))
            return r

        def check(batch):
            out = pool.staged_batch(batch, cap, out=host)
            assert out is host
            assert host["vector"][: len(batch), 0].tolist() == [value[r.rid] for r in batch], f"seed {seed}"
            assert not host["vector"][len(batch) :].any(), f"seed {seed}: padding not zeroed"
            for r in batch:
                safe_complete(r, "ok")
            pool.complete_batch(batch)

        inflight = []
        for _ in range(rng.randrange(20, 60)):
            roll = rng.random()
            if roll < 0.55:
                pool.offer(req())
            elif roll < 0.8 and not inflight:
                inflight = pool.take_batch(0.0)
            elif inflight:
                check(inflight)
                inflight = []
        while inflight or pool.depth():
            if not inflight:
                inflight = pool.take_batch(0.0)
            check(inflight)
            inflight = []
        assert pool.free_rows() == 2 * cap
        pool.close()


def test_crash_reroute_at_front_never_reorders_drops_or_expires(pkg):
    import random

    for seed in range(25):
        rng = random.Random(seed)
        pool_a = pkg.slots.SlotPool(capacity=rng.choice([2, 4]), backlog_bound=128)
        pool_b = pkg.slots.SlotPool(capacity=rng.choice([2, 4]), backlog_bound=128)
        admitted = {id(pool_a): [], id(pool_b): []}
        dispatched_b = []
        for _ in range(rng.randrange(10, 40)):
            pool = rng.choice([pool_a, pool_b])
            req = _req(pkg)
            assert pool.offer(req)
            admitted[id(pool)].append(req)
            if rng.random() < 0.2:
                batch = pool_b.take_batch(0.0)
                dispatched_b.extend(batch)
                for r in batch:
                    pkg.slots.safe_complete(r, "ok")
                pool_b.complete_batch(batch)
        pool_a.take_batch(0.0)  # A dies holding this window
        drained = pool_a.drain()
        assert [r.rid for r in drained] == [r.rid for r in admitted[id(pool_a)]], f"seed {seed}"
        pool_b.offer_front(drained)
        post = []
        for _ in range(rng.randrange(0, 15)):
            req = _req(pkg)
            assert pool_b.offer(req)
            post.append(req)
        rids = [r.rid for r in dispatched_b + _dispatch_all(pkg, pool_b)]
        everything = admitted[id(pool_a)] + admitted[id(pool_b)] + post
        assert sorted(rids) == sorted(r.rid for r in everything), f"seed {seed}"
        for source in (admitted[id(pool_a)], admitted[id(pool_b)], post):
            want = [r.rid for r in source]
            assert [rid for rid in rids if rid in set(want)] == want, f"seed {seed}"
        if admitted[id(pool_a)] and post:
            last_a = max(rids.index(r.rid) for r in admitted[id(pool_a)])
            first_post = min(rids.index(r.rid) for r in post)
            assert last_a < first_post, f"seed {seed}: re-route fell behind later admissions"
        for req in everything:
            assert req.future.result(timeout=0) == "ok", f"seed {seed}: rid {req.rid} expired"
        pool_a.close()
        pool_b.close()


# ------------------------------------------------------------- chaos ramp ----


@pytest.mark.slow
def test_chaos_ramp_kill_mid_ramp_holds_slo_on_survivors(make_fleet):
    """A 4-replica fleet under a stepped saturation ramp; one replica is
    killed as the second step begins. Zero admitted requests are dropped or
    expired, the ramp still finds a knee, and the surviving N-1 fleet holds
    the SLO."""
    from sheeprl_tpu_torch.serve.config import LoadConfig
    from sheeprl_tpu_torch.serve.loadgen import run_ramp

    server, _, _ = make_fleet(
        slo_ms=500.0,
        max_restarts=0,
        restart_refund_s=None,
        fleet={"num_replicas": 4, "min_replicas": 4, "max_replicas": 4, "max_pending": 10_000},
    )
    server.start()
    assert server.snapshot()["replicas_alive"] == 4
    killed = []

    def on_step(step, rate):
        if step == 1:
            killed.append(server.kill_replica(0))

    report = run_ramp(
        server,
        LoadConfig(enabled=True, duration_s=1.0, concurrency=8, max_retries=5, seed=0),
        rates_hz=[60.0, 100.0, 160.0],
        step_duration_s=0.6,
        on_step=on_step,
    )
    assert killed == [True]
    assert sum(s["expired"] for s in report["steps"]) == 0 and sum(s["errors"] for s in report["steps"]) == 0
    assert report["knee_rate_hz"] is not None and report["max_good_qps"] > 0
    snap = server.snapshot()
    assert snap["replicas_alive"] == 3
    assert snap["shed_expired"] == 0 and snap["failed"] == 0
    assert snap["p95_ms"] is not None and snap["p95_ms"] <= server.config.slo_ms


def test_trace_cli_reads_the_ports_stream(tmp_path):
    """``python -m tools.trace summary`` (the repo's stdlib merger, in its
    own process) over a standalone port trace: one chain per request."""
    from sheeprl_tpu_torch.obs.trace import configure_trace, shutdown_trace
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.fleet import FleetServer
    from sheeprl_tpu_torch.serve.policy import build_linear_policy

    path, state = commit_linear(str(tmp_path / "checkpoint"), 100)
    trace_path = str(tmp_path / "trace.serve.jsonl")
    configure_trace("serve", trace_path)
    try:
        node = {**DRILL_SERVE, "fleet": dict(DRILL_FLEET)}
        with FleetServer(build_linear_policy({}, state, device="cpu"), serve_config_from_cfg({"serve": node}), step=100, path=path) as server:
            for i in range(10):
                server.infer(linear_obs(state, float(i)))
    finally:
        shutdown_trace()
    proc = subprocess.run([sys.executable, "-m", "tools.trace", "summary", trace_path], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    summary = json.loads(proc.stdout)
    assert summary["requests"]["traces"] == 10 and summary["requests"]["terminals"] == {"request_done": 10}
    assert summary["processes"][0]["role"] == "serve"
