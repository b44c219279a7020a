"""The serving tier's pure-Python parts, one test body over both packages:
the micro-batcher (bounded admission with typed shedding, the gather
window, closing at the top rung, expiry at assembly, front-of-queue
requeue, close), the serve config (SLO-derived knobs, validation, node
parsing, the fleet node's defaults), the fault specs and their fire-once
schedule, the retrying client and the restart budget. Each case runs the
JAX package's module and then the port's (``sheeprl_tpu.serve`` and
``sheeprl_tpu_torch.serve``), so the same assertions hold for both; the
bodies are the JAX package's own tests (tests/test_serve/test_batching.py,
test_config.py, test_client.py, tests/test_rollout/test_units.py)."""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ["sheeprl_tpu", "sheeprl_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    mod = lambda name: importlib.import_module(f"{request.param}.{name}")  # noqa: E731
    return SimpleNamespace(
        name=request.param,
        batching=mod("serve.batching"),
        config=mod("serve.config"),
        errors=mod("serve.errors"),
        faults=mod("serve.fault_injection"),
        client=mod("serve.client"),
        supervisor=mod("rollout.supervisor"),
    )


def _batcher(pkg, max_queue=4, window=0.01, on_shed=None, clock=None):
    kw = {"max_queue": max_queue, "gather_window_s": window, "on_shed": on_shed}
    if clock is not None:
        kw["clock"] = clock
    return pkg.batching.MicroBatcher(**kw)


# --------------------------------------------------------------------------- #
# MicroBatcher
# --------------------------------------------------------------------------- #


def test_admission_bound_sheds_typed_and_immediately(pkg):
    shed = []
    b = _batcher(pkg, max_queue=2, on_shed=shed.append)
    b.submit({"x": 1}, deadline_s=10.0)
    b.submit({"x": 2}, deadline_s=10.0)
    t0 = time.monotonic()
    with pytest.raises(pkg.errors.Overloaded) as err:
        b.submit({"x": 3}, deadline_s=10.0)
    assert time.monotonic() - t0 < 0.1
    assert err.value.depth == 2 and err.value.bound == 2
    assert err.value.retry_after_s > 0
    assert shed == ["overloaded"]
    assert b.depth() == 2


def test_next_batch_coalesces_up_to_max_within_window(pkg):
    b = _batcher(pkg, max_queue=16, window=0.02)
    for i in range(3):
        b.submit({"x": i}, deadline_s=10.0)
    batch = b.next_batch(max_batch=8, wait_timeout_s=0.5)
    assert [r.obs["x"] for r in batch] == [0, 1, 2]
    assert b.next_batch(max_batch=8, wait_timeout_s=0.01) == []


def test_next_batch_closes_at_top_rung_without_waiting_out_the_window(pkg):
    b = _batcher(pkg, max_queue=16, window=30.0)
    for i in range(4):
        b.submit({"x": i}, deadline_s=10.0)
    t0 = time.monotonic()
    batch = b.next_batch(max_batch=4, wait_timeout_s=0.5)
    assert len(batch) == 4
    assert time.monotonic() - t0 < 1.0
    assert b.depth() == 0


def test_expired_requests_fail_at_assembly_and_never_reach_the_model(pkg):
    shed = []
    b = _batcher(pkg, max_queue=8, on_shed=shed.append)
    dead = b.submit({"x": 0}, deadline_s=0.0)
    live = b.submit({"x": 1}, deadline_s=10.0)
    batch = b.next_batch(max_batch=8, wait_timeout_s=0.5)
    assert [r.rid for r in batch] == [live.rid]
    with pytest.raises(pkg.errors.DeadlineExceeded):
        dead.future.result(timeout=0)
    assert shed == ["expired"]
    assert live.served_step == -1  # stamped only by the replica that serves it


def test_requeue_front_of_queue_bypasses_admission_and_fails_expired(pkg):
    shed = []
    b = _batcher(pkg, max_queue=2, on_shed=shed.append)
    first = b.submit({"x": 0}, deadline_s=10.0)
    second = b.submit({"x": 1}, deadline_s=10.0)
    batch = b.next_batch(max_batch=8, wait_timeout_s=0.5)
    assert len(batch) == 2
    b.submit({"x": 2}, deadline_s=10.0)
    b.submit({"x": 3}, deadline_s=10.0)
    b.requeue(batch)
    assert b.depth() == 4
    nxt = b.next_batch(max_batch=8, wait_timeout_s=0.5)
    assert [r.obs["x"] for r in nxt[:2]] == [0, 1]
    assert all(r.attempts == 1 for r in (first, second))
    expired = b.submit({"x": 4}, deadline_s=0.0)
    b.next_batch(max_batch=8, wait_timeout_s=0.1)
    with pytest.raises(pkg.errors.DeadlineExceeded):
        expired.future.result(timeout=0)
    assert "expired" in shed


def test_close_fails_pending_and_refuses_new_work(pkg):
    b = _batcher(pkg)
    req = b.submit({"x": 0}, deadline_s=10.0)
    b.close()
    with pytest.raises(pkg.errors.ServerClosed):
        req.future.result(timeout=0)
    with pytest.raises(pkg.errors.ServerClosed):
        b.submit({"x": 1}, deadline_s=10.0)
    stranded = type(req)({"x": 2}, time.monotonic(), time.monotonic() + 10.0)
    b.requeue([stranded])
    with pytest.raises(pkg.errors.ServerClosed):
        stranded.future.result(timeout=0)


def test_submit_wakes_a_waiting_replica(pkg):
    b = _batcher(pkg, window=0.005)
    got = []

    def puller():
        got.extend(b.next_batch(max_batch=4, wait_timeout_s=2.0))

    t = threading.Thread(target=puller)
    t.start()
    time.sleep(0.05)
    b.submit({"x": 7}, deadline_s=10.0)
    t.join(2.0)
    assert not t.is_alive()
    assert [r.obs["x"] for r in got] == [7]


def test_the_request_path_types_are_the_same(pkg):
    errors = pkg.errors
    for name in ("Overloaded", "DeadlineExceeded", "ServerClosed", "InferenceFailed", "SwapRejected"):
        assert issubclass(getattr(errors, name), errors.ServeError)
    assert issubclass(errors.ServeError, RuntimeError)
    err = errors.Overloaded(3, 4, 0.01)
    assert (err.depth, err.bound, err.retry_after_s) == (3, 4, 0.01)
    assert "3/4" in str(err)


# --------------------------------------------------------------------------- #
# ServeConfig and the fault specs
# --------------------------------------------------------------------------- #


def test_slo_derives_gather_window_and_deadline(pkg):
    ServeConfig = pkg.config.ServeConfig
    cfg = ServeConfig(slo_ms=25.0)
    assert cfg.gather_window_s == pytest.approx(0.005)
    assert cfg.default_deadline_s == pytest.approx(0.1)
    assert ServeConfig(slo_ms=1000.0).gather_window_s == pytest.approx(0.010)
    explicit = ServeConfig(slo_ms=25.0, gather_window_ms=2.0, default_deadline_ms=50.0)
    assert explicit.gather_window_s == pytest.approx(0.002)
    assert explicit.default_deadline_s == pytest.approx(0.050)


def test_ladder_sorted_deduped_and_validated(pkg):
    ServeConfig = pkg.config.ServeConfig
    cfg = ServeConfig(batch_ladder=[8, 1, 4, 4, 2])
    assert cfg.batch_ladder == [1, 2, 4, 8]
    assert cfg.max_batch == 8
    with pytest.raises(ValueError, match="batch_ladder"):
        ServeConfig(batch_ladder=[])
    with pytest.raises(ValueError, match="batch_ladder"):
        ServeConfig(batch_ladder=[0, 2])
    with pytest.raises(ValueError, match="num_replicas"):
        ServeConfig(num_replicas=0)
    with pytest.raises(ValueError, match="max_queue"):
        ServeConfig(max_queue=0)


def test_restart_backoff_exponential_and_capped(pkg):
    cfg = pkg.config.ServeConfig(backoff_base_s=0.05, backoff_max_s=0.4)
    assert [cfg.backoff_s(n) for n in (1, 2, 3, 4, 10)] == [0.05, 0.1, 0.2, 0.4, 0.4]


def test_serve_config_from_cfg_reads_node_and_defaults(pkg):
    from_cfg = pkg.config.serve_config_from_cfg
    assert from_cfg({}).slo_ms == 100.0
    cfg = from_cfg(
        {
            "serve": {
                "slo_ms": 50,
                "max_queue": 8,
                "num_replicas": 3,
                "fault_injection": {"enabled": True, "faults": [{"kind": "replica_crash", "replica": 1, "at_batch": 5}]},
                "load": {"enabled": True, "duration_s": 2, "concurrency": 4},
            }
        }
    )
    assert cfg.slo_ms == 50.0 and cfg.max_queue == 8 and cfg.num_replicas == 3
    assert [f.kind for f in cfg.faults] == ["replica_crash"]
    assert cfg.load.enabled and cfg.load.duration_s == 2.0 and cfg.load.concurrency == 4


def test_both_packages_parse_a_serve_node_alike():
    """One node, every field: the two parsers give the same values (the
    fleet node and the fault specs' ``at_request`` included)."""
    from sheeprl_tpu.serve.config import serve_config_from_cfg as jax_from_cfg
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg

    node = {
        "batch_ladder": [4, 1],
        "slo_ms": 40,
        "gather_window_ms": 3,
        "max_queue": 9,
        "restart_refund_s": None,
        "swap_poll_s": 0.5,
        "fault_injection": {"enabled": True, "faults": [{"kind": "slow_inference", "at_batch": 2, "duration_s": 0.1, "for_batches": 3}]},
        "load": {"rate_hz": 100, "timeout_ms": 20, "ramp_steps": 3},
        "fleet": {"num_replicas": 2, "max_pending": 7, "hedge_floor_ms": None, "remote_agents": ["h:1"]},
    }
    jax_cfg, cfg = jax_from_cfg({"serve": node}), serve_config_from_cfg({"serve": node})
    for name in ("batch_ladder", "slo_ms", "gather_window_s", "default_deadline_s", "max_queue", "restart_refund_s", "swap_poll_s"):
        assert getattr(cfg, name) == getattr(jax_cfg, name), name
    assert vars(cfg.load) == vars(jax_cfg.load)
    assert vars(cfg.fleet) == vars(jax_cfg.fleet)
    assert [vars(f) for f in cfg.faults] == [vars(f) for f in jax_cfg.faults]
    # the port's composed tree carries the JAX tree's serve node
    composed = serve_config_from_cfg(compose("config", ["exp=ppo"]))
    assert vars(composed.load) == vars(jax_from_cfg(compose("config", ["exp=ppo"])).load)
    assert composed.batch_ladder == [1, 2, 4, 8] and composed.num_replicas == 2 and not composed.fleet.enabled


def test_faults_gated_by_enabled_flag(pkg):
    cfg = pkg.config.serve_config_from_cfg(
        {"serve": {"fault_injection": {"enabled": False, "faults": [{"kind": "replica_crash", "at_batch": 1}]}}}
    )
    assert cfg.faults == []


def test_fault_spec_validation(pkg):
    with pytest.raises(ValueError, match="kind"):
        pkg.faults.ServeFaultSpec(kind="segfault")
    with pytest.raises(ValueError, match="at_swap"):
        pkg.faults.ServeFaultSpec(kind="poison_swap", at_swap=0)
    with pytest.raises(ValueError, match="mapping"):
        pkg.faults.parse_serve_faults(["replica_crash@5"])
    with pytest.raises(ValueError, match="kind"):
        pkg.faults.parse_serve_faults([{"replica": 0}])


def test_router_blackhole_needs_the_fleet():
    """``router_blackhole`` acts on the fleet's router (the single server
    ignores it): the port parses it exactly as the JAX package does — the
    same specs from the same node, the same validation, and the router's
    schedule firing each fault once at its ``at_request``."""
    from sheeprl_tpu.serve import fault_injection as jax_faults
    from sheeprl_tpu_torch.serve import fault_injection as port_faults

    node = [
        {"kind": "router_blackhole", "at_request": 3, "duration_s": 0.2},
        {"kind": "ROUTER_BLACKHOLE", "at_request": 7},
        {"kind": "replica_crash", "replica": 1, "at_batch": 2},
    ]
    jax_specs, port_specs = jax_faults.parse_serve_faults(node), port_faults.parse_serve_faults(node)
    assert [vars(s) for s in port_specs] == [vars(s) for s in jax_specs]
    for mod in (jax_faults, port_faults):
        with pytest.raises(ValueError, match="at_request"):
            mod.ServeFaultSpec(kind="router_blackhole", at_request=-1)
    fired = []
    for mod, specs in ((jax_faults, jax_specs), (port_faults, port_specs)):
        sched = mod.ServeFaultSchedule(specs)
        fired.append([(i, [vars(f) for f in sched.router_faults(i)]) for i in range(10)])
        assert sched.batch_faults(0, 5) == [] and [f.kind for f in sched.batch_faults(1, 5)] == ["replica_crash"]
    assert fired[1] == fired[0]
    assert [i for i, faults in fired[1] if faults] == [3, 7]


def test_schedule_crash_fires_once_and_late(pkg):
    sched = pkg.faults.ServeFaultSchedule([pkg.faults.ServeFaultSpec(kind="replica_crash", replica=0, at_batch=3)])
    assert sched.batch_faults(1, 10) == []
    assert sched.batch_faults(0, 2) == []
    assert [f.kind for f in sched.batch_faults(0, 5)] == ["replica_crash"]
    assert sched.batch_faults(0, 6) == []
    assert not sched


def test_schedule_slow_window_then_expires(pkg):
    spec = pkg.faults.ServeFaultSpec(kind="slow_inference", replica=0, at_batch=2, duration_s=0.1, for_batches=3)
    sched = pkg.faults.ServeFaultSchedule([spec])
    assert sched.batch_faults(0, 1) == []
    for b in (2, 3, 4):
        assert [f.kind for f in sched.batch_faults(0, b)] == ["slow_inference"]
    assert sched.batch_faults(0, 5) == []
    assert not sched


def test_schedule_poison_swap_fires_once(pkg):
    sched = pkg.faults.ServeFaultSchedule([pkg.faults.ServeFaultSpec(kind="poison_swap", at_swap=2)])
    assert not sched.poison_swap(1)
    assert sched.poison_swap(2)
    assert not sched.poison_swap(3)


# --------------------------------------------------------------------------- #
# ServeClient (duck-typed over the server)
# --------------------------------------------------------------------------- #


class _ScriptedServer:
    """infer() raises the scripted exceptions in order, then returns."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def infer(self, obs, deadline_s=None):
        self.calls += 1
        if self.script:
            raise self.script.pop(0)
        return {"action": 1}


def test_client_retries_overloaded_with_backoff_then_succeeds(pkg):
    over = lambda: pkg.errors.Overloaded(4, 4, retry_after_s=0.001)  # noqa: E731
    server = _ScriptedServer([over(), over()])
    client = pkg.client.ServeClient(server, max_retries=3, seed=0)
    assert client.infer({"x": 1}) == {"action": 1}
    assert server.calls == 3
    assert client.retries == 2 and client.rejected == 2


def test_client_gives_up_after_max_retries(pkg):
    server = _ScriptedServer([pkg.errors.Overloaded(4, 4, retry_after_s=0.001) for _ in range(10)])
    client = pkg.client.ServeClient(server, max_retries=2, seed=0)
    with pytest.raises(pkg.errors.Overloaded):
        client.infer({"x": 1})
    assert server.calls == 3
    assert client.rejected == 3


@pytest.mark.parametrize("terminal", ["deadline", "closed"])
def test_client_does_not_retry_terminal_failures(pkg, terminal):
    err = pkg.errors.DeadlineExceeded(0.5, 0.5) if terminal == "deadline" else pkg.errors.ServerClosed("down")
    server = _ScriptedServer([err])
    client = pkg.client.ServeClient(server, max_retries=3, seed=0)
    with pytest.raises(type(err)):
        client.infer({"x": 1})
    assert server.calls == 1 and client.retries == 0


def test_client_never_backs_off_past_its_own_deadline(pkg):
    server = _ScriptedServer([pkg.errors.Overloaded(4, 4, retry_after_s=10.0) for _ in range(5)])
    client = pkg.client.ServeClient(server, max_retries=5, timeout_s=0.05, seed=0)
    with pytest.raises(pkg.errors.Overloaded):
        client.infer({"x": 1})
    assert client.retries == 0


# --------------------------------------------------------------------------- #
# RestartBudget
# --------------------------------------------------------------------------- #


def test_restart_budget_fixed_cap_without_refund(pkg):
    budget = pkg.supervisor.RestartBudget(max_restarts=2, refund_after_s=None)
    assert not budget.exhausted
    assert budget.charge() == 1
    assert budget.charge() == 2
    assert budget.exhausted


def test_restart_budget_healthy_window_refunds(pkg):
    now = [0.0]
    budget = pkg.supervisor.RestartBudget(max_restarts=2, refund_after_s=100.0, clock=lambda: now[0])
    assert budget.charge() == 1
    assert budget.charge() == 2
    assert budget.exhausted
    now[0] = 101.0
    assert not budget.exhausted
    assert budget.used == 1
    assert budget.charge() == 2
    now[0] = 301.0
    assert not budget.exhausted
    assert budget.used == 0


def test_restart_budget_refund_keeps_window_remainder(pkg):
    now = [0.0]
    budget = pkg.supervisor.RestartBudget(max_restarts=3, refund_after_s=100.0, clock=lambda: now[0])
    budget.charge()
    budget.charge()
    now[0] = 150.0
    assert not budget.exhausted
    assert budget.used == 1
    now[0] = 200.0
    assert not budget.exhausted
    assert budget.used == 0


def test_restart_budget_clustered_faults_still_mask(pkg):
    now = [0.0]
    budget = pkg.supervisor.RestartBudget(max_restarts=2, refund_after_s=100.0, clock=lambda: now[0])
    budget.charge()
    now[0] = 50.0
    budget.charge()
    now[0] = 99.0
    assert budget.exhausted
