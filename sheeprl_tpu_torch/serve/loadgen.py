"""Scripted load generator: the measurable proxy for production traffic
(port of ``sheeprl_tpu/serve/loadgen.py``, the same report keys).

Runs ``concurrency`` client threads against a started
:class:`~sheeprl_tpu_torch.serve.server.PolicyServer` or
:class:`~sheeprl_tpu_torch.serve.fleet.FleetServer` for ``duration_s``:

- **closed-loop** (default, ``rate_hz == 0``): each client fires its next
  request as soon as the previous one resolves — the classic
  concurrency-bounded load that finds the server's natural throughput.
- **open-loop** (``rate_hz > 0``): clients pace to an aggregate target rate,
  which can exceed capacity — the shape that drives shedding drills.

Each client is a :class:`~sheeprl_tpu_torch.serve.client.ServeClient` (retry +
backoff on ``Overloaded``), observations are drawn per-request from a seeded
RNG, and the run report is a plain dict (ok/shed/expired counts, retries,
qps, p50/p95, ``slo_met``) that the CLI prints and the tests read. A fleet
run may tag its traffic with a router ``priority`` (``batch`` spills to the
CPU replicas).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from sheeprl_tpu_torch.serve.client import ServeClient
from sheeprl_tpu_torch.serve.config import LoadConfig
from sheeprl_tpu_torch.serve.errors import DeadlineExceeded, Overloaded, ServeError, ServerClosed
from sheeprl_tpu_torch.serve.server import PolicyServer


def random_obs(obs_spec: Any) -> Callable[[np.random.Generator], Any]:
    """Random observations matching a per-request ``obs_spec`` (key ->
    ``(shape, dtype)``): integers in [0, 255) for integer dtypes, standard
    normals otherwise."""

    def make(rng: np.random.Generator) -> Any:
        def leaf(shape: Any, dtype: Any) -> np.ndarray:
            if np.issubdtype(dtype, np.integer):
                return rng.integers(0, 255, size=tuple(shape)).astype(dtype)
            return rng.standard_normal(tuple(shape)).astype(dtype)

        return {k: leaf(shape, dtype) for k, (shape, dtype) in obs_spec.items()}

    return make


class _Worker(threading.Thread):
    def __init__(
        self,
        wid: int,
        server: PolicyServer,
        cfg: LoadConfig,
        stop: threading.Event,
        obs_factory: Callable[[np.random.Generator], Any],
        interval_s: float,
        priority: Optional[str] = None,
    ) -> None:
        super().__init__(name=f"loadgen-{wid}", daemon=True)
        self.client = ServeClient(
            server,
            max_retries=cfg.max_retries,
            timeout_s=(cfg.timeout_ms / 1e3) if cfg.timeout_ms else None,
            seed=cfg.seed * 10_000 + wid,
            priority=priority,
        )
        self._halt = stop
        self._obs_factory = obs_factory
        self._rng = np.random.default_rng(cfg.seed * 10_000 + wid)
        self._interval_s = interval_s  # 0: closed loop
        self.ok = 0
        self.shed = 0
        self.expired = 0
        self.errors = 0
        self.latencies: List[float] = []

    def run(self) -> None:
        next_t = time.monotonic()
        while not self._halt.is_set():
            if self._interval_s > 0:
                now = time.monotonic()
                if now < next_t:
                    if self._halt.wait(min(next_t - now, 0.05)):
                        break
                    continue
                next_t += self._interval_s
            obs = self._obs_factory(self._rng)
            t0 = time.monotonic()
            try:
                self.client.infer(obs)
            except Overloaded:
                self.shed += 1
            except DeadlineExceeded:
                self.expired += 1
            except ServerClosed:
                break
            except ServeError:
                self.errors += 1
            else:
                self.ok += 1
                self.latencies.append(time.monotonic() - t0)


def run_load(
    server: PolicyServer,
    cfg: LoadConfig,
    *,
    obs_factory: Optional[Callable[[np.random.Generator], Any]] = None,
    priority: Optional[str] = None,
) -> Dict[str, Any]:
    """Drive the load shape described by ``cfg`` (each request tagged with
    the fleet router's ``priority`` when given); returns the run report."""
    factory = obs_factory or random_obs(server.policy.obs_spec)
    interval_s = cfg.concurrency / cfg.rate_hz if cfg.rate_hz > 0 else 0.0
    stop = threading.Event()
    workers = [
        _Worker(i, server, cfg, stop, factory, interval_s, priority) for i in range(cfg.concurrency)
    ]
    t0 = time.monotonic()
    for w in workers:
        w.start()
    stop.wait(cfg.duration_s)
    stop.set()
    for w in workers:
        w.join(5.0)
    elapsed = time.monotonic() - t0

    lats = sorted(l for w in workers for l in w.latencies)

    def pct(q: float) -> Optional[float]:
        if not lats:
            return None
        idx = min(len(lats) - 1, max(0, int(np.ceil(q * len(lats))) - 1))
        return lats[idx] * 1e3

    ok = sum(w.ok for w in workers)
    report: Dict[str, Any] = {
        "duration_s": elapsed,
        "concurrency": cfg.concurrency,
        "mode": "open-loop" if cfg.rate_hz > 0 else "closed-loop",
        "target_rate_hz": cfg.rate_hz or None,
        "ok": ok,
        "shed": sum(w.shed for w in workers),
        "expired": sum(w.expired for w in workers),
        "errors": sum(w.errors for w in workers),
        "client_retries": sum(w.client.retries for w in workers),
        "client_rejections": sum(w.client.rejected for w in workers),
        "qps": ok / elapsed if elapsed > 0 else 0.0,
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "slo_ms": server.config.slo_ms,
    }
    p95 = report["p95_ms"]
    report["slo_met"] = bool(p95 is not None and p95 <= server.config.slo_ms)
    return report


def ramp_rates(start_hz: float, factor: float, steps: int) -> List[float]:
    """The stepped open-loop schedule: ``start_hz * factor**k`` per step."""
    if steps < 1:
        raise ValueError(f"ramp needs >= 1 step, got {steps}")
    if start_hz <= 0 or factor <= 1.0:
        raise ValueError(
            f"ramp needs start_hz > 0 and factor > 1, got start_hz={start_hz}, factor={factor}"
        )
    return [start_hz * (factor**k) for k in range(steps)]


def run_ramp(
    server: PolicyServer,
    cfg: LoadConfig,
    *,
    rates_hz: Optional[List[float]] = None,
    step_duration_s: Optional[float] = None,
    obs_factory: Optional[Callable[[np.random.Generator], Any]] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
    priority: Optional[str] = None,
) -> Dict[str, Any]:
    """Stepped open-loop ramp that walks the offered rate up until the
    server stops meeting its SLO — the saturation-knee finder.

    Each step runs :func:`run_load` open-loop at one rate for
    ``step_duration_s`` (default: ``cfg.duration_s`` split across the
    steps). ``on_step(step_index, rate_hz)`` fires *before* each step — the
    chaos drills use it to kill a replica mid-ramp. The report's knee is the
    highest offered rate whose step still met the SLO with negligible
    shedding; ``max_good_qps`` is the completed QPS while p95 <= SLO.
    """
    import dataclasses

    rates = rates_hz or ramp_rates(cfg.ramp_start_hz, cfg.ramp_factor, cfg.ramp_steps)
    per_step = step_duration_s if step_duration_s is not None else cfg.duration_s / len(rates)
    steps: List[Dict[str, Any]] = []
    knee_rate: Optional[float] = None
    max_good_qps = 0.0
    for k, rate in enumerate(rates):
        if on_step is not None:
            on_step(k, rate)
        step_cfg = dataclasses.replace(cfg, rate_hz=float(rate), duration_s=float(per_step))
        report = run_load(server, step_cfg, obs_factory=obs_factory, priority=priority)
        report["step"] = k
        report["offered_rate_hz"] = float(rate)
        attempts = report["ok"] + report["shed"] + report["expired"] + report["errors"]
        report["goodput_frac"] = (report["ok"] / attempts) if attempts else 0.0
        steps.append(report)
        if report["slo_met"] and report["goodput_frac"] >= 0.99:
            knee_rate = float(rate)
            max_good_qps = max(max_good_qps, float(report["qps"]))
    return {
        "mode": "ramp",
        "steps": steps,
        "offered_rates_hz": [float(r) for r in rates],
        "knee_rate_hz": knee_rate,
        "max_good_qps": max_good_qps,
        "saturated": bool(steps and not (steps[-1]["slo_met"] and steps[-1]["goodput_frac"] >= 0.99)),
        "slo_ms": server.config.slo_ms,
    }
