"""Serving-tier knobs, parsed once from the composed config's ``serve`` node
(port of ``sheeprl_tpu/serve/config.py``, the same defaults and checks).

Everything lives under top-level ``serve`` (``configs/config.yaml``) so CLI
overrides read ``serve.slo_ms=50``; a checkpoint written before the node
existed composes to all-defaults (``serve_config_from_cfg({})`` is valid).
The ``fleet`` node and ``aot_cache_dir`` are parsed as the JAX package
parses them; ``cli_serve`` refuses remote agents and an executable cache
(ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional

from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSpec, parse_serve_faults


@dataclass
class LoadConfig:
    """Scripted load-generator run (``serve.load.*``): the CLI's measurable
    proxy for "heavy traffic" — N concurrent closed-loop clients (optionally
    rate-limited) hammering the server for ``duration_s``."""

    enabled: bool = False
    duration_s: float = 10.0
    concurrency: int = 8
    rate_hz: float = 0.0  # >0: open-loop target request rate across all clients
    timeout_ms: Optional[float] = None  # per-request client deadline; None: server default
    max_retries: int = 3
    seed: int = 0
    # stepped saturation ramp (``run_ramp``): 0 steps = plain run_load
    ramp_steps: int = 0
    ramp_start_hz: float = 50.0
    ramp_factor: float = 1.6


@dataclass
class FleetConfig:
    """Replica-fleet knobs (``serve.fleet.*``): router admission/hedging,
    elastic scaling bounds and the CPU spill tier. Disabled by default — the
    single :class:`PolicyServer` stays the small-deployment path."""

    enabled: bool = False
    num_replicas: int = 4  # initially-active device replicas
    min_replicas: int = 1  # autoscale floor
    max_replicas: int = 8  # autoscale ceiling (standby slots pre-created)
    cpu_spill_replicas: int = 0  # host-backend replicas for batch-priority spill
    backlog_per_replica: int = 16  # per-pool FIFO behind the slot window
    max_pending: Optional[int] = None  # fleet admission bound; None: derived
    hedge_quantile: float = 0.95  # hedge requests waiting past this latency quantile
    hedge_floor_ms: float = 0.0  # never hedge earlier than this
    hedge_max: int = 1  # hedge copies per request
    hedge_scan_ms: float = 5.0  # hedge/rescue scan cadence
    spill_depth: int = 4  # per-device-replica depth that opens the spill tier
    autoscale_interval_s: float = 0.25
    scale_up_depth: float = 4.0  # avg queued per active replica that adds one
    scale_down_depth: float = 0.5  # avg queued per active replica that retires one
    scale_patience: int = 3  # consecutive breaches before acting
    # remote replicas: per-host agent processes the fleet adopts over TCP —
    # "host:port" endpoints, one slot each (the transport is ROADMAP A10)
    remote_agents: List[str] = field(default_factory=list)
    remote_timeout_s: float = 10.0  # per-batch reply deadline on the agent link

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(f"serve.fleet.min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"serve.fleet.max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if not (self.min_replicas <= self.num_replicas <= self.max_replicas):
            raise ValueError(
                f"serve.fleet.num_replicas ({self.num_replicas}) must lie in "
                f"[min_replicas={self.min_replicas}, max_replicas={self.max_replicas}]"
            )
        if self.cpu_spill_replicas < 0:
            raise ValueError(
                f"serve.fleet.cpu_spill_replicas must be >= 0, got {self.cpu_spill_replicas}"
            )
        if not 0.0 < self.hedge_quantile <= 1.0:
            raise ValueError(
                f"serve.fleet.hedge_quantile must be in (0, 1], got {self.hedge_quantile}"
            )
        if self.hedge_max < 0:
            raise ValueError(f"serve.fleet.hedge_max must be >= 0, got {self.hedge_max}")
        if self.backlog_per_replica < 1:
            raise ValueError(
                f"serve.fleet.backlog_per_replica must be >= 1, got {self.backlog_per_replica}"
            )
        if self.remote_timeout_s <= 0:
            raise ValueError(
                f"serve.fleet.remote_timeout_s must be > 0, got {self.remote_timeout_s}"
            )

    def resolved_max_pending(self, serve: "ServeConfig") -> int:
        """The fleet-wide admission bound: explicit, else every active
        replica's slot window + backlog (the fleet analogue of the single
        server's ``max_queue``)."""
        if self.max_pending is not None:
            return int(self.max_pending)
        per_replica = serve.max_batch + self.backlog_per_replica
        return per_replica * (self.num_replicas + self.cpu_spill_replicas + len(self.remote_agents))


@dataclass
class ServeConfig:
    """Parameters for :class:`~sheeprl_tpu_torch.serve.server.PolicyServer`.

    The SLO drives the derived knobs: the micro-batcher coalesces requests
    for at most ``gather_window_s`` (default ``slo_ms / 5``) so queueing can
    never eat the whole latency budget, and requests default to a
    ``4 * slo_ms`` deadline.
    """

    batch_ladder: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    slo_ms: float = 100.0
    gather_window_ms: Optional[float] = None  # None: slo_ms / 5, capped at 10ms
    max_queue: int = 64  # admission-control bound (pending requests)
    default_deadline_ms: Optional[float] = None  # None: 4 * slo_ms
    num_replicas: int = 2
    max_restarts: int = 3
    restart_refund_s: Optional[float] = 600.0  # healthy window refunding one restart
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    replica_timeout_s: float = 30.0  # stale heartbeat -> replica presumed hung
    breaker_threshold: int = 3  # consecutive inference failures trip the replica
    monitor_interval_s: float = 0.05
    swap_poll_s: float = 0.0  # >0: watch the ckpt dir and hot-swap newer manifests
    stats_interval_s: float = 5.0  # serve_stats telemetry cadence
    # the JAX package's AOT executable cache dir; a CUDA graph cannot be
    # serialized, so the port refuses any value but None (ROADMAP A10)
    aot_cache_dir: Optional[str] = None
    faults: List[ServeFaultSpec] = field(default_factory=list)
    load: LoadConfig = field(default_factory=LoadConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)

    def __post_init__(self) -> None:
        ladder = sorted({int(b) for b in self.batch_ladder})
        if not ladder or ladder[0] < 1:
            raise ValueError(f"serve.batch_ladder must be positive ints, got {self.batch_ladder!r}")
        self.batch_ladder = ladder
        if self.num_replicas < 1:
            raise ValueError(f"serve.num_replicas must be >= 1, got {self.num_replicas}")
        if self.max_queue < 1:
            raise ValueError(f"serve.max_queue must be >= 1, got {self.max_queue}")

    @property
    def max_batch(self) -> int:
        return self.batch_ladder[-1]

    @property
    def gather_window_s(self) -> float:
        if self.gather_window_ms is not None:
            return float(self.gather_window_ms) / 1e3
        return min(self.slo_ms / 5.0, 10.0) / 1e3

    @property
    def default_deadline_s(self) -> float:
        if self.default_deadline_ms is not None:
            return float(self.default_deadline_ms) / 1e3
        return 4.0 * self.slo_ms / 1e3

    def backoff_s(self, charge: int) -> float:
        return min(self.backoff_max_s, self.backoff_base_s * (2 ** max(0, charge - 1)))


def serve_config_from_cfg(cfg: Mapping[str, Any]) -> ServeConfig:
    """Build a :class:`ServeConfig` from the composed run config's ``serve``
    node (absent node -> all defaults, faults disabled)."""
    node = _get(cfg, "serve") or {}
    fault_node = _get(node, "fault_injection") or {}
    faults: List[ServeFaultSpec] = []
    if bool(_get(fault_node, "enabled", False)):
        faults = parse_serve_faults(_get(fault_node, "faults") or [])
    fleet_node = _get(node, "fleet") or {}
    fleet = FleetConfig(
        enabled=bool(_get(fleet_node, "enabled", False)),
        num_replicas=int(_get(fleet_node, "num_replicas", 4)),
        min_replicas=int(_get(fleet_node, "min_replicas", 1)),
        max_replicas=int(_get(fleet_node, "max_replicas", 8)),
        cpu_spill_replicas=int(_get(fleet_node, "cpu_spill_replicas", 0)),
        backlog_per_replica=int(_get(fleet_node, "backlog_per_replica", 16)),
        max_pending=(
            None
            if _get(fleet_node, "max_pending", None) is None
            else int(_get(fleet_node, "max_pending"))
        ),
        hedge_quantile=float(_get(fleet_node, "hedge_quantile", 0.95)),
        hedge_floor_ms=float(_get(fleet_node, "hedge_floor_ms", 0.0) or 0.0),
        hedge_max=int(_get(fleet_node, "hedge_max", 1)),
        hedge_scan_ms=float(_get(fleet_node, "hedge_scan_ms", 5.0)),
        spill_depth=int(_get(fleet_node, "spill_depth", 4)),
        autoscale_interval_s=float(_get(fleet_node, "autoscale_interval_s", 0.25)),
        scale_up_depth=float(_get(fleet_node, "scale_up_depth", 4.0)),
        scale_down_depth=float(_get(fleet_node, "scale_down_depth", 0.5)),
        scale_patience=int(_get(fleet_node, "scale_patience", 3)),
        remote_agents=[str(a) for a in (_get(fleet_node, "remote_agents") or [])],
        remote_timeout_s=float(_get(fleet_node, "remote_timeout_s", 10.0)),
    )
    load_node = _get(node, "load") or {}
    load = LoadConfig(
        enabled=bool(_get(load_node, "enabled", False)),
        duration_s=float(_get(load_node, "duration_s", 10.0)),
        concurrency=int(_get(load_node, "concurrency", 8)),
        rate_hz=float(_get(load_node, "rate_hz", 0.0) or 0.0),
        timeout_ms=_opt_float(_get(load_node, "timeout_ms", None)),
        max_retries=int(_get(load_node, "max_retries", 3)),
        seed=int(_get(load_node, "seed", 0)),
        ramp_steps=int(_get(load_node, "ramp_steps", 0)),
        ramp_start_hz=float(_get(load_node, "ramp_start_hz", 50.0)),
        ramp_factor=float(_get(load_node, "ramp_factor", 1.6)),
    )
    return ServeConfig(
        batch_ladder=list(_get(node, "batch_ladder", None) or [1, 2, 4, 8]),
        slo_ms=float(_get(node, "slo_ms", 100.0)),
        gather_window_ms=_opt_float(_get(node, "gather_window_ms", None)),
        max_queue=int(_get(node, "max_queue", 64)),
        default_deadline_ms=_opt_float(_get(node, "default_deadline_ms", None)),
        num_replicas=int(_get(node, "num_replicas", 2)),
        max_restarts=int(_get(node, "max_restarts", 3)),
        restart_refund_s=_opt_float(_get(node, "restart_refund_s", 600.0)),
        backoff_base_s=float(_get(node, "backoff_base_s", 0.05)),
        backoff_max_s=float(_get(node, "backoff_max_s", 2.0)),
        replica_timeout_s=float(_get(node, "replica_timeout_s", 30.0)),
        breaker_threshold=int(_get(node, "breaker_threshold", 3)),
        monitor_interval_s=float(_get(node, "monitor_interval_s", 0.05)),
        swap_poll_s=float(_get(node, "swap_poll_s", 0.0) or 0.0),
        stats_interval_s=float(_get(node, "stats_interval_s", 5.0)),
        aot_cache_dir=(None if _get(node, "aot_cache_dir", None) is None else str(_get(node, "aot_cache_dir"))),
        faults=faults,
        load=load,
        fleet=fleet,
    )


def _opt_float(v: Any) -> Optional[float]:
    return None if v is None else float(v)


def _get(node: Any, key: str, default: Any = None) -> Any:
    if node is None:
        return default
    if hasattr(node, "get"):
        return node.get(key, default)
    return getattr(node, key, default)
