"""Fault-tolerant policy-serving tier (``python -m sheeprl_tpu_torch serve``;
port of ``sheeprl_tpu/serve``).

Turns a committed training checkpoint into an inference service: a batch
ladder captured as one CUDA graph a rung before any traffic, SLO-bounded
micro-batching, a bounded queue with typed load shedding, supervised
replicas with budgeted restarts and degraded N-1 mode, circuit breaking,
and validated hot checkpoint swap with rollback. With
``serve.fleet.enabled`` the replica fleet serves instead
(:mod:`~sheeprl_tpu_torch.serve.fleet`): slot pools with continuous
batching (``slots``), a router with fleet-wide admission, health-weighted
routing and hedged retries (``router``), autoscaling and a CPU-spill tier.

The package root re-exports the torch-free surface (batching, config,
errors, fault injection); the modules that build or run the model are
imported from their own modules. Remote replicas and the executable cache
are ROADMAP A10.
"""

from __future__ import annotations

from sheeprl_tpu_torch.serve.batching import MicroBatcher, Request
from sheeprl_tpu_torch.serve.config import FleetConfig, LoadConfig, ServeConfig, serve_config_from_cfg
from sheeprl_tpu_torch.serve.errors import (
    DeadlineExceeded,
    InferenceFailed,
    Overloaded,
    ServeError,
    ServerClosed,
    SwapRejected,
)
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule, ServeFaultSpec, parse_serve_faults

__all__ = [
    "DeadlineExceeded",
    "FleetConfig",
    "InferenceFailed",
    "LoadConfig",
    "MicroBatcher",
    "Overloaded",
    "Request",
    "ServeConfig",
    "ServeError",
    "ServeFaultSchedule",
    "ServeFaultSpec",
    "ServerClosed",
    "SwapRejected",
    "parse_serve_faults",
    "serve_config_from_cfg",
]
