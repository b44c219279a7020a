"""``python -m sheeprl_tpu_torch serve checkpoint_path=... [overrides]`` (port
of ``sheeprl_tpu/cli_serve.py``).

Serve a *committed* training checkpoint as a policy service. Follows the
``cli_eval`` conventions: the run config stored beside the checkpoint is
rebuilt, ``key=value`` overrides are applied on top (so ``serve.slo_ms=50
serve.num_replicas=4`` tune the tier without touching the stored config),
and the algorithm name picks the policy builder. The server runs on the
CUDA card unless this command passes ``fabric.accelerator=cpu`` (or
``fabric=cpu``), whatever placement the training run had; without a card
it raises: there is no CPU fallback.

Sources, one of:

- ``checkpoint_path=<ckpt>`` — serve exactly this checkpoint; it must carry
  a commit manifest (a torn write is refused up front).
- ``ckpt_dir=<dir>`` — serve the newest committed checkpoint in the dir;
  with ``serve.swap_poll_s>0`` the server keeps watching the dir and
  hot-swaps newer commits as training lands them.

With ``serve.load.enabled=True`` the scripted load generator drives the
server and the run report (QPS, p50/p95 vs SLO, shed/retry counts) is
printed as JSON and emitted as the final ``serve_stats`` telemetry event.
Otherwise the server runs until SIGTERM/SIGINT, emitting ``serve_stats``
every ``serve.stats_interval_s``. Either way the run appends a
``kind: "serve"`` record to ``RUNS.jsonl``.

With ``serve.fleet.enabled=true`` the replica fleet serves
(:class:`~sheeprl_tpu_torch.serve.fleet.FleetServer`: N replica slots
behind one router, hedging, autoscaling, CPU spill), the run record carries
``variant: fleet``, and with ``serve.load.ramp_steps > 0`` the load
generator walks a stepped ramp to the saturation knee. The process names
its trace track ``serve`` (the trace plane's handshake), so with telemetry
on ``tools/trace.py`` merges its request chains from the record's
``telemetry_files``.

Not ported, each raising ``NotImplementedError``: remote replicas
(``serve.fleet.remote_agents``, ROADMAP A10) and the executable cache
(``serve.aot_cache_dir``, A10).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional


def _apply_kv_overrides(cfg: Any, kv: Dict[str, str], skip: tuple = ()) -> Any:
    """The ``cli_eval`` override semantics: dotted-path assignment with
    YAML-typed values; bare ``group=name`` strings re-compose config groups."""
    from sheeprl_tpu_torch.cli import _value
    from sheeprl_tpu_torch.config.compose import compose_group
    from sheeprl_tpu_torch.utils.utils import dotdict

    for k, v in kv.items():
        if k in skip:
            continue
        value = _value(v)
        if "." not in k and isinstance(cfg.get(k), dict) and isinstance(value, str):
            cfg[k] = dotdict(compose_group(k, value))
            continue
        node = cfg
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, dotdict({})) if isinstance(node, dict) else node[p]
        node[parts[-1]] = value
    return cfg


def _refuse_unported(serve_cfg: Any) -> None:
    if serve_cfg.fleet.remote_agents:
        raise NotImplementedError(
            "serve.fleet.remote_agents: remote replicas need the network plane, which is not ported to "
            "sheeprl_tpu_torch yet (ROADMAP.md A10)"
        )
    if serve_cfg.aot_cache_dir:
        raise NotImplementedError(
            "serve.aot_cache_dir: the JAX package caches XLA executables there; a CUDA graph cannot be "
            "serialized (ROADMAP.md A10)"
        )


def serving(args: Optional[List[str]] = None) -> None:
    overrides = list(sys.argv[1:] if args is None else args)
    kv = dict(o.split("=", 1) for o in overrides if "=" in o and not o.startswith(("+", "~")))
    ckpt_path = kv.get("checkpoint_path")
    ckpt_dir = kv.get("ckpt_dir")
    if not ckpt_path and not ckpt_dir:
        raise ValueError("serve needs checkpoint_path=<ckpt> or ckpt_dir=<dir>")

    from sheeprl_tpu_torch.resilience.manifest import read_manifest
    from sheeprl_tpu_torch.serve.errors import SwapRejected

    if ckpt_path:
        man = read_manifest(ckpt_path)
        if man is None:
            raise SwapRejected(
                f"checkpoint {ckpt_path} has no commit manifest — refusing to serve a torn "
                f"or foreign write (committed checkpoints carry a manifest)"
            )
        ckpt_dir = ckpt_dir or os.path.dirname(os.path.abspath(ckpt_path))
    else:
        from sheeprl_tpu_torch.resilience.discovery import newest_committed, validation_load_gate

        newest = newest_committed(
            ckpt_dir,
            gates=(validation_load_gate,),
            on_reject=lambda cand, reason: warnings.warn(
                f"serve: skipping checkpoint {cand.path!r} (step {cand.step}): {reason}"
            ),
        )
        if newest is None:
            raise FileNotFoundError(f"no committed, loadable checkpoint found in {ckpt_dir}")
        ckpt_path, man = newest.path, newest.manifest

    from sheeprl_tpu_torch.config.compose import load_config_file, resolve
    from sheeprl_tpu_torch.utils.utils import dotdict

    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(ckpt_path))), "config.yaml")
    if not os.path.isfile(cfg_path):
        raise ValueError(f"no config.yaml found next to the checkpoint: {cfg_path}")
    cfg = load_config_file(cfg_path)
    # where to serve is this command's choice, not the training run's: the
    # card unless fabric.accelerator=cpu (or fabric=cpu) is passed here
    cfg.setdefault("fabric", dotdict({}))["accelerator"] = "auto"
    _apply_kv_overrides(cfg, kv, skip=("checkpoint_path", "ckpt_dir"))
    cfg = dotdict(resolve(cfg))
    # serving never records video and needs no training env fan-out
    if isinstance(cfg.get("env"), dict):
        cfg.env["capture_video"] = False

    from sheeprl_tpu_torch.obs import (
        configure_telemetry,
        set_trace_role,
        shutdown_telemetry,
        telemetry_serve_event,
        telemetry_serve_stats,
    )
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg
    from sheeprl_tpu_torch.serve.loadgen import run_load, run_ramp
    from sheeprl_tpu_torch.serve.policy import build_served_policy, serve_device
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    serve_cfg = serve_config_from_cfg(cfg)
    _refuse_unported(serve_cfg)
    device = serve_device(cfg)  # the CUDA card unless fabric.accelerator=cpu
    run_dir = os.path.dirname(cfg_path)
    configure_telemetry(cfg, log_dir=run_dir, device=device)
    set_trace_role("serve")  # the trace handshake carries the serving role

    state = load_checkpoint(ckpt_path)
    policy = build_served_policy(cfg, state, device)
    del state  # the server keeps only the extracted params

    def on_event(kind: str, info: Dict[str, Any]) -> None:
        telemetry_serve_event(kind, **info)

    fleet = serve_cfg.fleet
    if fleet.enabled:
        from sheeprl_tpu_torch.serve.fleet import FleetServer

        server: Any = FleetServer(policy, serve_cfg, step=int(man["step"]), path=ckpt_path, ckpt_dir=ckpt_dir, on_event=on_event)
        slots = fleet.num_replicas + fleet.cpu_spill_replicas
        tier = (
            f"fleet replicas={fleet.num_replicas} (min={fleet.min_replicas} max={fleet.max_replicas} "
            f"spill={fleet.cpu_spill_replicas}) pending<={fleet.resolved_max_pending(serve_cfg)} "
            f"hedge@p{fleet.hedge_quantile * 100:.0f}"
        )
    else:
        server = PolicyServer(policy, serve_cfg, step=int(man["step"]), path=ckpt_path, ckpt_dir=ckpt_dir, on_event=on_event)
        slots = serve_cfg.num_replicas
        tier = f"gather={serve_cfg.gather_window_s * 1e3:.1f}ms queue<={serve_cfg.max_queue} replicas={serve_cfg.num_replicas}"
    t0 = time.perf_counter()
    server.start()
    warm = ", ".join(f"b{b}={dt * 1e3:.0f}ms" for b, dt in sorted(server.warmup_s.items()))
    route = "CUDA graphs" if device.type == "cuda" else "eager forwards on the CPU"
    print(
        f"serving {policy.name} step={man['step']} from {ckpt_path} on {device}\n"
        f"batch ladder ({route}, {slots} replica slots) ready in "
        f"{time.perf_counter() - t0:.2f}s ({warm}); slo={serve_cfg.slo_ms:.0f}ms {tier}"
    )

    stop = threading.Event()

    def _on_signal(signum: int, frame: Any) -> None:
        stop.set()

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
    except ValueError:
        pass  # not the main thread (tests drive serving() directly)

    outcome, error = "completed", None
    final_snap: Optional[Dict[str, Any]] = None
    try:
        if serve_cfg.load.enabled:
            if serve_cfg.load.ramp_steps > 0:
                report = run_ramp(server, serve_cfg.load)
            else:
                report = run_load(server, serve_cfg.load)
            snap = server.snapshot()
            snap["load_report"] = report
            telemetry_serve_stats(snap)
            final_snap = snap
            print(json.dumps({"serve_stats": snap}, indent=2, default=str))
        else:
            while not stop.wait(serve_cfg.stats_interval_s):
                telemetry_serve_stats(server.snapshot())
            final_snap = server.snapshot()
            telemetry_serve_stats(final_snap)
    except BaseException as err:
        outcome, error = "crashed", repr(err)
        raise
    finally:
        server.close()
        # serve runs register in RUNS.jsonl too: the record's `serve`
        # section (run_summary folds in the last serve_stats snapshot)
        from sheeprl_tpu_torch.obs.registry import register_run

        # fleet runs get their own cell (`variant: fleet`), apart from the
        # single server's history
        extra: Dict[str, Any] = {"variant": "fleet"} if fleet.enabled else {}
        register_run(cfg, kind="serve", outcome=outcome, error=error, checkpoint=ckpt_path, serve_stats=final_snap, **extra)
        shutdown_telemetry()


if __name__ == "__main__":
    serving()
