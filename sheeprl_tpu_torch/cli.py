"""CLI dispatcher (port of ``sheeprl_tpu/cli.py``).

``python -m sheeprl_tpu_torch exp=<exp> key=value ...`` composes the config
tree (``config/``), validates it, looks the algorithm up in the registry,
instantiates the ``fabric`` node (a one-device ``Fabric``: the CUDA card,
or the CPU with ``fabric=cpu``) and calls the registered ``main(fabric,
cfg)``, with run telemetry and the run registry around it.
``python -m sheeprl_tpu_torch.cli_eval checkpoint_path=...`` rebuilds the
config stored beside a checkpoint (the port's or the JAX package's) and
runs the registered evaluation.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Any, List, Optional

from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.config.compose import compose_group, load_config_file, resolve
from sheeprl_tpu_torch.config.reader import YAMLError
from sheeprl_tpu_torch.config.reader import load as yaml_load
from sheeprl_tpu_torch.utils.registry import find_algorithm, find_evaluation
from sheeprl_tpu_torch.utils.utils import dotdict, print_config

# the ported algorithm packages: importing one registers its entry points
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v3",
    "sheeprl_tpu_torch.algos.ppo",
    "sheeprl_tpu_torch.algos.a2c",
    "sheeprl_tpu_torch.algos.ppo_recurrent",
    "sheeprl_tpu_torch.algos.sac",
    "sheeprl_tpu_torch.algos.droq",
    "sheeprl_tpu_torch.algos.sac_ae",
)
# JAX algorithms whose port is queued, by the ROADMAP item that holds it
UNPORTED_ALGORITHMS = {
    "ppo_decoupled": "the decoupled player/trainer processes are queued under ROADMAP A10",
    "sac_decoupled": "the decoupled player/trainer processes are queued under ROADMAP A10",
}


def _register_algorithms() -> None:
    for name in ALGORITHM_MODULES:
        importlib.import_module(name)


def _stored_config(ckpt_path: str) -> dotdict:
    """The ``config.yaml`` of the run that wrote ``ckpt_path``
    (``<version dir>/checkpoint/<ckpt>``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(ckpt_path)), "config.yaml")
    if not os.path.isfile(path):
        raise ValueError(f"no config.yaml found next to the checkpoint: {path}")
    return load_config_file(path)


def resume_from_checkpoint(cfg: dotdict, cli_overrides: Optional[List[str]] = None) -> dotdict:
    """The run config stored beside ``checkpoint.resume_from``, keeping this
    run's checkpoint settings, ``root_dir`` and ``run_name``. The stored
    ``fabric`` section wins, except for the keys passed on this command line
    (``fabric=<group>``, ``fabric.<key>=...``, ``+``/``~`` forms too), which
    take the freshly composed value."""
    old_cfg = _stored_config(cfg.checkpoint.resume_from)
    if old_cfg.env.id != cfg.env.id:
        raise ValueError(
            f"This experiment is run with a different environment from the checkpoint: "
            f"{cfg.env.id} vs {old_cfg.env.id}"
        )
    if old_cfg.algo.name != cfg.algo.name:
        raise ValueError(
            f"This experiment is run with a different algorithm from the checkpoint: "
            f"{cfg.algo.name} vs {old_cfg.algo.name}"
        )
    merged = dotdict(old_cfg.to_dict())
    merged.checkpoint = dotdict(cfg.checkpoint.to_dict())
    for ov in cli_overrides or []:
        key = ov.split("=", 1)[0].strip().lstrip("+~").lstrip("/")
        if key == "fabric":
            merged.fabric = dotdict(cfg.fabric.to_dict())
        elif key.startswith("fabric."):
            sub = key[len("fabric.") :].split(".", 1)[0]
            if sub in cfg.fabric:
                merged.fabric[sub] = cfg.fabric[sub]
            else:
                merged.fabric.pop(sub, None)
    merged.root_dir = cfg.root_dir
    merged.run_name = cfg.run_name
    return merged


def check_configs(cfg: dotdict) -> None:
    """Config sanity checks: a registered algorithm, and an aggregator when
    logging is on."""
    if cfg.algo.name is None:
        raise ValueError("algo.name must be set")
    if cfg.algo.name in UNPORTED_ALGORITHMS:
        raise NotImplementedError(f"algo.name={cfg.algo.name!r} is not ported to sheeprl_tpu_torch yet: {UNPORTED_ALGORITHMS[cfg.algo.name]}")
    _register_algorithms()
    find_algorithm(cfg.algo.name)
    if cfg.metric.log_level > 0 and not cfg.metric.get("aggregator"):
        raise ValueError("metric.aggregator must be set when metric.log_level > 0")
    if (cfg.metric.get("profiler") or {}).get("enabled"):
        raise NotImplementedError("metric.profiler is not ported to sheeprl_tpu_torch yet: it is queued in ROADMAP.md")


def run_algorithm(cfg: dotdict) -> None:
    """Registry lookup, the Fabric, telemetry, the entry point, then the run
    record."""
    from sheeprl_tpu_torch.obs import configure_telemetry, register_run, shutdown_telemetry
    from sheeprl_tpu_torch.parallel.fabric import fabric_from_config
    from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE
    from sheeprl_tpu_torch.resilience.async_writer import drain_async_checkpoints
    from sheeprl_tpu_torch.resilience.autoresume import emit_pending_resilience_events
    from sheeprl_tpu_torch.utils.logger import run_base_dir
    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.timer import timer

    timer.disabled = bool(cfg.metric.get("disable_timer", False)) or cfg.metric.log_level <= 0
    MetricAggregator.disabled = cfg.metric.log_level <= 0

    _register_algorithms()
    entry = find_algorithm(cfg.algo.name)
    module = importlib.import_module(entry["module"])
    entrypoint = getattr(module, entry["entrypoint"])
    fabric = fabric_from_config(cfg.fabric)

    # keep only the aggregator metrics the algorithm produces
    algo_utils = importlib.import_module(entry["module"].rsplit(".", 1)[0] + ".utils")
    keys = set(getattr(algo_utils, "AGGREGATOR_KEYS", set()))
    metrics = (cfg.metric.get("aggregator") or {}).get("metrics") or {}
    for k in [k for k in metrics if k not in keys]:
        metrics.pop(k)

    configure_telemetry(cfg, log_dir=run_base_dir(cfg), device=fabric.device)
    # auto-resume resolution ran before telemetry existed: flush its events
    emit_pending_resilience_events()
    outcome, error = "completed", None
    try:
        entrypoint(fabric, cfg)
    except SystemExit as err:
        outcome = "preempted" if err.code == PREEMPTED_EXIT_CODE else "crashed"
        error = None if outcome == "preempted" else repr(err)
        raise
    except BaseException as err:
        outcome, error = "crashed", repr(err)
        raise
    finally:
        drain_async_checkpoints()
        register_run(cfg, kind="train", outcome=outcome, error=error)
        shutdown_telemetry()


def run(args: Optional[List[str]] = None) -> None:
    """``python -m sheeprl_tpu_torch exp=<exp> key=value ...``."""
    overrides = list(sys.argv[1:] if args is None else args)
    if overrides and overrides[0] == "serve":
        raise NotImplementedError(
            "`python -m sheeprl_tpu_torch serve` is not ported: the serving tier serves PPO, which the port "
            "does not have yet (queued in ROADMAP.md)"
        )
    cfg = dotdict(compose("config", overrides))
    if cfg.checkpoint.resume_from == "auto":
        from sheeprl_tpu_torch.resilience.autoresume import resolve_auto_resume

        cfg.checkpoint.resume_from = resolve_auto_resume(cfg)
    if cfg.checkpoint.resume_from:
        cfg = resume_from_checkpoint(cfg, cli_overrides=overrides)
    if cfg.metric.log_level > 0:
        print_config(cfg)
    check_configs(cfg)
    os.environ.setdefault("OMP_NUM_THREADS", str(cfg.num_threads))
    run_algorithm(cfg)


def eval_algorithm(cfg: dotdict) -> None:
    """Load ``cfg.checkpoint_path`` and run the registered evaluation on a
    one-device Fabric, then append the eval record."""
    from sheeprl_tpu_torch.obs.registry import register_run
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    _register_algorithms()
    entry = find_evaluation(cfg.algo.name)
    evaluate_fn = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    fabric = Fabric(
        accelerator=str(cfg.fabric.get("accelerator", "auto")), precision=str(cfg.fabric.get("precision", "fp32"))
    )
    state = load_checkpoint(cfg.checkpoint_path)
    outcome, error = "completed", None
    try:
        evaluate_fn(fabric, cfg, state)
    except BaseException as err:
        outcome, error = "crashed", repr(err)
        raise
    finally:
        register_run(cfg, kind="eval", outcome=outcome, error=error, checkpoint=cfg.get("checkpoint_path"))


def _value(raw: str) -> Any:
    try:
        return yaml_load(raw)
    except YAMLError:
        return raw


def evaluation(args: Optional[List[str]] = None) -> None:
    """``python -m sheeprl_tpu_torch.cli_eval checkpoint_path=... [overrides]``:
    the training config stored beside the checkpoint with the overrides
    applied (``group=option`` re-composes the group), on one device and one
    env, then the evaluation."""
    overrides = list(sys.argv[1:] if args is None else args)
    kv = dict(o.split("=", 1) for o in overrides if "=" in o and not o.startswith(("+", "~")))
    ckpt_path = kv.get("checkpoint_path")
    if not ckpt_path:
        raise ValueError("checkpoint_path=<file> is required")
    cfg = _stored_config(ckpt_path)
    cfg.checkpoint_path = ckpt_path
    for k, v in kv.items():
        if k in ("checkpoint_path", "env.capture_video"):
            continue
        value = _value(v)
        if "." not in k and isinstance(cfg.get(k), dict) and isinstance(value, str):
            cfg[k] = dotdict(compose_group(k, value))
            continue
        node = cfg
        parts = k.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    cfg = dotdict(resolve(cfg))
    cfg.fabric["devices"] = 1
    cfg.env.num_envs = 1
    cfg.env.capture_video = kv.get("env.capture_video", "False").lower() in ("1", "true")
    eval_algorithm(cfg)
