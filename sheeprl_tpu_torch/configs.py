"""The configuration values the port reads, as Python (no YAML on the card).

Copied from the JAX package's config tree: ``configs/algo/dreamer_v3.yaml``
and its ``dreamer_v3_{XS,S,M,L,XL}.yaml`` sizes, ``configs/exp/dreamer_v3.yaml``,
``configs/optim/adam.yaml`` (the three optimizers' defaults),
``configs/buffer/default.yaml`` (``size``, ``memmap``, ``validate_args``,
``prefetch``, ``device``, ``device_max_bytes`` and, from the exp,
``checkpoint``), ``configs/checkpoint/default.yaml`` (with the exp's
``every``), the ``resilience`` group and the run naming of
``configs/config.yaml``, ``configs/metric/default.yaml`` (``log_every``,
``log_level``) and ``configs/env/{default,pixel_catcher,dummy}.yaml``.
``compose`` applies the size, then the env, then dotted overrides, and
resolves the ``${...}`` references last, as the JAX composer does
(``${now:<strftime format>}`` included). The precision is ``bf16-mixed``,
as ``configs/fabric/default.yaml:8`` composes it (fp32 parameters, bf16
compute; ``device.Precision``); ``32-true`` computes in fp32.
"""

from __future__ import annotations

import copy
import re
import time
from typing import Any, Dict, Mapping, Optional

SIZES = ("XS", "S", "M", "L", "XL")


def _adam(lr: float, eps: float) -> Dict[str, Any]:
    """``configs/optim/adam.yaml`` with the algo's lr and eps."""
    return {"lr": lr, "eps": eps, "weight_decay": 0, "betas": [0.9, 0.999]}


_ROOT: Dict[str, Any] = {
    "seed": 42,
    "dry_run": False,
    "exp_name": "${algo.name}_${env.id}",
    "run_name": "${now:%Y-%m-%d_%H-%M-%S}_${exp_name}_${seed}",
    "root_dir": "${algo.name}/${env.id}",
    "log_base_dir": "logs/runs",
    # configs/checkpoint/default.yaml, every from configs/exp/dreamer_v3.yaml;
    # backend orbax is not ported (utils/checkpoint.py raises)
    "checkpoint": {
        "every": 100000,
        "resume_from": None,
        "save_last": True,
        "keep_last": 5,
        "backend": "pickle",
        "async_save": True,
    },
    # configs/config.yaml: resilience
    "resilience": {
        "enabled": True,
        "preemption": True,
        "crash_checkpoint": True,
        "check_finite": True,
        "max_rollbacks": 3,
        "fault_injection": {"enabled": False, "faults": []},
    },
    # configs/metric/default.yaml
    "metric": {"log_every": 5000, "log_level": 1},
    # configs/fabric/default.yaml:8 (exp=dreamer_v3 keeps it)
    "fabric": {"precision": "bf16-mixed"},
    "distribution": {"type": "auto"},
    "env": {
        "id": "pixel_catcher",
        "num_envs": 4,
        "frame_stack": 1,
        "screen_size": 64,
        "grayscale": False,
        "clip_rewards": False,
        "max_episode_steps": None,
    },
    # configs/buffer/default.yaml, size and checkpoint from the exp
    "buffer": {
        "size": 1000000,
        "memmap": True,
        "validate_args": False,
        "prefetch": 2,
        "device": "auto",
        "device_max_bytes": 8_000_000_000,
        "checkpoint": False,
    },
    "algo": {
        "name": "dreamer_v3",
        "total_steps": 5000000,
        "per_rank_batch_size": 16,
        "per_rank_sequence_length": 64,
        "gamma": 0.996996996996997,
        "lmbda": 0.95,
        "horizon": 15,
        "replay_ratio": 1,
        "learning_starts": 1024,
        "per_rank_pretrain_steps": 0,
        "fused_gradient_steps": 0,
        "cnn_keys": {"encoder": ["rgb"], "decoder": "${algo.cnn_keys.encoder}"},
        "mlp_keys": {"encoder": [], "decoder": "${algo.mlp_keys.encoder}"},
        "dense_units": 1024,
        "mlp_layers": 5,
        "unimix": 0.01,
        "world_model": {
            "discrete_size": 32,
            "stochastic_size": 32,
            "kl_dynamic": 0.5,
            "kl_representation": 0.1,
            "kl_free_nats": 1.0,
            "kl_regularizer": 1.0,
            "continue_scale_factor": 1.0,
            "clip_gradients": 1000.0,
            "learnable_initial_recurrent_state": True,
            "encoder": {
                "cnn_channels_multiplier": 96,
                "mlp_layers": "${algo.mlp_layers}",
                "dense_units": "${algo.dense_units}",
            },
            "recurrent_model": {
                "recurrent_state_size": 4096,
                "dense_units": "${algo.dense_units}",
                "fused": "auto",
            },
            "transition_model": {"hidden_size": 1024},
            "representation_model": {"hidden_size": 1024},
            "observation_model": {
                "cnn_channels_multiplier": "${algo.world_model.encoder.cnn_channels_multiplier}",
                "mlp_layers": "${algo.mlp_layers}",
                "dense_units": "${algo.dense_units}",
            },
            "reward_model": {"mlp_layers": "${algo.mlp_layers}", "dense_units": "${algo.dense_units}", "bins": 255},
            "discount_model": {"learnable": True, "mlp_layers": "${algo.mlp_layers}", "dense_units": "${algo.dense_units}"},
            "optimizer": _adam(1e-4, 1e-8),
        },
        "actor": {
            "cls": "sheeprl_tpu.algos.dreamer_v3.agent.Actor",
            "ent_coef": 3e-4,
            "min_std": 0.1,
            "max_std": 1.0,
            "init_std": 2.0,
            "mlp_layers": "${algo.mlp_layers}",
            "dense_units": "${algo.dense_units}",
            "clip_gradients": 100.0,
            "unimix": "${algo.unimix}",
            "action_clip": 1.0,
            "moments": {"decay": 0.99, "max": 1.0, "percentile": {"low": 0.05, "high": 0.95}},
            "optimizer": _adam(8e-5, 1e-5),
        },
        "critic": {
            "mlp_layers": "${algo.mlp_layers}",
            "dense_units": "${algo.dense_units}",
            "per_rank_target_network_update_freq": 1,
            "tau": 0.02,
            "bins": 255,
            "clip_gradients": 100.0,
            "optimizer": _adam(8e-5, 1e-5),
        },
    },
}


def _size(dense: int, layers: int, cnn: int, rec: int, hidden: int) -> Dict[str, Any]:
    return {
        "algo.dense_units": dense,
        "algo.mlp_layers": layers,
        "algo.world_model.encoder.cnn_channels_multiplier": cnn,
        "algo.world_model.recurrent_model.recurrent_state_size": rec,
        "algo.world_model.transition_model.hidden_size": hidden,
        "algo.world_model.representation_model.hidden_size": hidden,
    }


_SIZE_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "XS": _size(256, 1, 24, 256, 256),
    "S": _size(512, 2, 32, 512, 512),
    "M": _size(640, 3, 48, 1024, 640),
    "L": _size(768, 4, 64, 2048, 768),
    "XL": {},
}

_ENV_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "pixel_catcher": {"env.id": "pixel_catcher", "env.screen_size": 64},
    "dummy_discrete": {"env.id": "dummy_discrete"},
    "dummy_continuous": {"env.id": "dummy_continuous"},
}

_REF = re.compile(r"^\$\{([^}]+)\}$")


def _set(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    *path, leaf = dotted.split(".")
    node = tree
    for p in path:
        node = node[p]
    if leaf not in node:
        raise KeyError(f"no config key {dotted!r}")
    node[leaf] = value


def _get(tree: Mapping[str, Any], dotted: str) -> Any:
    node: Any = tree
    for p in dotted.split("."):
        node = node[p]
    return node


_EMBEDDED = re.compile(r"\$\{([^}]+)\}")


def _lookup(tree: Dict[str, Any], ref: str) -> Any:
    if ref.startswith("now:"):
        return time.strftime(ref[4:])
    return _resolve(tree, _get(tree, ref))


def _resolve(tree: Dict[str, Any], node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(tree, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(tree, v) for v in node]
    if not isinstance(node, str):
        return node
    m = _REF.match(node)
    if m:  # a whole-value reference keeps the referenced value's type
        return _lookup(tree, m.group(1))
    return _EMBEDDED.sub(lambda e: str(_lookup(tree, e.group(1))), node)


def compose(size: str = "S", env: str = "pixel_catcher", overrides: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The Dreamer-V3 config at ``size`` on ``env`` with dotted ``overrides``
    such as ``{"env.num_envs": 1}``."""
    if size not in _SIZE_OVERRIDES:
        raise ValueError(f"unknown Dreamer-V3 size {size!r}; one of {SIZES}")
    if env not in _ENV_OVERRIDES:
        raise ValueError(f"unknown env preset {env!r}; one of {tuple(_ENV_OVERRIDES)}")
    tree = copy.deepcopy(_ROOT)
    for layer in (_SIZE_OVERRIDES[size], _ENV_OVERRIDES[env], overrides or {}):
        for k, v in layer.items():
            _set(tree, k, v)
    return _resolve(tree, tree)
