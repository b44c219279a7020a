"""Host utilities (port of ``sheeprl_tpu/utils/utils.py::Ratio``, :118, and
of ``sheeprl_tpu/utils/logger.py::run_base_dir``/``get_log_dir``, :120-143,
with ``save_configs``)."""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional


def run_base_dir(cfg: Mapping[str, Any]) -> str:
    """``<log_base_dir>/<root_dir>/<run_name>``: the parent of the run's
    ``version_N`` directories."""
    return os.path.join(cfg.get("log_base_dir") or os.path.join("logs", "runs"), cfg["root_dir"], cfg["run_name"])


def get_log_dir(cfg: Mapping[str, Any]) -> str:
    """A new ``<run base>/version_N`` directory, created."""
    base = run_base_dir(cfg)
    version = 0
    while os.path.isdir(os.path.join(base, f"version_{version}")):
        version += 1
    log_dir = os.path.join(base, f"version_{version}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def save_configs(cfg: Mapping[str, Any], log_dir: str) -> None:
    """The run's config as ``<log_dir>/config.yaml``, written as JSON (a
    subset of YAML): ``resume_from=auto`` takes only version directories
    that hold it."""
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True, default=str)


class Ratio:
    """Replay-ratio controller: turns the policy steps since the last call
    into a number of gradient steps so that ``gradient_steps / policy_steps
    ~= ratio``, carrying the fractional residue in a float ``_prev``. The
    state dict has the JAX package's keys."""

    def __init__(self, ratio: float, pretrain_steps: int = 0) -> None:
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "The number of pretrain steps is greater than the number of current steps: "
                        "capping 'pretrain_steps' to the current step to keep the requested ratio."
                    )
                    self._pretrain_steps = step
                return int(self._pretrain_steps * self._ratio)
            return 1
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state_dict: Mapping[str, Any]) -> "Ratio":
        self._ratio = state_dict["_ratio"]
        self._prev = state_dict["_prev"]
        self._pretrain_steps = state_dict["_pretrain_steps"]
        return self
