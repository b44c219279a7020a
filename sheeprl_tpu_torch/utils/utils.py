"""Host utilities (port of ``sheeprl_tpu/utils/utils.py``: ``dotdict`` :17,
``set_nested``/``del_nested`` :77-101, ``Ratio`` :118, ``save_configs`` and
``print_config`` :165-194). ``get_log_dir`` and ``run_base_dir`` moved to
``utils/logger.py`` and are re-exported here."""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence

from sheeprl_tpu_torch.utils.logger import get_log_dir, run_base_dir  # noqa: F401  (re-export)


class dotdict(dict):
    """Attribute-access dict; nested mappings become dotdicts, and
    attribute get, set and delete proxy to the dict."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, dotdict):
            return v
        if isinstance(v, Mapping):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def get_nested(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def set_nested(d: dict, dotted: str, value: Any, create: bool = True) -> None:
    """Set a dotted key, creating missing intermediate dicts; an
    intermediate that holds a non-dict value raises ``KeyError``."""
    parts = dotted.split(".")
    node = d
    for p in parts[:-1]:
        if p not in node:
            if not create:
                raise KeyError(f"missing intermediate key {p!r} in {dotted!r}")
            node[p] = {}
        elif not isinstance(node[p], dict):
            raise KeyError(f"cannot set {dotted!r}: intermediate key {p!r} holds a non-dict value ({node[p]!r})")
        node = node[p]
    node[parts[-1]] = value


def del_nested(d: dict, dotted: str) -> None:
    parts = dotted.split(".")
    node = d
    for p in parts[:-1]:
        node = node[p]
    del node[parts[-1]]


def save_configs(cfg: Mapping[str, Any], log_dir: str) -> None:
    """The run's config as ``<log_dir>/config.yaml``, written as JSON (a
    subset of YAML that ``config.load_config_file`` and PyYAML both read):
    ``resume_from=auto``, ``checkpoint.resume_from`` and ``cli_eval`` read
    it back."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        json.dump(cfg, f, indent=2, default=str)


def print_config(
    cfg: Mapping[str, Any],
    fields: Sequence[str] = ("algo", "buffer", "checkpoint", "env", "fabric", "metric"),
) -> None:
    """Print the config tree as plain text: each of ``fields`` under its
    name, then the top-level scalars."""
    raw = cfg.to_dict() if isinstance(cfg, dotdict) else dict(cfg)
    lines = ["CONFIG"]
    for field in fields:
        if field in raw:
            lines.append(f"{field}:")
            lines.extend("  " + line for line in json.dumps(raw[field], indent=2, default=str).splitlines())
    for key, value in raw.items():
        if key not in fields and not isinstance(value, dict):
            lines.append(f"{key}: {value}")
    print("\n".join(lines))


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
