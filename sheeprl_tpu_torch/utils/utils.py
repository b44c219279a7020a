"""Host utilities (port of ``sheeprl_tpu/utils/utils.py``: ``dotdict`` :17,
``set_nested``/``del_nested`` :77-101, ``polynomial_decay`` :104, ``Ratio`` :118,
``save_configs`` and
``print_config`` :165-194, ``SteadyStateProbe`` :197, ``gradient_step_chunks``
:305 and ``weighted_chunk_metrics`` :327). ``get_log_dir`` and ``run_base_dir`` moved to
``utils/logger.py`` and are re-exported here."""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

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


def _float_text(x: float) -> str:
    """``x`` as JSON that YAML 1.1 (PyYAML) also reads as a float: always a
    ``.``, and a sign on any exponent (``1e-05`` -> ``1.0e-05``)."""
    if x != x or x in (float("inf"), float("-inf")):
        raise ValueError(f"config.yaml cannot hold the non-finite float {x!r}")
    text = repr(float(x))
    mantissa, e, exponent = text.partition("e")
    if "." not in mantissa:
        mantissa += ".0"
    if e and exponent[0] not in "+-":
        exponent = "+" + exponent
    return mantissa + e + exponent


def _config_text(value: Any, indent: str = "") -> str:
    """``value`` as indented JSON, floats through :func:`_float_text` and
    anything JSON has no type for as its ``str``."""
    inner = indent + "  "
    if isinstance(value, Mapping):
        if not value:
            return "{}"
        items = (f"{inner}{json.dumps(str(k))}: {_config_text(v, inner)}" for k, v in value.items())
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(value, (list, tuple)):
        if not value:
            return "[]"
        return "[\n" + ",\n".join(inner + _config_text(v, inner) for v in value) + "\n" + indent + "]"
    if isinstance(value, float):
        return _float_text(value)
    if value is None or isinstance(value, (bool, int, str)):
        return json.dumps(value)
    return json.dumps(str(value))


def save_configs(cfg: Mapping[str, Any], log_dir: str) -> None:
    """The run's config as ``<log_dir>/config.yaml``, written as JSON (a
    subset of YAML) whose floats carry a ``.`` and a signed exponent, so
    that ``config.load_config_file`` and PyYAML's ``safe_load`` (the JAX
    package's resume and ``cli_eval``) read back the same values and types:
    ``resume_from=auto``, ``checkpoint.resume_from`` and ``cli_eval`` read
    it."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.yaml"), "w") as f:
        f.write(_config_text(cfg) + "\n")


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


def polynomial_decay(
    current_step: int,
    *,
    initial: float = 1.0,
    final: float = 0.0,
    max_decay_steps: int = 100,
    power: float = 1.0,
) -> float:
    """``initial`` decayed to ``final`` over ``max_decay_steps`` with
    ``power`` (JAX ``utils/utils.py:104-115``)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


def gradient_step_chunks(n_steps: int, algo_cfg: Mapping[str, Any]) -> List[int]:
    """``n_steps`` gradient steps as full chunks of
    ``algo.gradient_steps_chunk`` (16 by default) and a remainder (JAX
    ``utils/utils.py:305-325``). ``Ratio``'s first call after the warm-up
    repays the whole warm-up debt in one window; chunking keeps the set of
    captured graph lengths at the chunk and one step."""
    if n_steps <= 0:
        return []
    chunk = int(algo_cfg.get("gradient_steps_chunk", 16) or 16)
    out = [chunk] * (int(n_steps) // chunk)
    rem = int(n_steps) % chunk
    if rem:
        out.append(rem)
    return out


def weighted_chunk_metrics(chunk_metrics: Sequence[Tuple[int, Any]]) -> np.ndarray:
    """The gradient-step-weighted mean of ``(steps, metrics)`` pairs, each
    ``metrics`` the mean over its steps (a device tensor): one fetch for
    the window, equal to the mean over all its steps (JAX :327-336)."""
    weights = np.array([w for w, _ in chunk_metrics], np.float64)
    stacked = torch.stack([torch.as_tensor(m).float() for _, m in chunk_metrics]).cpu().numpy()
    return np.average(stacked, axis=0, weights=weights)


class SteadyStateProbe:
    """The ``SHEEPRL_TPU_BENCH_JSON`` steady-state throughput record of the
    off-policy loops (JAX :197-302): the window opens ``WARMUP_UPDATES``
    updates past both ``learning_starts`` and the run's first update (a
    resumed run captures its graphs on its first updates too), and
    :meth:`finish` writes ``{"steps", "seconds", "train_steps"}`` after a
    device sync, or an ``error`` when the run ended before the window
    opened. Opening the window also marks the run warm for telemetry."""

    WARMUP_UPDATES = 64

    def __init__(self) -> None:
        self.path = os.environ.get("SHEEPRL_TPU_BENCH_JSON")
        self._t0: Optional[float] = None
        self._step0 = self._work0 = 0
        self._first_update: Optional[int] = None

    def mark_warm(self, update: int, learning_starts: int, step: int, work: int = 0) -> None:
        if self._first_update is None:
            self._first_update = update
        if update >= learning_starts + self.WARMUP_UPDATES and update >= self._first_update + self.WARMUP_UPDATES:
            self.mark(step, work)

    def mark(self, step: int, work: int = 0) -> None:
        from sheeprl_tpu_torch.obs.telemetry import telemetry_mark_warm

        telemetry_mark_warm()
        if self.path is None or self._t0 is not None:
            return
        self._t0, self._step0, self._work0 = time.perf_counter(), step, work

    def finish(self, step: int, sync: Optional[Any] = None, work: int = 0) -> None:
        if self.path is None:
            return
        if self._t0 is None:
            record: Dict[str, Any] = {
                "error": "window_never_opened",
                "detail": f"run ended at step {step} before the steady-state window opened "
                f"(first update {self._first_update}, warmup {self.WARMUP_UPDATES} updates)",
            }
        else:
            if sync is not None:
                sync()
            record = {"steps": step - self._step0, "seconds": time.perf_counter() - self._t0}
            if work:
                record["train_steps"] = work - self._work0
        with open(self.path, "w") as f:
            json.dump(record, f)
