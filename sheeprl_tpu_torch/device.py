"""Device and precision policy of the port (counterpart of the device side
of ``sheeprl_tpu/parallel/fabric.py`` and of its ``Precision``, :40-80).

An entry point takes ``device=None``, which means the CUDA card. Without a
card it raises: the plain PyTorch path runs only when the caller asks for
the CPU by name, as the tests do. The precision is ``fp32``,
``bf16-mixed`` (fp32 parameters and optimizer state, bf16 compute, the
default of ``configs/fabric/default.yaml``) or ``bf16-true`` (bf16 compute,
and bf16 parameters where the algorithm asks for ``param_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

PRECISIONS = ("fp32", "bf16-mixed", "bf16-true")
# the lightning-style spellings the configs use (fabric.py:40-42)
PRECISION_ALIASES = {"32-true": "fp32", "32": "fp32", "bf16": "bf16-mixed"}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sheeprl_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numeric policy: ``fp32`` computes in float32; ``bf16-mixed`` keeps
    parameters and optimizer state in float32 and computes in bfloat16 at
    the cast points of the JAX modules (flax ``dtype=bf16``,
    ``param_dtype=fp32``); ``bf16-true`` computes in bfloat16 and has a
    bfloat16 ``param_dtype``. As in the JAX package, only the algorithms
    that cast their parameters to ``param_dtype`` (PPO) hold bf16
    parameters: Dreamer-V3's modules fix fp32 parameters, so it computes
    at ``bf16-true`` exactly what it computes at ``bf16-mixed``."""

    name: str = "fp32"

    def __post_init__(self) -> None:
        name = PRECISION_ALIASES.get(str(self.name), str(self.name))
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {self.name!r}; choose from {PRECISIONS} (aliases: {PRECISION_ALIASES})")
        object.__setattr__(self, "name", name)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name == "bf16-true" else torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name in ("bf16-mixed", "bf16-true") else torch.float32


def compute_dtype(precision: str = "32-true") -> torch.dtype:
    """The dtype a ``fabric.precision`` string computes in."""
    return Precision(precision).compute_dtype
