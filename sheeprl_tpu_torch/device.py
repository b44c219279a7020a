"""Device and precision policy of the port (counterpart of the device side
of ``sheeprl_tpu/parallel/fabric.py``).

An entry point takes ``device=None``, which means the CUDA card. Without a
card it raises: the plain PyTorch path runs only when the caller asks for
the CPU by name, as the tests do. The port computes in fp32 (``32-true``);
bf16-mixed autocast is a later slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

SUPPORTED_PRECISION = ("32-true", "32")


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


def compute_dtype(precision: str = "32-true") -> torch.dtype:
    """The dtype a ``fabric.precision`` string computes in."""
    if str(precision) not in SUPPORTED_PRECISION:
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet; the port computes in fp32 ({SUPPORTED_PRECISION[0]})"
        )
    return torch.float32
