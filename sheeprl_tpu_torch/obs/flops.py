"""FLOPs of one program run, for MFU (the counterpart of
``sheeprl_tpu/utils/profiler.py::compiled_flops``, which reads XLA's cost
analysis).

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products and
convolutions of an eager run, backward passes included. The fused RSSM
kernel is launched through ``ctypes`` and the counter cannot see it, so its
wrapper reports its own products through ``fused_gru.flop_hook`` while a
count runs. Elementwise work is not counted.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from torch.utils.flop_counter import FlopCounterMode

from sheeprl_tpu_torch.ops import fused_gru


def count_flops(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Tuple[Any, float]:
    """``(fn(*args, **kwargs), its FLOPs)``: the counter's products plus the
    fused kernel's own count of its launches."""
    kernel = [0.0]

    def hook(flops: float) -> None:
        kernel[0] += flops

    counter = FlopCounterMode(display=False)
    previous, fused_gru.flop_hook = fused_gru.flop_hook, hook
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        fused_gru.flop_hook = previous
    return out, float(counter.get_total_flops()) + kernel[0]
