"""Network blocks (port of ``sheeprl_tpu/models/blocks.py``: ``LayerNorm``
at lines 68-85 and ``LayerNormGRUCell`` at lines 296-338), and the dense
and convolution layers of the port with flax's compute dtype.

The GRU cell keeps its projection as ``kernel [in, out]``, the layout of a
flax ``Dense``, because the fused CUDA step reads it as it is
(``ops/fused_gru.py``); every other dense layer of the port is a
:class:`Dense` (an ``nn.Linear``).

Precision follows flax's ``dtype``/``param_dtype`` split: parameters stay
fp32, and a layer built with ``compute_dtype`` casts its input, weight and
bias to it before the product (flax's ``promote_dtype``), so its output is
in that dtype. The bias is added to the product as flax adds it
(``y = dot(x, w); y += b``): to the product rounded to the compute dtype,
not inside it. At fp32 every cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with statistics in fp32 and the output
    cast back to the input dtype. Flax takes the variance as E[x^2]-E[x]^2;
    PyTorch's is two-pass, so the two agree to float rounding."""

    def __init__(self, features: int, eps: float = 1e-5) -> None:
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return out.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, as flax
    ``nn.Dense(dtype=compute_dtype, param_dtype=float32)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, as flax
    ``nn.Conv(dtype=compute_dtype)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype``, as flax
    ``nn.ConvTranspose(dtype=compute_dtype)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), None, self.stride, self.padding, self.output_padding, self.groups, self.dilation
        )
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class LayerNormGRUCell(nn.Module):
    """GRU cell with LayerNorm after the joint projection (Hafner's
    DreamerV2 variant, the RSSM recurrence)::

        x = LN([h, i] @ kernel (+ bias))
        reset, cand, update = split(x, 3)
        cand = tanh(sigmoid(reset) * cand)
        update = sigmoid(update - 1)        # -1 bias: favour keeping state
        h' = update * cand + (1 - update) * h

    The projection computes in ``compute_dtype`` (the joint input, kernel
    and bias cast to it), the LayerNorm in fp32 cast back, and the gates in
    ``compute_dtype``; ``h'`` takes the type of ``h`` and the projection.
    """

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        bias: bool = True,
        layer_norm: bool = True,
        eps: float = 1e-5,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(hidden_size + input_size, 3 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(3 * hidden_size)) if bias else None
        self.norm = LayerNorm(3 * hidden_size, eps=eps) if layer_norm else None
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        proj = torch.cat([h, x], -1).to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            proj = proj + self.bias.to(dt)
        if self.norm is not None:
            proj = self.norm(proj)
        reset, cand, update = proj.chunk(3, -1)
        cand = torch.tanh(torch.sigmoid(reset) * cand)
        update = torch.sigmoid(update - 1)
        return update * cand + (1 - update) * h
