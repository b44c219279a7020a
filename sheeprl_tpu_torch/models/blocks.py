"""Network blocks (port of ``sheeprl_tpu/models/blocks.py``: ``LayerNorm``
at lines 68-85 and ``LayerNormGRUCell`` at lines 296-338).

The GRU cell keeps its projection as ``kernel [in, out]``, the layout of a
flax ``Dense``, because the fused CUDA step reads it as it is
(``ops/fused_gru.py``); every other dense layer of the port is an
``nn.Linear``.
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


class LayerNormGRUCell(nn.Module):
    """GRU cell with LayerNorm after the joint projection (Hafner's
    DreamerV2 variant, the RSSM recurrence)::

        x = LN([h, i] @ kernel (+ bias))
        reset, cand, update = split(x, 3)
        cand = tanh(sigmoid(reset) * cand)
        update = sigmoid(update - 1)        # -1 bias: favour keeping state
        h' = update * cand + (1 - update) * h
    """

    def __init__(
        self, input_size: int, hidden_size: int, bias: bool = True, layer_norm: bool = True, eps: float = 1e-5
    ) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.kernel = nn.Parameter(torch.empty(hidden_size + input_size, 3 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(3 * hidden_size)) if bias else None
        self.norm = LayerNorm(3 * hidden_size, eps=eps) if layer_norm else None
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        proj = torch.cat([h, x], -1) @ self.kernel
        if self.bias is not None:
            proj = proj + self.bias
        if self.norm is not None:
            proj = self.norm(proj)
        reset, cand, update = proj.chunk(3, -1)
        cand = torch.tanh(torch.sigmoid(reset) * cand)
        update = torch.sigmoid(update - 1)
        return update * cand + (1 - update) * h
