"""Network blocks (port of ``sheeprl_tpu/models/blocks.py``: ``LayerNorm``
at lines 68-85, ``MLP`` at :115, ``NatureCNN`` at :268 and
``LayerNormGRUCell`` at lines 296-338), flax's ``OptimizedLSTMCell`` (the
recurrent PPO agent's LSTM), and the dense and convolution layers of the
port with flax's compute dtype.

The port's images are NCHW where flax's are NHWC. ``NatureCNN`` flattens
its last conv map in CHW order where flax flattens in HWC order, so the
weight converters permute the input rows of its feature ``Dense``
(``algos/ppo/convert.py``).

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

from typing import Callable, Optional, Sequence, Tuple

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


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` (``features=hidden_size``), the carry
    ``(c, h)``::

        dense_h = h @ [Whi|Whf|Whg|Who] + [bhi|bhf|bhg|bho]
        dense_i = x @ [Wii|Wif|Wig|Wio]
        i, f, o = sigmoid(dense_h + dense_i)    g = tanh(dense_h + dense_i)
        c' = f * c + i * g
        h' = o * tanh(c')

    The eight flax ``DenseParams`` are held concatenated in flax's layout
    and gate order (i, f, g, o), as the cell concatenates them before its
    two products: ``input_kernel [in, 4H]`` (the ``i*`` kernels, no bias),
    ``hidden_kernel [H, 4H]`` and ``hidden_bias [4H]`` (the ``h*``
    kernels and biases); ``algos/ppo_recurrent/convert.py`` splits and
    joins them.

    Both products, the bias, the gate sums, the gates and the carry
    compute in ``compute_dtype`` (flax's ``promote_dtype`` casts the
    inputs, kernels and bias to the cell's ``dtype``), so at bf16 ``c`` and
    ``h`` stay bf16 from one step to the next. :meth:`input_projection`
    takes the ``x`` products of a whole sequence at once (the same
    products, row by row) and :meth:`step` one step from them; ``forward``
    is both for one step. Plain tensor code, one step at a time, which a
    CUDA graph captures: ``torch.nn.LSTM`` would not reproduce flax's cast
    points."""

    def __init__(self, input_size: int, hidden_size: int, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.input_size, self.hidden_size = int(input_size), int(hidden_size)
        self.compute_dtype = compute_dtype
        self.input_kernel = nn.Parameter(torch.empty(self.input_size, 4 * self.hidden_size))
        self.hidden_kernel = nn.Parameter(torch.empty(self.hidden_size, 4 * self.hidden_size))
        self.hidden_bias = nn.Parameter(torch.zeros(4 * self.hidden_size))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initialisers, one gate at a time: lecun normal input
        kernels (truncated normal, variance 1 / in), orthogonal hidden
        kernels, zero biases."""
        h = self.hidden_size
        std = (1.0 / self.input_size) ** 0.5 / 0.87962566103423978
        for k in range(4):
            w = torch.empty(self.input_size, h)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            self.input_kernel[:, k * h : (k + 1) * h].copy_(w)
            q = torch.empty(h, h)
            nn.init.orthogonal_(q, generator=generator)
            self.hidden_kernel[:, k * h : (k + 1) * h].copy_(q)
        self.hidden_bias.zero_()

    def input_projection(self, x: torch.Tensor) -> torch.Tensor:
        """``dense_i`` of ``x [..., in]``: ``[..., 4H]`` in the compute
        dtype."""
        dt = self.compute_dtype
        return x.to(dt) @ self.input_kernel.to(dt)

    def step(self, carry: Tuple[torch.Tensor, torch.Tensor], dense_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step from ``dense_i`` (:meth:`input_projection` of the
        step's input): the new carry ``(c', h')``; ``h'`` is the output."""
        dt = self.compute_dtype
        c, h = carry
        dense_h = h.to(dt) @ self.hidden_kernel.to(dt) + self.hidden_bias.to(dt)
        i, f, g, o = (dense_h + dense_i).chunk(4, -1)
        i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
        new_c = f * c.to(dt) + i * g
        return new_c, o * torch.tanh(new_c)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """flax's cell call: ``((c', h'), h')``."""
        new_c, new_h = self.step(carry, self.input_projection(x))
        return (new_c, new_h), new_h


ACTIVATIONS = {
    "relu": torch.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "identity": lambda x: x,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation by name; a torch-style class path (``torch.nn.Tanh``)
    names its last part. ``jax.nn.gelu`` is the tanh approximation."""
    key = "identity" if name is None else str(name).rsplit(".", 1)[-1].lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; available: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


class MLP(nn.Module):
    """Dense -> (LayerNorm) -> activation per hidden size, then an output
    Dense when ``output_dim`` is set (flax ``MLP``'s layer order, without
    dropout). ``layers.i`` is flax's ``Dense_i`` and ``norms.i`` its
    ``LayerNorm_i``."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int],
        output_dim: Optional[int] = None,
        activation: str = "relu",
        layer_norm: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if not hidden_sizes and output_dim is None:
            raise ValueError("The number of layers should be at least 1.")
        dims = [in_features, *hidden_sizes] + ([output_dim] if output_dim is not None else [])
        self.layers = nn.ModuleList(Dense(a, b, compute_dtype=compute_dtype) for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(h) for h in hidden_sizes) if layer_norm else None
        self.n_hidden = len(hidden_sizes)
        self.act = get_activation(activation)
        self.output_dim = output_dim if output_dim is not None else (hidden_sizes[-1] if hidden_sizes else in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < self.n_hidden:
                if self.norms is not None:
                    x = self.norms[i](x)
                x = self.act(x)
        return x


class NatureCNN(nn.Module):
    """The DQN Nature conv net on NCHW input: convs of 32, 64, 64 channels,
    kernels 8, 4, 3, strides 4, 2, 1, VALID padding, ReLU, the map flattened
    in CHW order, then ``Dense(features_dim)`` and ReLU when
    ``features_dim`` is set."""

    CHANNELS = (32, 64, 64)
    KERNELS = (8, 4, 3)
    STRIDES = (4, 2, 1)

    def __init__(
        self, in_channels: int, image_size: int, features_dim: Optional[int] = 512, compute_dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        chans = [in_channels, *self.CHANNELS]
        self.convs = nn.ModuleList(
            Conv2d(a, b, k, stride=s, compute_dtype=compute_dtype)
            for a, b, k, s in zip(chans[:-1], chans[1:], self.KERNELS, self.STRIDES)
        )
        side = int(image_size)
        for k, s in zip(self.KERNELS, self.STRIDES):
            side = (side - k) // s + 1
        if side < 1:
            raise ValueError(f"NatureCNN needs images of at least 36 pixels a side, got {image_size}")
        self.map_shape = (self.CHANNELS[-1], side, side)
        flat = self.CHANNELS[-1] * side * side
        self.fc = Dense(flat, features_dim, compute_dtype=compute_dtype) if features_dim is not None else None
        self.output_dim = features_dim if features_dim is not None else flat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.flatten(-3)
        return x if self.fc is None else torch.relu(self.fc(x))
