"""The fused RSSM recurrent step (port of ``sheeprl_tpu/ops/pallas_gru.py``:
``reference_step`` and ``fused_recurrent_step``).

``fused_recurrent_step`` is the wrapper of the hand-written CUDA kernel in
``csrc/fused_gru.cu``. On CUDA tensors it launches the kernel (or raises),
never the plain ``reference_step``; it computes ``reference_step`` only for
CPU tensors. The backward pass recomputes through ``reference_step``, as the
JAX custom VJP does (``pallas_gru.py:215-221``). A model that should run the
plain step on the card selects the plain ``RecurrentModel`` instead
(``fused: flax``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops import _build

KERNEL = "fused_gru"
# launches of the CUDA kernel since the last reset; plain CPU calls and
# backward recomputes do not count
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def reference_step(
    x: torch.Tensor,
    h: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    g1: torch.Tensor,
    be1: torch.Tensor,
    w2: torch.Tensor,
    g2: torch.Tensor,
    be2: torch.Tensor,
    eps1: float = 1e-3,
    eps2: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of the step (``pallas_gru.py:51-80``): the
    kernel's reference and its backward's recompute target. All fp32."""
    x = x.float()
    h = h.float()

    def _ln(v, g, b, eps):
        mu = v.mean(-1, keepdim=True)
        var = (v - mu).square().mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + eps) * g + b

    feat = F.silu(_ln(x @ w1 + b1, g1, be1, eps1))
    proj = _ln(torch.cat([h, feat], -1) @ w2, g2, be2, eps2)
    reset, cand, update = proj.chunk(3, -1)
    update = torch.sigmoid(update - 1.0)
    cand = torch.tanh(torch.sigmoid(reset) * cand)
    return update * cand + (1.0 - update) * h


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_gru_forward.restype = i
    lib.fused_gru_forward.argtypes = [p] * 11 + [i] * 4 + [f, f, p]
    lib.fused_gru_scratch_floats.restype = i
    lib.fused_gru_scratch_floats.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_gru_split_plan.restype = i
    lib.fused_gru_split_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.fused_gru_error_string.restype = ctypes.c_char_p
    lib.fused_gru_error_string.argtypes = [i]


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/fused_gru.cu``."""
    return _build.load(KERNEL, _declare)


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.fused_gru_error_string(err).decode()
        raise RuntimeError(f"fused_gru kernel launch failed: CUDA error {err} ({msg})")


def _check(args: List[torch.Tensor]) -> Tuple[int, int, int, int]:
    x, h, w1, b1, g1, be1, w2, g2, be2 = args
    names = ("x", "h", "w1", "b1", "g1", "be1", "w2", "g2", "be2")
    dev = x.device
    for n, t in zip(names, args):
        if t.device != dev:
            raise ValueError(f"fused_recurrent_step: {n} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_recurrent_step: {n} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_recurrent_step: {n} must be contiguous")
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"fused_recurrent_step: x {tuple(x.shape)} and h {tuple(h.shape)} must be [B, X] and [B, H]")
    batch, in_dim = x.shape
    hidden = h.shape[1]
    dense = w1.shape[-1]
    want = {
        "w1": (in_dim, dense),
        "b1": (dense,),
        "g1": (dense,),
        "be1": (dense,),
        "w2": (hidden + dense, 3 * hidden),
        "g2": (3 * hidden,),
        "be2": (3 * hidden,),
    }
    for n, t in zip(names[2:], args[2:]):
        if tuple(t.shape) != want[n]:
            raise ValueError(f"fused_recurrent_step: {n} has shape {tuple(t.shape)}, expected {want[n]}")
    return batch, in_dim, dense, hidden


def launch(
    x: torch.Tensor,
    h: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    g1: torch.Tensor,
    be1: torch.Tensor,
    w2: torch.Tensor,
    g2: torch.Tensor,
    be2: torch.Tensor,
    eps1: float = 1e-3,
    eps2: float = 1e-5,
) -> torch.Tensor:
    """Run the CUDA kernel on CUDA tensors (no autograd); counts one launch."""
    global launch_count
    args = [x, h, w1, b1, g1, be1, w2, g2, be2]
    batch, in_dim, dense, hidden = _check(args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_recurrent_step: the CUDA kernel needs CUDA tensors, got {x.device}")
    lib = load_library()
    with torch.cuda.device(x.device):  # the C side plans for the current device
        floats = ctypes.c_longlong()
        _raise_on(lib, lib.fused_gru_scratch_floats(batch, in_dim, dense, hidden, ctypes.byref(floats)))
        out = torch.empty((batch, hidden), dtype=torch.float32, device=x.device)
        scratch = torch.empty(floats.value, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_gru_forward(
            *(t.data_ptr() for t in (*args, out, scratch)),
            batch, in_dim, dense, hidden, float(eps1), float(eps2), stream,
        )
    _raise_on(lib, err)
    launch_count += 1
    return out


class _FusedStep(torch.autograd.Function):
    """Forward by the kernel (plain version on CPU tensors); backward by
    recompute through ``reference_step``, saving only the inputs."""

    @staticmethod
    def forward(ctx, eps1, eps2, *args):
        ctx.eps = (eps1, eps2)
        ctx.save_for_backward(*args)
        if args[0].device.type == "cpu":
            _check(list(args))
            return reference_step(*args, eps1=eps1, eps2=eps2)
        return launch(*args, eps1=eps1, eps2=eps2)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = reference_step(*inputs, eps1=ctx.eps[0], eps2=ctx.eps[1])
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def fused_recurrent_step(
    x: torch.Tensor,
    h: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    g1: torch.Tensor,
    be1: torch.Tensor,
    w2: torch.Tensor,
    g2: torch.Tensor,
    be2: torch.Tensor,
    *,
    eps1: float = 1e-3,
    eps2: float = 1e-5,
) -> torch.Tensor:
    """Fused Dense->LN->SiLU->LayerNorm-GRU step (``pallas_gru.py:224-249``).

    Shapes: ``x [B, X]``, ``h [B, H]``, ``w1 [X, D]``, ``b1/g1/be1 [D]``,
    ``w2 [H+D, 3H]``, ``g2/be2 [3H]`` -> new ``h [B, H]`` (fp32).
    """
    return _FusedStep.apply(float(eps1), float(eps2), x, h, w1, b1, g1, be1, w2, g2, be2)
