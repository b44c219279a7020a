"""The fused RSSM recurrent step and its model-sharded variant (port of
``sheeprl_tpu/ops/pallas_gru.py``: ``reference_step``,
``fused_recurrent_step``, ``_make_sharded_proj`` and
``sharded_recurrent_step``).

``fused_recurrent_step`` is the wrapper of the hand-written CUDA kernel in
``csrc/fused_gru.cu``. On CUDA tensors it launches the kernel (or raises),
never the plain ``reference_step``; it computes ``reference_step`` only for
CPU tensors. ``x`` may be fp32 or bf16 (``bf16-mixed`` hands the step bf16
activations, as the JAX ``FusedRecurrentModel`` does); the kernel reads a
bf16 ``x`` as it is and upcasts it as it stages it, as the TPU body does
(``pallas_gru.py:84``), so no cast runs before it. Every other input, and
the result, is fp32. The backward pass recomputes through
``reference_step``, as the JAX custom VJP does (``pallas_gru.py:215-221``),
and returns ``dx`` in ``x``'s type. A model that should run the
plain step on the card selects the plain ``RecurrentModel`` instead
(``fused: flax``).

``sharded_proj`` wraps the second entry of ``csrc/fused_gru.cu``, one model
rank's slice of the joint projection, in the same way: a kernel on CUDA
tensors, the plain ``proj_reference`` on CPU tensors only. The C side plans
its route (``PROJ_ROUTES``): bf16 weights go to the tensor cores where their
columns and address allow 16-byte copies, everything else to the CUDA-core
kernel; neither falls back to the other. Its backward is the three plain
products of the JAX custom VJP (``pallas_gru.py:328-339``).
``sharded_recurrent_step`` runs it SPMD on a (data, model) ``Mesh``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops import _build

KERNEL = "fused_gru"
# calls of each kernel's wrapper that launched it since the last reset (the
# fused step's, those of them with a bf16 x, then the sharded projection's on
# any route, then those of its launches that took the tensor cores); plain CPU
# calls and backward passes do not count. These are Python calls: a call under CUDA-graph capture records
# the launch into the graph and counts once, and the graph's replays launch
# it again without calling the wrapper, so a replayed step's launches are its
# captured calls times its replays (``ops/graph.py::CapturedStep``)
launch_count = 0
bf16_x_launch_count = 0
proj_launch_count = 0
proj_tc_launch_count = 0
# set by ``obs/flops.py::count_flops`` while it counts a step: the kernel's
# products are invisible to ``FlopCounterMode`` (a ctypes launch), so each
# launch reports its own count here
flop_hook: Optional[Callable[[float], None]] = None


def step_flops(batch: int, in_dim: int, dense: int, hidden: int) -> int:
    """The products of one step: ``x @ W1`` and ``[h, feat] @ W2``,
    ``2 B (X D + (H + D) 3H)``."""
    return 2 * batch * (in_dim * dense + (hidden + dense) * 3 * hidden)


def reset_launch_count() -> None:
    global launch_count, bf16_x_launch_count, proj_launch_count, proj_tc_launch_count
    launch_count = 0
    bf16_x_launch_count = 0
    proj_launch_count = 0
    proj_tc_launch_count = 0


def _layer_norm(v: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass LayerNorm over the last axis, as the JAX step takes it."""
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + eps) * g + b


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
    kernel's reference and its backward's recompute target. All fp32 (a
    bf16 ``x`` is upcast first)."""
    x = x.float()
    h = h.float()
    feat = F.silu(_layer_norm(x @ w1 + b1, g1, be1, eps1))
    proj = _layer_norm(torch.cat([h, feat], -1) @ w2, g2, be2, eps2)
    reset, cand, update = proj.chunk(3, -1)
    update = torch.sigmoid(update - 1.0)
    cand = torch.tanh(torch.sigmoid(reset) * cand)
    return update * cand + (1.0 - update) * h


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_gru_forward.restype = i
    lib.fused_gru_forward.argtypes = [p] * 11 + [i] * 5 + [f, f, p]
    lib.fused_gru_step_plan.restype = i
    lib.fused_gru_step_plan.argtypes = [i] * 5 + [ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_gru_split_plan.restype = i
    lib.fused_gru_split_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)]
    lib.sharded_proj_forward.restype = i
    lib.sharded_proj_forward.argtypes = [p, p, p, i, p, p] + [i] * 4 + [p]
    lib.sharded_proj_plan.restype = i
    lib.sharded_proj_plan.argtypes = [i] * 5 + [p, i] + [ctypes.POINTER(i)] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_gru_error_string.restype = ctypes.c_char_p
    lib.fused_gru_error_string.argtypes = [i]


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/fused_gru.cu``."""
    return _build.load(KERNEL, _declare)


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.fused_gru_error_string(err).decode()
        raise RuntimeError(f"fused_gru kernel launch failed: CUDA error {err} ({msg})")


def _run(
    device: torch.device,
    out_shape: Tuple[int, ...],
    scratch_floats: Callable[[ctypes.CDLL, object], int],
    forward: Callable[[ctypes.CDLL, int, int, int], int],
) -> torch.Tensor:
    """One launch of a kernel of the library on ``device``'s current stream:
    ``scratch_floats(lib, floats_ref)`` asks the C side for the scratch size,
    ``forward(lib, out_ptr, scratch_ptr, stream)`` launches. Returns the fp32
    ``out``; raises with CUDA's error text on a non-zero return."""
    lib = load_library()
    with torch.cuda.device(device):  # the C side plans for the current device
        floats = ctypes.c_longlong()
        _raise_on(lib, scratch_floats(lib, ctypes.byref(floats)))
        out = torch.empty(out_shape, dtype=torch.float32, device=device)
        scratch = torch.empty(floats.value, dtype=torch.float32, device=device)
        err = forward(lib, out.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err)
    return out


# the types the kernel reads x in; every other input is fp32
X_DTYPES = (torch.float32, torch.bfloat16)


def _check(args: List[torch.Tensor]) -> Tuple[int, int, int, int]:
    x, h, w1, b1, g1, be1, w2, g2, be2 = args
    names = ("x", "h", "w1", "b1", "g1", "be1", "w2", "g2", "be2")
    dev = x.device
    for n, t in zip(names, args):
        if t.device != dev:
            raise ValueError(f"fused_recurrent_step: {n} is on {t.device}, x on {dev}")
        if n == "x" and t.dtype not in X_DTYPES:
            raise TypeError(f"fused_recurrent_step: x must be float32 or bfloat16, got {t.dtype}")
        if n != "x" and t.dtype != torch.float32:
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


# the fields of fused_gru_step_plan, in its order
STEP_PLAN_FIELDS = (
    "rows_per_tile",
    "row_tiles",
    "cluster_a",
    "chunk_x",
    "chunk_h",
    "cluster_b",
    "chunk_f",
    "blocks_a",
    "blocks_b",
)


def step_plan(batch: int, in_dim: int, dense: int, hidden: int, sm_count: int = 0) -> dict:
    """The plan ``launch`` follows for these sizes on a card of ``sm_count``
    SMs (the current device's when 0), from the C side: the row tile, each
    launch's cluster (the depth splits of a tile) and the depth chunk of
    each product of launch A (``x @ W1``, ``h @ W2[:H]``) and launch B
    (``feat @ W2[H:]``), each launch's blocks, and the floats of scratch."""
    lib = load_library()
    fields = (ctypes.c_int * len(STEP_PLAN_FIELDS))()
    floats = ctypes.c_longlong()
    _raise_on(lib, lib.fused_gru_step_plan(batch, in_dim, dense, hidden, sm_count, fields, ctypes.byref(floats)))
    return {**dict(zip(STEP_PLAN_FIELDS, fields)), "scratch_floats": floats.value}


def _step_scratch_floats(lib: ctypes.CDLL, sizes: Tuple[int, int, int, int], floats) -> int:
    """``fused_gru_step_plan`` on the current device for ``sizes`` (B, X, D,
    H): the scratch floats go to ``floats``; returns the error code."""
    fields = (ctypes.c_int * len(STEP_PLAN_FIELDS))()
    return lib.fused_gru_step_plan(*sizes, 0, fields, floats)


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
    """Run the CUDA kernels on CUDA tensors (no autograd): the two launches
    of ``gru_step``, reading ``x`` in its type (fp32 or bf16); counts one
    launch a step, and one bf16-``x`` launch where ``x`` is bf16."""
    global launch_count, bf16_x_launch_count
    args = [x, h, w1, b1, g1, be1, w2, g2, be2]
    batch, in_dim, dense, hidden = _check(args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_recurrent_step: the CUDA kernel needs CUDA tensors, got {x.device}")
    x_bf16 = int(x.dtype == torch.bfloat16)
    out = _run(
        x.device,
        (batch, hidden),
        lambda lib, floats: _step_scratch_floats(lib, (batch, in_dim, dense, hidden), floats),
        lambda lib, out, scratch, stream: lib.fused_gru_forward(
            *(t.data_ptr() for t in args),
            out,
            scratch,
            batch,
            in_dim,
            dense,
            hidden,
            x_bf16,
            float(eps1),
            float(eps2),
            stream,
        ),
    )
    launch_count += 1
    bf16_x_launch_count += x_bf16
    if flop_hook is not None:
        flop_hook(step_flops(batch, in_dim, dense, hidden))
    return out


class _FusedStep(torch.autograd.Function):
    """Forward by the kernel (plain version on CPU tensors); backward by
    recompute through ``reference_step``, saving only the inputs (``dx``
    comes back in ``x``'s type, as the JAX VJP's)."""

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
    ``w2 [H+D, 3H]``, ``g2/be2 [3H]`` -> new ``h [B, H]`` (fp32). ``x`` is
    fp32 or bf16, every other input fp32.
    """
    return _FusedStep.apply(float(eps1), float(eps2), x, h, w1, b1, g1, be1, w2, g2, be2)


# --------------------------------------------------------------------------- #
# model-sharded step: one rank's W2 slice, LayerNorm statistics by psum, the
# new state by one tiled all-gather
# --------------------------------------------------------------------------- #

PROJ_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def proj_reference(h: torch.Tensor, feat: torch.Tensor, w2s: torch.Tensor) -> torch.Tensor:
    """Plain version of the sharded projection (``pallas_gru.py:271-279``):
    ``h @ W2s[:H] + feat @ W2s[H:]`` with W2s upcast to fp32."""
    hidden = h.shape[1]
    return h @ w2s[:hidden].float() + feat @ w2s[hidden:].float()


def _check_proj(h: torch.Tensor, feat: torch.Tensor, w2s: torch.Tensor) -> Tuple[int, int, int, int]:
    for n, t in (("h", h), ("feat", feat), ("w2s", w2s)):
        if t.device != h.device:
            raise ValueError(f"sharded_proj: {n} is on {t.device}, h on {h.device}")
        if t.dim() != 2:
            raise ValueError(f"sharded_proj: {n} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"sharded_proj: {n} must be contiguous")
    for n, t in (("h", h), ("feat", feat)):
        if t.dtype != torch.float32:
            raise TypeError(f"sharded_proj: {n} must be float32, got {t.dtype}")
    if w2s.dtype not in PROJ_WEIGHT_DTYPES:
        raise TypeError(f"sharded_proj: w2s must be float32 or bfloat16, got {w2s.dtype}")
    (batch, hidden), (fbatch, dense) = h.shape, feat.shape
    if batch < 1 or fbatch != batch:
        raise ValueError(f"sharded_proj: h {tuple(h.shape)} and feat {tuple(feat.shape)} need the same B >= 1 rows")
    if w2s.shape[0] != hidden + dense or w2s.shape[1] < 1:
        raise ValueError(f"sharded_proj: w2s has shape {tuple(w2s.shape)}, expected [{hidden + dense}, C]")
    return batch, hidden, dense, w2s.shape[1]


# the routes of sharded_proj_plan, by its C codes: the CUDA-core kernel, and
# the tensor-core kernel at 16 and at 64 batch rows a block
PROJ_ROUTES = ("splitk", "tc16", "tc64")


def _plan(lib: ctypes.CDLL, sizes: Tuple[int, int, int, int], w2s: torch.Tensor, sm_count: int, floats):
    """``sharded_proj_plan`` on the C side for ``sizes`` (B, H, D, C): returns
    its error code, route code, depth splits and chunk; the scratch floats go
    to ``floats``."""
    route, splits, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    bf16 = int(w2s.dtype == torch.bfloat16)
    outs = (ctypes.byref(route), ctypes.byref(splits), ctypes.byref(chunk), floats)
    err = lib.sharded_proj_plan(*sizes, bf16, w2s.data_ptr(), sm_count, *outs)
    return err, route.value, splits.value, chunk.value


def proj_plan(h: torch.Tensor, feat: torch.Tensor, w2s: torch.Tensor, sm_count: int = 0) -> Tuple[str, int, int, int]:
    """The plan ``proj_launch`` follows for these CUDA tensors on a card of
    ``sm_count`` SMs (their device's when 0): route (``PROJ_ROUTES``), depth
    splits, depth chunk and floats of scratch."""
    lib = load_library()
    floats = ctypes.c_longlong()
    with torch.cuda.device(h.device):
        err, route, splits, chunk = _plan(lib, _check_proj(h, feat, w2s), w2s, sm_count, ctypes.byref(floats))
    _raise_on(lib, err)
    return PROJ_ROUTES[route], splits, chunk, floats.value


def proj_launch(h: torch.Tensor, feat: torch.Tensor, w2s: torch.Tensor) -> torch.Tensor:
    """Run the projection kernel on CUDA tensors (no autograd); counts one
    launch, and one tensor-core launch where the plan took that route."""
    global proj_launch_count, proj_tc_launch_count
    batch, hidden, dense, cols = _check_proj(h, feat, w2s)
    if h.device.type != "cuda":
        raise ValueError(f"sharded_proj: the CUDA kernel needs CUDA tensors, got {h.device}")
    bf16 = int(w2s.dtype == torch.bfloat16)
    plan = []

    def scratch_floats(lib, floats):
        plan[:] = _plan(lib, (batch, hidden, dense, cols), w2s, 0, floats)
        return plan[0]

    out = _run(
        h.device,
        (batch, cols),
        scratch_floats,
        lambda lib, out, scratch, stream: lib.sharded_proj_forward(
            h.data_ptr(), feat.data_ptr(), w2s.data_ptr(), bf16, out, scratch, batch, hidden, dense, cols, stream
        ),
    )
    proj_launch_count += 1
    if PROJ_ROUTES[plan[1]] != "splitk":
        proj_tc_launch_count += 1
    return out


class _ShardedProj(torch.autograd.Function):
    """Forward by the kernel (plain version on CPU tensors); backward by the
    three plain products of ``pallas_gru.py:328-339``, dW2s cast to W2s's
    storage type."""

    @staticmethod
    def forward(ctx, h, feat, w2s):
        ctx.save_for_backward(h, feat, w2s)
        if h.device.type == "cpu":
            _check_proj(h, feat, w2s)
            return proj_reference(h, feat, w2s)
        return proj_launch(h, feat, w2s)

    @staticmethod
    def backward(ctx, grad):
        h, feat, w2s = ctx.saved_tensors
        hidden = h.shape[1]
        grad = grad.float()
        dh = df = dw2s = None
        if ctx.needs_input_grad[0]:
            dh = grad @ w2s[:hidden].float().t()
        if ctx.needs_input_grad[1]:
            df = grad @ w2s[hidden:].float().t()
        if ctx.needs_input_grad[2]:
            dw2s = torch.cat([h.t() @ grad, feat.t() @ grad], 0).to(w2s.dtype)
        return dh, df, dw2s


def sharded_proj(h: torch.Tensor, feat: torch.Tensor, w2s: torch.Tensor) -> torch.Tensor:
    """``[h, feat] @ W2s`` for one rank's slice ``W2s [H+D, C]`` (fp32 or
    bf16 storage, fp32 sums) -> ``[B, C]`` fp32 (``pallas_gru.py:282-341``).
    Any size: the port has no VMEM gate (``_proj_tile_b``)."""
    return _ShardedProj.apply(h, feat, w2s)


def sharded_recurrent_step(
    x: torch.Tensor,
    h: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    g1: torch.Tensor,
    be1: torch.Tensor,
    w2s: torch.Tensor,
    g2s: torch.Tensor,
    be2s: torch.Tensor,
    *,
    mesh,
    use_pallas: bool = True,
    eps1: float = 1e-3,
    eps2: float = 1e-5,
) -> torch.Tensor:
    """Model-sharded fused step on one rank, numerically ``reference_step``
    (``pallas_gru.py:344-442``, its ``local_step`` run SPMD).

    Each rank of the ``mesh`` (``parallel.mesh.Mesh``) passes its data shard
    of ``x [B, X]`` and ``h [B, H]``, the replicated ``w1, b1, g1, be1``, and
    its own gate-major slice of the joint projection: ``w2s [H+D, 3H/mp]``
    (fp32 or bf16) and ``g2s, be2s [3H/mp]``, as
    ``algos.dreamer_v3.convert.shard_recurrent`` cuts them. The rank with
    model coordinate ``idx`` owns hidden columns ``idx*H/mp : (idx+1)*H/mp``
    of all three gates. Steps: the input projection; the ``[B, 3, H/mp]``
    projection (``sharded_proj``, or its plain version when ``use_pallas``
    is False); the LayerNorm over the global 3H from two ``psum``s over the
    model group (mean, then the centred second moment); the gates on the
    local columns; the new ``h [B, H]`` by one tiled all-gather. Gradients
    are the global ones on every model rank; over the data axis the caller
    sums the replicated weights' gradients, as data parallelism does.
    Requires ``H % mp == 0``.
    """
    from sheeprl_tpu_torch.parallel.collectives import all_gather_tiled, psum, to_model_region

    hidden = h.shape[-1]
    mp = mesh.model_parallel_size
    if hidden % mp != 0:
        raise ValueError(f"hidden ({hidden}) must divide by the model axis ({mp})")
    hs = hidden // mp
    dense = w1.shape[-1]
    want = {"w2s": (hidden + dense, 3 * hs), "g2s": (3 * hs,), "be2s": (3 * hs,)}
    for n, t in (("w2s", w2s), ("g2s", g2s), ("be2s", be2s)):
        if tuple(t.shape) != want[n]:
            raise ValueError(f"sharded_recurrent_step: {n} has shape {tuple(t.shape)}, expected {want[n]} for mp={mp}")
    group = mesh.model_group
    idx = mesh.coords[1]
    x, h, w1, b1, g1, be1 = (to_model_region(t, group) for t in (x, h, w1, b1, g1, be1))
    x = x.float()
    h = h.float()
    feat = F.silu(_layer_norm(x @ w1 + b1, g1, be1, eps1))
    pre = (sharded_proj if use_pallas else proj_reference)(h, feat, w2s).reshape(-1, 3, hs)
    n = 3 * hidden
    mu = psum(pre.sum(dim=(1, 2)), group)[:, None, None] / n
    var = psum((pre - mu).square().sum(dim=(1, 2)), group)[:, None, None] / n
    proj = (pre - mu) * torch.rsqrt(var + eps2) * g2s.reshape(3, hs) + be2s.reshape(3, hs)
    update = torch.sigmoid(proj[:, 2] - 1.0)
    cand = torch.tanh(torch.sigmoid(proj[:, 0]) * proj[:, 1])
    h_new = update * cand + (1.0 - update) * h[:, idx * hs : (idx + 1) * hs]
    return all_gather_tiled(h_new, group)
