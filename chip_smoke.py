#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (``/usr/local/cuda``); without a card, or outside the
repository, it exits non-zero and prints no result. Phases, any failure of
which exits non-zero:

1. Card and build: the card's name and power limit, then every kernel built
   from ``sheeprl_tpu_torch/csrc`` (build seconds and ptxas's report).
2. Kernel against plain: ``fused_recurrent_step`` against ``reference_step``
   at the Dreamer-V3 S shapes (B = 1, 4, 16 and the imagination batch 1024)
   and at M width, forward and gradients, then the device time of the kernel
   and of the plain version (CUDA-event time of a replayed CUDA graph, L2
   warm), the kernel's L2-cold time (a buffer of twice the L2 written before
   each call, its own time subtracted), each of its launches' device time
   per call (torch.profiler over the graph's replays), its launch plan and,
   apart, the time per call issued from Python.
3. The slice: the Dreamer-V3 S player (seeded init, 4 PixelCatcher envs)
   and one capped ``evaluate()`` episode, with the kernel launch count held
   to one per step; a torch.profiler window over 8 player steps (device busy
   time, idle share, the fused step's share of it, top kernels); then the
   same observations replayed through the fused and the plain
   (``fused="flax"``) players in mode/greedy, h compared.
4. The model-sharded step (``sharded_recurrent_step``): (a) its projection
   kernel ``sharded_proj`` against its plain version at one rank's shapes
   (S mp=1 fp32 B=4; L/4-way bf16 at B=16, 64, 256 and 1024; XL/16-way bf16
   at B=16 and B=1024), with the route the plan took (``splitk`` on the CUDA
   cores, ``tc16``/``tc64`` on the tensor cores), device, plain, library (one
   cuBLAS ``torch.mm``) and per-call host times beside the bound and the
   fp32-rate bound of earlier rows, and its max abs error at most 1e-5 at
   every shape; (b) the full-width step on a 1-rank NCCL mesh
   (file store in a temporary directory): S fp32 at B=4 and B=16 against
   ``fused_recurrent_step`` and ``reference_step``, XL with bf16 W2 at B=16
   against ``reference_step`` on the upcast W2, and the S gradients of all
   nine inputs against plain autograd, with the projection kernel launched
   once per step, on the tensor cores for the bf16 step; then the S steps again with ``use_pallas=False`` (the
   plain projection: no launch, the same h'), and the S B=4 step once more
   on one CUDA rank spawned by ``parallel.launch.run`` (its default device,
   NCCL), against the same h'. (a) holds the kernel at every projection
   shape (b) gives it: S mp=1 fp32 at B=4 and B=16, XL mp=1 bf16 at B=16.
6. Training at Dreamer-V3 S width (B=16 sequences of T=64, horizon 15, 4
   PixelCatcher envs, fp32): (a) one batch drawn from the port's replay,
   filled by PixelCatcher steps, through one ``make_train_step`` with the
   kernel (``fused: auto``) and one with the plain ``RecurrentModel``
   (``fused: flax``) from the same seeded weights, with deterministic
   samplers; the 13 metrics and the world-model gradients held within
   their printed bounds; (b) ``fused_gru`` launched 64 (scan, B=16) + 16
   (imagination, B=1024) times a step, and one continuous-action step (the
   dummy env) whose actor gradient runs back through B1 at B=1024; (c) ms
   per gradient step, fused and plain in turns, then a torch.profiler
   window over each (idle share, B1's share and time per call at B=16 and
   B=1024, device and host time of each RSSM step, top kernels); (d)
   ``main()`` for a few hundred env steps with the cuts printed, its
   env-steps/s and gradient steps/s, the kernel's launches counted (each
   gradient step is a replay of the captured step: the wrapper's calls
   outside capture, plus the 80 calls captured times the replays).
7. The captured train step (``ops/graph.py``, as ``main`` builds it): (a)
   three replays against three eager steps from the same weights and
   batches, discrete (PixelCatcher) and continuous (the dummy env), smooth
   samplers and cuDNN's deterministic algorithms: metrics, parameters and
   Moments within ``REPLAY_BOUND``, Adam's count 3, 80 kernel calls
   captured; (b) with the real samplers, a replay after the generator moved
   on differs from the first, and re-setting the generator reproduces it;
   (c) ms per gradient step replayed and eager, with B1 and with the plain
   recurrent model (CUDA events), and torch.profiler over replays: device
   busy and idle share, ``gru_step`` kernels a replayed step (2 x 80); (d)
   ``main()`` with a checkpoint every 64 policy steps and a forced NaN (one
   rollback to the newest committed checkpoint), then a second ``main()``
   resuming from it (``checkpoint.resume_from=auto``) to its end.
8. The default precision, ``bf16-mixed`` (fp32 parameters, bf16 compute;
   phases 3, 6 and 7 pin ``fabric.precision: 32-true``): (a) B1 reading a
   bf16 x at S B=4, 16 and 1024 against ``reference_step`` on the same x
   (forward 1e-5, gradients 1e-4, dx in bf16), with its device time beside
   the fp32-x time and the bound with x at 2 bytes; (b) one eager S step
   with B1 against the plain recurrent model at bf16 and against the fp32
   B1 step (metrics and gradients within their printed bounds), 80 B1
   calls a step, each with a bf16 x; (c) replayed against eager as 7(a);
   (d) ms per replayed step, B1 and plain, bf16 and fp32, in turns, and a
   profiler window over each bf16 step (idle share, top kernels, B1's
   share); (e) ``main()``'s short loop: env-steps/s and gradient steps/s;
   (f) the S player: ms a step and env-steps/s. Alone on the card:
   ``python -c 'import chip_smoke as c, numpy as np, torch; from
   sheeprl_tpu_torch.ops import fused_gru as fg; c.phase_bf16_kernel(torch,
   fg, c.BF16_KERNEL_SHAPES); rb, s, a, k = c.filled_replay(np,
   c.train_cfg("pixel_catcher"), 80); c.phase_bf16_train(torch, np, fg, rb,
   s, a, k)'`` (and ``phase_bf16_timing``, ``phase_bf16_player`` alike).
9. Replay where the JAX package keeps it, at bf16-mixed: (a) the ring
   (``data/device_buffer.py``): ``buffer.device=auto`` picks it at the
   Atari-100k shape (buffer.size 100000, 1 env, 64x64x3), its bytes within
   1% of the estimate; a ring and a host buffer fed the same steps gather
   the same windows bit for bit; 10^4 in-graph draws start only where the
   host allows, each env's share within 3 sigma of uniform; (b) a superstep
   of K = 4 steps over pregathered batches (``ops/superstep.py``) against
   four replays of the per-step graph with the host EMA: metrics,
   parameters, target critic, Adam state and Moments within
   ``REPLAY_BOUND`` (bit for bit reported), 4 x 160 ``gru_step`` kernels a
   superstep replay in the profiler; (c) ms per gradient step (in turns),
   the device's idle share, host-to-device bytes and peak memory of four
   replay paths: host buffer and ring, K = 0 and K = 4 (and the K = 1
   ring's peak memory); (d) ``main()`` at 8(e)'s cuts with buffer.size
   100000: the memmapped host buffer, the ring per step, the ring with
   K = 4 (env-steps/s, gradient steps/s, the kernel's launches), then the
   drill: the ring checkpointed with ``buffer.checkpoint``, its contents
   restored into a memmapped host buffer and back, and ``main()`` resumed
   on the host buffer and from there on the ring. Alone on the card:
   ``python -c 'import chip_smoke as c, numpy as np, torch, tempfile; from
   sheeprl_tpu_torch.ops import fused_gru as fg; c.phase_ring(torch, np);
   rb, s, a, k = c.filled_replay(np, c.train_cfg("pixel_catcher"), 80);
   c.phase_superstep_parity(torch, np, rb, s, a, k);
   c.phase_replay_paths(torch, np, rb, s, a, k); d = tempfile.mkdtemp();
   c.phase_ring_loops(torch, np, fg, d); c.phase_ring_drill(torch, np, d)'``.
10. The entry point, ``python -m sheeprl_tpu_torch``, at 8(e)'s cuts
   (``CLI_CUTS``: S width, bf16-mixed, the ring, a log window every 64 env
   steps, a checkpoint every 128 with the ring in it), each command in a
   temporary cwd with its logs and run registry under a temporary
   directory: (a) ``exp=dreamer_v3 env=pixel_catcher
   metric.telemetry.enabled=True`` in a subprocess (exit 0, ``config.yaml``,
   an event file the port's reader decodes with every train metric and
   ``Time/sps_*`` at each window after learning starts and rewards where
   episodes ended, all finite, heartbeats naming the card with a device
   memory peak and 0 < MFU <= 1, one ``completed`` record), then the same
   argv in this process through ``cli.run`` for the kernel's launches; (b)
   ``python -m sheeprl_tpu_torch.cli_eval`` on (a)'s last checkpoint, one
   episode capped at ``EVAL_CAP`` steps, and its eval record; (c) the CLI
   resuming (a)'s mid-run checkpoint with ``fabric.precision=32-true`` on
   the command line: the stored config with that override, trained to the
   end; (d) env-steps/s of the in-process run with telemetry on and off
   beside 8(e)'s loop, FLOPs a gradient step and the heartbeat's MFU, with
   the card's name and power limit. Alone on the card: ``python -c 'import
   chip_smoke as c, numpy as np, torch, tempfile; from sheeprl_tpu_torch.ops
   import fused_gru as fg; fg.load_library(); n, r = c.phase_train_loop(torch,
   np, fg, tempfile.mkdtemp(), c.BF16, "bf16_train_loop");
   c.phase_cli(torch, np, fg, tempfile.mkdtemp(), r)'``.
5. The kernels line (JSON), then the device line (JSON) last.

TF32 is off for every phase (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so the plain versions compute in full
fp32 like the kernels, and the fp32 heads of phase 8 in fp32.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from unittest import mock

# forward tolerance of the kernel against its plain version: both are fp32
# with sums taken in another order (the JAX package holds its own kernel to
# the same 1e-5, tests/test_ops/test_pallas_gru.py)
FWD_TOL = 1e-5
# gradients: the backward recomputes through the plain version
GRAD_TOL = 1e-4
# h trajectories of the fused and plain players over the replayed steps:
# per-step fp32 differences of ~1e-6 carried through the recurrence
TRAJ_TOL = 1e-4
# the sharded step with a bf16 W2 against reference_step on the upcast W2:
# the same values in fp32, with XL's 12288-wide LayerNorm summed in another
# order
BF16_STEP_TOL = 1e-4

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# bf16 passes the tensor-core route makes over each product: the fp32
# activations split into three bf16 planes
TC_PLANES = 3

# the device work of one fused_gru step, by profiler name: the two launches
# of gru_step
FUSED_GRU_KERNELS = ("gru_step",)

PLAYER_STEPS = 32
EVAL_CAP = 64
SEED = 5
# phases 2-7 pin fp32; phase 8 runs the default, bf16-mixed
# (configs/fabric/default.yaml:8, kept by exp=dreamer_v3)
FP32 = "32-true"
BF16 = "bf16-mixed"


def clocks_line() -> str:
    """The card's SM clock, its maximum, power draw and temperature now, as
    ``nvidia-smi`` reads them: beside a timing, they tell a slower card
    state from a slower program."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gru_args(torch, batch: int, in_dim: int, dense: int, hidden: int, gen):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    return [
        r(batch, in_dim),
        r(batch, hidden),
        r(in_dim, dense, scale=in_dim**-0.5),
        r(dense, scale=0.1),
        1 + r(dense, scale=0.1),
        r(dense, scale=0.1),
        r(hidden + dense, 3 * hidden, scale=(hidden + dense) ** -0.5),
        1 + r(3 * hidden, scale=0.1),
        r(3 * hidden, scale=0.1),
    ]


def gru_bound_ms(batch: int, in_dim: int, dense: int, hidden: int, x_bytes: int = 4):
    """Least time of one step on the card: each input read once (x at
    ``x_bytes`` a value: 4 for fp32, 2 for bf16) and the output written once
    over the HBM rate, against the two products' FLOPs over the fp32 rate.
    Returns (ms, 'bytes' or 'operations')."""
    floats = (
        batch * hidden
        + in_dim * dense
        + 3 * dense
        + (hidden + dense) * 3 * hidden
        + 2 * 3 * hidden
        + batch * hidden
    )
    flops = 2 * batch * in_dim * dense + 2 * batch * (hidden + dense) * 3 * hidden
    t_bytes = (4 * floats + x_bytes * batch * in_dim) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def host_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """CUDA-event time of one ``fn()`` call issued back to back from Python:
    where the launches are short, the host's dispatch sets this pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(torch, fn, calls: int):
    """``calls`` calls of ``fn()`` captured in one CUDA graph, after three
    warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(torch, graph, replays: int) -> float:
    """CUDA-event time of one replay of ``graph``, over ``replays`` replays."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def device_ms(torch, fn, calls: int = 20, replays: int = 50) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events, so the
    host is out of the loop. The inputs stay in the 50 MB L2 between calls."""
    graph = capture(torch, fn, calls)
    ms = replay_ms(torch, graph, replays) / calls
    del graph
    return ms


def cold_device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call that finds its inputs out of L2:
    before each captured call a buffer of twice the card's L2 is written; a
    graph of those writes alone is timed and subtracted."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    flush = torch.empty(2 * l2 // 4, dtype=torch.float32, device="cuda")

    def cold():
        flush.zero_()
        fn()

    both = capture(torch, cold, calls)
    alone = capture(torch, flush.zero_, calls)
    ms = (replay_ms(torch, both, replays) - replay_ms(torch, alone, replays)) / calls
    del both, alone, flush
    return ms


def launch_breakdown_us(torch, fn, calls: int = 20, replays: int = 10):
    """Device time of each launch of one ``fn()`` call, from torch.profiler
    over replays of a captured graph: [[position: kernel name, us per call],
    ...] in launch order, or None where the profiler saw no device work."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = capture(torch, fn, calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    events = sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start
    )
    per_call = len(events) // (replays * calls)
    if not events or per_call * replays * calls != len(events):
        return None
    rows = []
    for i in range(per_call):
        name = re.sub(r"\(.*", "", events[i].name.replace("(anonymous namespace)::", "").replace("void ", ""))
        us = sum(e.time_range.elapsed_us() for e in events[i::per_call]) / (replays * calls)
        rows.append([f"{i}: {name}", us])
    return rows


def phase_kernel(torch, fg, shapes):
    """Kernel against reference_step on the card: forward and gradients at
    every shape, times at every shape. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    rows = []
    for name, (batch, in_dim, dense, hidden) in shapes.items():
        args = gru_args(torch, batch, in_dim, dense, hidden, gen)
        with torch.no_grad():
            got = fg.launch(*args)
            want = fg.reference_step(*args)
        torch.cuda.synchronize()
        if got.shape != (batch, hidden) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output is not finite [{batch}, {hidden}]")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(f"{name}: kernel forward differs from reference_step by {err}")
        worst = max(worst, err)

        leaves = [a.clone().requires_grad_(True) for a in args]
        cot = torch.randn(batch, hidden, device="cuda", generator=gen)
        out = fg.fused_recurrent_step(*leaves)
        g_kernel = torch.autograd.grad(out, leaves, cot)
        ref_leaves = [a.clone().requires_grad_(True) for a in args]
        g_plain = torch.autograd.grad(fg.reference_step(*ref_leaves), ref_leaves, cot)
        gerr = max((a - b).abs().max().item() for a, b in zip(g_kernel, g_plain))
        for a, b in zip(g_kernel, g_plain):
            if not torch.allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL):
                raise AssertionError(f"{name}: gradients differ from reference_step by {gerr}")

        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.launch(*args))
            plain_ms = device_ms(torch, lambda: fg.reference_step(*args))
            cold_ms = cold_device_ms(torch, lambda: fg.launch(*args))
            launches = launch_breakdown_us(torch, lambda: fg.launch(*args))
            call_ms = host_ms(torch, lambda: fg.launch(*args))
            plain_call_ms = host_ms(torch, lambda: fg.reference_step(*args))
        bound_ms, bound_by = gru_bound_ms(batch, in_dim, dense, hidden)
        row = {
            "shape": name,
            "B": batch,
            "X": in_dim,
            "D": dense,
            "H": hidden,
            "max_abs_err": err,
            "grad_max_abs_err": gerr,
            "ms": ms,
            "l2_cold_ms": cold_ms,
            "launches_us": launches,
            "plain_ms": plain_ms,
            "host_call_ms": call_ms,
            "plain_host_call_ms": plain_call_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plan": fg.step_plan(batch, in_dim, dense, hidden),
        }
        rows.append(row)
        print("fused_gru " + json.dumps(row), flush=True)
        print(
            f"fused_gru {name}: device time (CUDA graph) kernel {1e3 * ms:.1f} us (L2 cold {1e3 * cold_ms:.1f} us),"
            f" plain {1e3 * plain_ms:.1f} us,"
            f" bound {1e3 * bound_ms:.2f} us ({'memory' if bound_by == 'bytes' else 'fp32 arithmetic'} bounds it);"
            f" per call from the host kernel {1e3 * call_ms:.1f} us, plain {1e3 * plain_call_ms:.1f} us;"
            " no library time: no single PyTorch call computes this step",
            flush=True,
        )
    return worst, rows


def proj_bound_ms(batch: int, hidden: int, dense: int, cols: int, w_bytes: int):
    """Least time of one sharded projection: h, feat and W2s (at its storage
    width) read once and out written once over the HBM rate, against its
    operations: for bf16 W2s the three bf16 passes of the fp32-exact product
    over the tensor cores' bf16 rate, for fp32 W2s its FLOPs over the fp32
    rate. Returns (ms, 'bytes' or 'operations', ms of the fp32-rate bound
    that rows of earlier PRs give for either storage)."""
    nbytes = 4 * batch * (hidden + dense + cols) + w_bytes * (hidden + dense) * cols
    flops = 2 * batch * (hidden + dense) * cols
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fp32 = flops / FP32_FLOP_PER_S
    t_ops = TC_PLANES * flops / BF16_TC_FLOP_PER_S if w_bytes == 2 else t_fp32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * max(t_bytes, t_fp32)


def phase_proj(torch, fg, shapes):
    """sharded_proj's kernel against its plain version at one rank's shapes,
    and its times. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    rows = []
    for name, (batch, hidden, dense, cols, w_dtype) in shapes.items():
        h = torch.randn(batch, hidden, device="cuda", generator=gen).tanh()
        feat = torch.nn.functional.silu(torch.randn(batch, dense, device="cuda", generator=gen))
        w2s = (torch.randn(hidden + dense, cols, device="cuda", generator=gen) * (hidden + dense) ** -0.5).to(w_dtype)
        route = fg.proj_plan(h, feat, w2s)[0]
        tc_before = fg.proj_tc_launch_count
        with torch.no_grad():
            got = fg.proj_launch(h, feat, w2s)
            want = fg.proj_reference(h, feat, w2s)
        torch.cuda.synchronize()
        if fg.proj_tc_launch_count - tc_before != (route != "splitk"):
            raise AssertionError(f"sharded_proj {name}: the tensor-core count does not follow route {route}")
        if got.shape != (batch, cols) or not torch.isfinite(got).all():
            raise AssertionError(f"sharded_proj {name}: kernel output is not finite [{batch}, {cols}]")
        err = (got - want).abs().max().item()
        if err > FWD_TOL:
            raise AssertionError(f"sharded_proj {name}: kernel differs from its plain version by {err}")
        worst = max(worst, err)
        # the library call: one cuBLAS product on the concatenated activations
        # and an fp32 copy of W2s, both made outside the timing (for a bf16
        # slice it reads twice the weight bytes the kernel reads)
        hf = torch.cat([h, feat], 1)
        w2f = w2s.float()
        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.proj_launch(h, feat, w2s))
            plain_ms = device_ms(torch, lambda: fg.proj_reference(h, feat, w2s))
            library_ms = device_ms(torch, lambda: torch.mm(hf, w2f))
            call_ms = host_ms(torch, lambda: fg.proj_launch(h, feat, w2s))
        bound_ms, bound_by, fp32_bound_ms = proj_bound_ms(batch, hidden, dense, cols, w2s.element_size())
        row = {
            "shape": name,
            "B": batch,
            "H": hidden,
            "D": dense,
            "C": cols,
            "w2s_dtype": str(w_dtype).replace("torch.", ""),
            "route": route,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "host_call_ms": call_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "fp32_bound_ms": fp32_bound_ms,
        }
        rows.append(row)
        print("sharded_proj " + json.dumps(row), flush=True)
        del h, feat, w2s, hf, w2f, got, want
    return worst, rows


def np_gru_args(np, seed: int, batch: int, in_dim: int, dense: int, hidden: int):
    """The step's nine arrays, seeded (numpy, as the CPU tests make them)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)

    return [
        r(batch, in_dim),
        np.tanh(r(batch, hidden)),
        r(in_dim, dense, scale=in_dim**-0.5),
        r(dense, scale=0.1),
        1 + r(dense, scale=0.1),
        r(dense, scale=0.1),
        r(hidden + dense, 3 * hidden, scale=(hidden + dense) ** -0.5),
        1 + r(3 * hidden, scale=0.1),
        r(3 * hidden, scale=0.1),
    ]


def phase_sharded_step(torch, np, fg):
    """The model-sharded step on a 1-rank NCCL mesh at full width, through
    shard_recurrent and sharded_recurrent_step. Returns the projection
    kernel's launches on this path."""
    import tempfile

    import torch.distributed as dist

    from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
    from sheeprl_tpu_torch.parallel.mesh import init_distributed, make_mesh

    # (B, X, D, H, W2 storage): S = the player's widths; XL = 32*32 + 3 inputs
    cases = {
        "S_B4": (4, 1027, 512, 512, None),
        "S_B16": (16, 1027, 512, 512, None),
        "XL_B16_bf16": (16, 1027, 1024, 4096, torch.bfloat16),
    }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        init_distributed("cuda", f"file://{store}/store", 1, 0)
        try:
            mesh = make_mesh(1, 1, "cuda")
            full, local = {}, {}
            for i, (name, (batch, in_dim, dense, hidden, w_dtype)) in enumerate(cases.items()):
                arrays = np_gru_args(np, SEED + i, batch, in_dim, dense, hidden)
                full[name] = [torch.from_numpy(a).cuda() for a in arrays]
                local[name] = [t.cuda() for t in shard_recurrent(arrays, 1, 0, w_dtype)]
                del arrays
            grad_leaves = [t.clone().requires_grad_(True) for t in local["S_B4"]]
            torch.cuda.synchronize()

            # ---- the main path: counts at 0 just before, read just after ----
            fg.reset_launch_count()
            with torch.no_grad():
                outs = {name: fg.sharded_recurrent_step(*args, mesh=mesh) for name, args in local.items()}
            fg.sharded_recurrent_step(*grad_leaves, mesh=mesh).square().sum().backward()
            torch.cuda.synchronize()
            launches = fg.proj_launch_count
            tc_launches = fg.proj_tc_launch_count
            # ------------------------------------------------------------------
            if launches != len(cases) + 1:
                raise AssertionError(f"sharded_proj launched {launches} times for {len(cases) + 1} sharded steps")
            bf16_steps = sum(c[4] is not None for c in cases.values())
            if tc_launches != bf16_steps:
                raise AssertionError(f"sharded_proj took the tensor cores {tc_launches} times for {bf16_steps} bf16 steps")

            report = {
                "mesh": list(mesh.shape),
                "backend": dist.get_backend(),
                "launches": launches,
                "tc_launches": tc_launches,
            }
            with torch.no_grad():
                for name, (batch, _, _, hidden, w_dtype) in cases.items():
                    got = outs[name]
                    if got.shape != (batch, hidden) or not torch.isfinite(got).all():
                        raise AssertionError(f"sharded step {name}: output is not finite [{batch}, {hidden}]")
                    ref_args = list(full[name])
                    if w_dtype is not None:  # the reference reads the same, upcast values
                        ref_args[6] = local[name][6].float()
                    want = fg.reference_step(*ref_args)
                    tol = FWD_TOL if w_dtype is None else BF16_STEP_TOL
                    err = (got - want).abs().max().item()
                    if not torch.allclose(got, want, atol=tol, rtol=tol):
                        raise AssertionError(f"sharded step {name}: differs from reference_step by {err}")
                    report[f"{name}_vs_reference"] = err
                    if w_dtype is None:
                        fused = fg.launch(*full[name])
                        ferr = (got - fused).abs().max().item()
                        if not torch.allclose(got, fused, atol=tol, rtol=tol):
                            raise AssertionError(f"sharded step {name}: differs from fused_recurrent_step by {ferr}")
                        report[f"{name}_vs_fused_gru"] = ferr
            ref_leaves = [t.clone().requires_grad_(True) for t in full["S_B4"]]
            fg.reference_step(*ref_leaves).square().sum().backward()
            gerr = max((a.grad - b.grad).abs().max().item() for a, b in zip(grad_leaves, ref_leaves))
            for i, (a, b) in enumerate(zip(grad_leaves, ref_leaves)):
                if not torch.allclose(a.grad, b.grad, atol=GRAD_TOL, rtol=GRAD_TOL):
                    raise AssertionError(f"sharded step S_B4: gradient of input {i} differs from plain autograd")
            report["S_B4_grad_vs_autograd"] = gerr

            # use_pallas=False: the plain projection inside the same step
            before = fg.proj_launch_count
            with torch.no_grad():
                for name in ("S_B4", "S_B16"):
                    plain = fg.sharded_recurrent_step(*local[name], mesh=mesh, use_pallas=False)
                    perr = (outs[name] - plain).abs().max().item()
                    if not torch.allclose(outs[name], plain, atol=FWD_TOL, rtol=FWD_TOL):
                        raise AssertionError(f"sharded step {name}: use_pallas=False differs by {perr}")
                    report[f"{name}_vs_use_pallas_false"] = perr
            if fg.proj_launch_count != before:
                raise AssertionError("sharded_recurrent_step(use_pallas=False) launched the projection kernel")
        finally:
            dist.destroy_process_group()

        # the launcher's CUDA ranks: the S B=4 step on one spawned rank
        from sheeprl_tpu_torch.parallel import launch

        np.savez(f"{store}/in.npz", **{f"a{i}": a for i, a in enumerate(np_gru_args(np, SEED, 4, 1027, 512, 512))})
        t0 = time.perf_counter()
        launch.run(launched_rank, 1, f"{store}/in.npz", f"{store}/out.npz", timeout=300)
        report["launch_run_cuda_seconds"] = time.perf_counter() - t0
        with np.load(f"{store}/out.npz") as f:
            got, child_launches, backend = torch.from_numpy(f["h"]).cuda(), int(f["launches"]), str(f["backend"])
        lerr = (got - outs["S_B4"]).abs().max().item()
        if backend != "nccl" or child_launches != 1 or not torch.allclose(got, outs["S_B4"], atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(
                f"launch.run's CUDA rank: backend {backend}, {child_launches} launches, h' differs by {lerr}"
            )
        report["S_B4_launch_run_vs_in_process"] = lerr
    print("sharded_step " + json.dumps(report), flush=True)
    return launches


def launched_rank(rank: int, world: int, in_path: str, out_path: str) -> None:
    """Rank body for ``parallel.launch.run`` on the card: the sharded step on
    a 1 x ``world`` mesh of the launcher's default device, h' and this
    process's launch count to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
    from sheeprl_tpu_torch.ops import fused_gru as fg
    from sheeprl_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, world)
    with np.load(in_path) as f:
        local = [t.cuda() for t in shard_recurrent([f[f"a{i}"] for i in range(9)], world, rank)]
    fg.reset_launch_count()
    with torch.no_grad():
        h = fg.sharded_recurrent_step(*local, mesh=mesh)
    torch.cuda.synchronize()
    if rank == 0:
        np.savez(out_path, h=h.cpu().numpy(), launches=fg.proj_launch_count, backend=dist.get_backend())


def run_player(torch, np, player, cfg, envs, steps, generator, greedy, sample_state, replay=None):
    """Step the player on the envs (or on ``replay``'s recorded observations
    and resets). Returns (record, h trajectory, actions, seconds)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action, prepare_obs

    cnn_keys = cfg["algo"]["cnn_keys"]["encoder"]
    n = player.num_envs
    record = {"obs": [], "resets": []}
    hs, acts = [], []
    player.init_states()
    if replay is None:
        obs = {k: np.stack([o[k] for o in [e.reset(seed=SEED + i)[0] for i, e in enumerate(envs)]]) for k in cnn_keys}
    t0 = time.perf_counter()
    for t in range(steps):
        if replay is not None:
            obs = replay["obs"][t]
            if replay["resets"][t]:
                player.init_states(replay["resets"][t])
        actions = player.get_actions(prepare_obs(obs, cnn_keys, n), generator, greedy, sample_state)
        hs.append(player.h.clone())
        acts.append(actions)
        if replay is not None:
            continue
        record["obs"].append(obs)
        frames, resets = [], []
        for i, env in enumerate(envs):
            a = env_action(actions[i], player.actions_dim, player.actor.is_continuous)
            o, _, terminated, truncated, _ = env.step(a)
            if terminated or truncated:
                o, _ = env.reset()
                resets.append(i)
            frames.append(o)
        obs = {k: np.stack([f[k] for f in frames]) for k in cnn_keys}
        record["resets"].append(resets)
        if resets:
            player.init_states(resets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # a reset recorded after step t applies before step t + 1
    record["resets"] = [[]] + record["resets"][:-1]
    return record, torch.stack(hs), np.stack(acts), seconds


def profile_player(torch, np, player, cfg, envs, steps, generator):
    """torch.profiler over ``steps`` sampled player steps: device busy time
    per step (kernel durations summed), the idle share of the window, the
    fused_gru kernels' share of device time, and the top kernels. None
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, seconds = run_player(torch, np, player, cfg, envs, steps, generator, False, True)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(n in k for n in FUSED_GRU_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_ms_per_step": 1e3 * seconds / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / seconds) if busy_us else None,
        "fused_gru_share_of_device_time": (ours / busy_us) if busy_us else None,
        "top_kernels_us_per_step": [[k, v / steps] for k, v in top],
    }


def phase_slice(torch, np, fg):
    """The S player and evaluate() through the kernel, then the fused/plain
    replay. Returns the kernel's launches on the main path."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    cfg = compose(
        "S", overrides={"seed": SEED, "env.num_envs": 4, "env.max_episode_steps": EVAL_CAP, "fabric.precision": FP32}
    )
    envs = [make_env(cfg, SEED + i)() for i in range(cfg["env"]["num_envs"])]
    obs_space = envs[0].observation_space
    actions_dim, is_continuous = action_dims(envs[0].action_space)
    wm, actor, player = build_agent(actions_dim, is_continuous, cfg, obs_space)
    if not wm.fused:
        raise AssertionError("the S world model did not select the fused recurrent kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # warm-up outside the counted run (allocator, cuDNN plans)
    run_player(torch, np, player, cfg, envs, 2, gen, False, True)

    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    _, hs, acts, seconds = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, gen, False, True)
    reward, eval_steps = evaluate(cfg)
    launches = fg.launch_count
    # ------------------------------------------------------------------
    expected = PLAYER_STEPS + eval_steps
    if launches != expected:
        raise AssertionError(f"fused_gru launched {launches} times for {expected} player steps")
    if not torch.isfinite(hs).all() or hs.shape != (PLAYER_STEPS, 4, 512):
        raise AssertionError(f"player h trajectory is not finite [{PLAYER_STEPS}, 4, 512]: {tuple(hs.shape)}")
    if acts.shape != (PLAYER_STEPS, 4, 3) or not np.all(acts.sum(-1) == 1.0):
        raise AssertionError(f"player actions are not one-hot [{PLAYER_STEPS}, 4, 3]")
    timing = {
        "player_steps": PLAYER_STEPS,
        "num_envs": 4,
        "ms_per_player_step": 1e3 * seconds / PLAYER_STEPS,
        "env_steps_per_s": 4 * PLAYER_STEPS / seconds,
        "eval_reward": reward,
        "eval_steps": eval_steps,
    }
    print("slice " + json.dumps(timing), flush=True)
    print("profile " + json.dumps(profile_player(torch, np, player, cfg, envs, 8, gen)), flush=True)

    # ---- fused vs plain on the same observations, mode/greedy ----
    record, h_fused, a_fused, _ = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, None, True, False)
    plain_cfg = compose(
        "S",
        overrides={
            "seed": SEED,
            "env.num_envs": 4,
            "algo.world_model.recurrent_model.fused": "flax",
            "fabric.precision": FP32,
        },
    )
    wm_plain, _, player_plain = build_agent(
        actions_dim, is_continuous, plain_cfg, obs_space, wm.state_dict(), actor.state_dict()
    )
    if wm_plain.fused:
        raise AssertionError("fused='flax' did not select the plain recurrent model")
    before = fg.launch_count
    _, h_plain, a_plain, _ = run_player(
        torch, np, player_plain, plain_cfg, envs, PLAYER_STEPS, None, True, False, replay=record
    )
    if fg.launch_count != before:
        raise AssertionError("the plain player launched the fused kernel")
    traj_err = (h_fused - h_plain).abs().max().item()
    print(f"slice fused-vs-plain h max_abs_err {traj_err:.3e} over {PLAYER_STEPS} steps", flush=True)
    if not torch.allclose(h_fused, h_plain, atol=TRAJ_TOL, rtol=TRAJ_TOL):
        raise AssertionError(f"fused and plain h trajectories differ by {traj_err}")
    if not np.array_equal(a_fused, a_plain):
        raise AssertionError("fused and plain greedy actions differ")
    for env in envs:
        env.close()
    return launches


# phase 6: Dreamer-V3 S training at full width (configs/exp/dreamer_v3.yaml:
# 16 sequences of 64 steps; configs/algo/dreamer_v3.yaml: horizon 15)
TRAIN_B, TRAIN_T, HORIZON = 16, 64, 15
# B1 calls a gradient step: one a scan step at B=16, one an imagination step
# (horizon + 1 of them) at B=16*64=1024; the backward recomputes the plain step
SCAN_CALLS, IMAGINE_CALLS = TRAIN_T, HORIZON + 1
# the fused (B1) and plain (fused: flax) train steps on the same weights and
# batch: each metric within METRIC_BOUND of the plain one relative to
# max(|plain|, 1), each world-model gradient tensor within GRAD_BOUND of the
# plain one relative to its largest element. Both hold B1's 1e-6-level
# differences from the plain step through 64 recurrent steps, their
# backward and 16 imagination steps at B=1024.
METRIC_BOUND = 1e-3
GRAD_BOUND = 1e-3
TIMED_STEPS, WARMUP_STEPS = 10, 3
# the short loop: a few hundred env steps of main(), cut from the exp's
# 5M steps, 1024 learning_starts and 1M-step buffer
LOOP_CUTS = {"algo.total_steps": 384, "algo.learning_starts": 256, "buffer.size": 4096}


# the samplers of phase 6's parity checks; tests/test_torch_cuda.py uses them too
def smooth_state(logits, generator=None, sample=True):
    """The RSSM's latent, deterministic: the categorical's probabilities
    (straight through) for a sample, its one-hot mode otherwise. An argmax
    in their place could flip on a near tie between fp32 logits that differ
    by 1e-6, which over 2^19 categoricals a step is likely and is no fault."""
    from sheeprl_tpu_torch.ops.distributions import OneHotCategorical

    d = OneHotCategorical(logits)
    z = d.probs if sample else d.mode
    return z.reshape(*z.shape[:-2], -1)


def smooth_actions(actor, state, generator=None, greedy=False):
    """The actor's action, deterministic: a normal head's location, the
    discrete heads' probabilities."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import actor_dists

    dists = actor_dists(actor, actor(state))
    if actor.is_continuous:
        return dists[0].mean
    return torch.cat([d.probs for d in dists], -1)


def train_cfg(env: str, fused: str = "auto", precision: str = FP32, **cuts):
    from sheeprl_tpu_torch.configs import compose

    return compose(
        "S",
        env=env,
        overrides={
            "seed": SEED,
            "algo.world_model.recurrent_model.fused": fused,
            "fabric.precision": precision,
            **cuts,
        },
    )


def filled_replay(np, cfg, env_steps: int, capacity=None, ring=None):
    """The port's host sequence replay (``capacity`` steps an env, default
    ``4 * env_steps``) filled by ``env_steps`` random-action steps of
    ``cfg``'s envs; ``ring``, a device ring of the same capacity, gets the
    same adds."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import random_actions
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    n = int(cfg["env"]["num_envs"])
    keys = list(cfg["algo"]["cnn_keys"]["encoder"]) + list(cfg["algo"]["mlp_keys"]["encoder"])
    cnn = list(cfg["algo"]["cnn_keys"]["encoder"])
    envs = [make_env(cfg, SEED + i)() for i in range(n)]
    space, obs_space = envs[0].action_space, envs[0].observation_space
    actions_dim, is_continuous = action_dims(space)
    rb = EnvIndependentReplayBuffer(
        capacity or 4 * env_steps, n_envs=n, obs_keys=keys, buffer_cls=SequentialReplayBuffer, seed=SEED
    )
    rng = np.random.default_rng(SEED)
    obs = [e.reset(seed=SEED + i)[0] for i, e in enumerate(envs)]
    first = np.ones((1, n, 1), np.float32)
    for _ in range(env_steps):
        actions, real = random_actions(rng, space, actions_dim, n)
        step = prepare_obs({k: np.stack([o[k] for o in obs]) for k in keys}, cnn, n)
        step = {k: v[None] for k, v in step.items()}
        outs = [e.step(np.asarray(real[i]).reshape(space.shape)) for i, e in enumerate(envs)]
        step.update(
            actions=np.asarray(actions, np.float32)[None],
            rewards=np.array([o[1] for o in outs], np.float32).reshape(1, n, 1),
            terminated=np.array([o[2] for o in outs], np.float32).reshape(1, n, 1),
            truncated=np.array([o[3] for o in outs], np.float32).reshape(1, n, 1),
            is_first=first,
        )
        rb.add(step)
        if ring is not None:
            ring.add(step)
        first = np.array([o[2] or o[3] for o in outs], np.float32).reshape(1, n, 1)
        obs = [e.reset()[0] if o[2] or o[3] else o[0] for e, o in zip(envs, outs)]
    for e in envs:
        e.close()
    return rb, obs_space, actions_dim, is_continuous


def train_models(torch, cfg, obs_space, actions_dim, is_continuous, states=None):
    """World model, actor, critic and target critic, the train step and the
    optimizers of ``cfg`` on the card: seeded, or ``states``' weights."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_critic
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_step

    states = states or {}
    wm, actor, _ = build_agent(
        actions_dim, is_continuous, cfg, obs_space, states.get("wm"), states.get("actor"), device="cuda"
    )
    critic, target = build_critic(cfg, wm.latent_state_size, states.get("critic"), states.get("target"), "cuda")
    opts = build_optimizers(cfg, wm, actor, critic)
    step = make_train_step(wm, actor, critic, target, *opts, cfg, is_continuous)
    models = {"wm": wm, "actor": actor, "critic": critic, "target": target}
    return models, step, opts


def snapshot(models):
    return {k: {n: v.detach().clone() for n, v in m.state_dict().items()} for k, m in models.items()}


def one_step(torch, fg, step, batch, grads=None):
    """One gradient step from fresh Moments; returns (metrics, B1 launches)."""
    from sheeprl_tpu_torch.ops.math import init_moments

    fg.reset_launch_count()
    _, metrics = step(init_moments(torch.device("cuda")), batch, None, grads)
    torch.cuda.synchronize()
    return metrics, fg.launch_count


@contextlib.contextmanager
def deterministic():
    """The smooth samplers in place of the port's, where its modules look
    them up, for the length of the block."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent, dreamer_v3

    with mock.patch.object(agent, "compute_stochastic_state", smooth_state):
        with mock.patch.object(dreamer_v3, "sample_actor_actions", smooth_actions):
            yield


def phase_train_parity(torch, np, fg):
    """(a) the fused (B1) and plain train steps on one batch drawn from the
    port's replay (PixelCatcher), seeded weights, the smooth sampler; (b) B1
    launches a step, and one continuous-action step (the dummy env) whose
    actor gradient runs B1's backward at B=1024."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, to_batch

    cfg = train_cfg("pixel_catcher")
    rb, obs_space, actions_dim, is_continuous = filled_replay(np, cfg, 80)
    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    if tuple(batch["rgb"].shape) != (TRAIN_T, TRAIN_B, 64, 64, 3):
        raise AssertionError(f"replay batch is {tuple(batch['rgb'].shape)}")
    with deterministic():
        fused, fused_step, _ = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        if not fused["wm"].fused:
            raise AssertionError("the S world model did not select the fused recurrent kernel")
        plain_cfg = train_cfg("pixel_catcher", fused="flax")
        plain, plain_step, _ = train_models(torch, plain_cfg, obs_space, actions_dim, is_continuous, snapshot(fused))
        g_fused, g_plain = {}, {}
        m_fused, launches = one_step(torch, fg, fused_step, batch, g_fused)
        m_plain, plain_launches = one_step(torch, fg, plain_step, batch, g_plain)
        if launches != SCAN_CALLS + IMAGINE_CALLS or plain_launches != 0:
            raise AssertionError(
                f"fused_gru launched {launches} times a fused step (want {SCAN_CALLS} + {IMAGINE_CALLS})"
                f" and {plain_launches} times a plain one (want 0)"
            )
        if not torch.isfinite(m_fused).all():
            raise AssertionError(f"fused train step metrics are not finite: {m_fused.tolist()}")
        metric_err = ((m_fused - m_plain).abs() / m_plain.abs().clamp_min(1.0)).max().item()
        grad_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(g_fused["world_model"], g_plain["world_model"])
        )
        report = {
            "B": TRAIN_B,
            "T": TRAIN_T,
            "horizon": HORIZON,
            "fused_gru_launches_per_step": launches,
            "metrics_fused": dict(zip(METRIC_ORDER, m_fused.tolist())),
            "metric_max_rel_err": metric_err,
            "metric_bound": METRIC_BOUND,
            "world_model_grad_max_rel_err": grad_err,
            "grad_bound": GRAD_BOUND,
        }
        print("train_parity " + json.dumps(report), flush=True)
        if metric_err > METRIC_BOUND or grad_err > GRAD_BOUND:
            raise AssertionError(f"fused and plain train steps differ: metrics {metric_err}, gradients {grad_err}")

        # the continuous-action step: the gradient of the policy loss flows
        # through 16 imagination steps of B1 at B=1024 and their backward
        ccfg = train_cfg("dummy_continuous")
        crb, cspace, cdim, ccont = filled_replay(np, ccfg, 70)
        cbatch = to_batch(crb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
        cmodels, cstep, _ = train_models(torch, ccfg, cspace, cdim, ccont)
        cplain, cplain_step, _ = train_models(
            torch, train_cfg("dummy_continuous", "flax"), cspace, cdim, ccont, snapshot(cmodels)
        )
        cg, cg_plain = {}, {}
        cm, claunches = one_step(torch, fg, cstep, cbatch, cg)
        cm_plain, _ = one_step(torch, fg, cplain_step, cbatch, cg_plain)
        actor_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(cg["actor"], cg_plain["actor"])
        )
        actor_norm = float(cm[METRIC_ORDER.index("Grads/actor")])
        creport = {
            "actions_dim": list(cdim),
            "fused_gru_launches_per_step": claunches,
            "actor_grad_norm": actor_norm,
            "actor_grad_max_rel_err_vs_plain": actor_err,
            "metric_max_rel_err": ((cm - cm_plain).abs() / cm_plain.abs().clamp_min(1.0)).max().item(),
        }
        print("train_continuous " + json.dumps(creport), flush=True)
        if claunches != SCAN_CALLS + IMAGINE_CALLS or not torch.isfinite(cm).all() or not actor_norm > 0:
            raise AssertionError(f"continuous train step: {creport}")
        if actor_err > GRAD_BOUND:
            raise AssertionError(f"continuous actor gradients through B1 differ from the plain step's by {actor_err}")
    del fused, plain, cmodels, cplain
    return launches, rb, obs_space, actions_dim, is_continuous


RANGES = ("scan_step", "imagine_step", "recurrent", "rssm_scan", "grads", "adam_step")


def profile_train(torch, fg, step, rb, steps: int, moments, gen):
    """torch.profiler over ``steps`` gradient steps (the real sampler),
    with a range around each RSSM step (``dynamic`` in the scan,
    ``imagination``) and each recurrent-model call inside it: device busy
    (kernel time), idle share, B1's share, B1's device time per call at
    B=16 (scan) and B=1024 (imagination), and for each range its host time
    per call, its kernels' device time per call and the device span it
    covers; the top kernels."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.ops.optim import Adam

    wm = step.wm
    rec = wm.recurrent_model

    def ranged(fn, label, by_batch=True):
        def run(*args, **kwargs):
            with record_function(f"{label}_B{args[0].shape[0]}" if by_batch else label):
                return fn(*args, **kwargs)

        return run

    saved = (dreamer_v3.rssm_scan, dreamer_v3._grads, Adam.step)
    rec.forward = ranged(rec.forward, "recurrent")
    wm.dynamic = ranged(wm.dynamic, "scan_step")
    wm.imagination = ranged(wm.imagination, "imagine_step")
    # the whole observation scan, each backward (world model, actor,
    # critic) and each optimizer step
    dreamer_v3.rssm_scan = ranged(dreamer_v3.rssm_scan, "rssm_scan", False)
    dreamer_v3._grads = ranged(dreamer_v3._grads, "grads", False)
    Adam.step = ranged(Adam.step, "adam_step", False)
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda")) for _ in range(steps)]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                moments, _ = step(moments, b, gen)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        del rec.forward, wm.dynamic, wm.imagination
        dreamer_v3.rssm_scan, dreamer_v3._grads, Adam.step = saved
    events = list(prof.events())

    def is_range(e):
        return e.name.split("_B")[0] in RANGES

    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA and not is_range(e)), key=lambda e: e.time_range.start
    )
    starts = [e.time_range.start for e in kernels]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    # B1's launches in issue order: per step 2 x 64 at B=16, then 2 x 16 at B=1024
    b1 = [e for e in kernels if any(n in e.name for n in FUSED_GRU_KERNELS)]
    per_step = 2 * (SCAN_CALLS + IMAGINE_CALLS)
    spans = {16: [], 1024: []}
    if len(b1) == per_step * steps:
        for i in range(0, len(b1), 2):
            a, b = b1[i], b1[i + 1]
            span = max(a.time_range.end, b.time_range.end) - a.time_range.start
            spans[16 if (i % per_step) < 2 * SCAN_CALLS else 1024].append(span)
    ranges = {}
    for label in sorted({e.name for e in events if is_range(e)}):
        host = [e.time_range.elapsed_us() for e in events if e.name == label and e.device_type == DeviceType.CPU]
        gpu = [e for e in events if e.name == label and e.device_type == DeviceType.CUDA]
        inside = 0.0
        for g in gpu:
            lo = bisect.bisect_left(starts, g.time_range.start)
            hi = bisect.bisect_right(starts, g.time_range.end)
            inside += sum(k.time_range.elapsed_us() for k in kernels[lo:hi])
        ranges[label] = {
            "calls": len(host),
            "host_us_per_call": sum(host) / len(host) if host else None,
            "kernel_us_per_call": inside / len(gpu) if gpu else None,
            "device_span_us_per_call": sum(g.time_range.elapsed_us() for g in gpu) / len(gpu) if gpu else None,
        }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return moments, {
        "steps": steps,
        "wall_ms_per_step_profiled": 1e3 * seconds / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / seconds) if busy_us else None,
        "fused_gru_share_of_device_time": (sum(s for v in spans.values() for s in v) / busy_us) if busy_us else None,
        "fused_gru_us_per_call_B16": (sum(spans[16]) / len(spans[16])) if spans[16] else None,
        "fused_gru_us_per_call_B1024": (sum(spans[1024]) / len(spans[1024])) if spans[1024] else None,
        "ranges": ranges,
        "top_kernels_us_per_step": [[k, v / steps] for k, v in top],
    }


def phase_train_timing(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step, fused and plain in turns (fused, plain,
    plain, fused), wall clock over TIMED_STEPS steps after WARMUP_STEPS;
    then a profiler window over each."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    runs = {}
    for fused in ("auto", "flax"):
        cfg = train_cfg("pixel_catcher", fused=fused)
        models, step, _ = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        step.wm = models["wm"]
        runs[fused] = (models, step)
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(TIMED_STEPS)]
    times = {"auto": [], "flax": []}
    moments = {k: init_moments(dev) for k in runs}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for fused in ("auto", "flax", "flax", "auto"):
        _, step = runs[fused]
        for b in batches[:WARMUP_STEPS]:
            moments[fused], _ = step(moments[fused], b, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            moments[fused], _ = step(moments[fused], b, gen)
        torch.cuda.synchronize()
        times[fused].append(1e3 * (time.perf_counter() - t0) / len(batches))
    report = {
        "ms_per_gradient_step_fused": times["auto"],
        "ms_per_gradient_step_plain": times["flax"],
        "gradient_steps_per_s_fused": 1e3 / min(times["auto"]),
    }
    print("train_timing " + json.dumps(report), flush=True)
    for fused in ("auto", "flax"):
        _, step = runs[fused]
        moments[fused], prof = profile_train(torch, fg, step, rb, 4, moments[fused], gen)
        print(f"train_profile_{'fused' if fused == 'auto' else 'plain'} " + json.dumps(prof), flush=True)
    del runs
    return report


def phase_train_loop(torch, np, fg, tmp, precision=FP32, label="train_loop"):
    """(d) main(): a few hundred env steps of the S loop on 4 PixelCatcher
    envs at ``precision``, each gradient step one replay of the captured
    step. Its calls of the kernel's wrapper: one a player step, 80 for each
    of the warm-up steps and 80 recorded into the graph; its launches on the
    card: those calls but the recorded ones, plus 80 a replay; at bf16-mixed
    every call reads a bf16 x. Returns (launches, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main
    from sheeprl_tpu_torch.ops.graph import WARMUP_STEPS

    cfg = train_cfg("pixel_catcher", precision=precision, **LOOP_CUTS, log_base_dir=tmp)
    print(f"{label} cuts " + json.dumps({**LOOP_CUTS, "fabric.precision": precision}), flush=True)
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    out = train_main(cfg, device="cuda")
    calls = fg.launch_count
    bf16_calls = fg.bf16_x_launch_count
    # ------------------------------------------------------------------
    per_step = SCAN_CALLS + IMAGINE_CALLS
    num_envs = cfg["env"]["num_envs"]
    updates = cfg["algo"]["total_steps"] // num_envs
    acting = updates - cfg["algo"]["learning_starts"] // num_envs
    captured = out["captured_launches_per_step"]
    launches = calls - captured + captured * out["replays"]
    if (
        captured != per_step
        or out["replays"] != out["gradient_steps"]
        or out["gradient_steps"] == 0
        or calls != acting + (WARMUP_STEPS + 1) * per_step
        or bf16_calls != (calls if precision == BF16 else 0)
    ):
        raise AssertionError(
            f"main(): {calls} wrapper calls (want {acting} + {WARMUP_STEPS + 1} x {per_step}), {captured} "
            f"captured a step (want {per_step}), {out['replays']} replays for {out['gradient_steps']} steps, "
            f"{bf16_calls} with a bf16 x"
        )
    if not all(np.isfinite(v) for v in out["metrics"].values()):
        raise AssertionError(f"main(): metrics are not finite: {out['metrics']}")
    report = {
        "env_steps": out["env_steps"],
        "gradient_steps": out["gradient_steps"],
        "seconds": out["seconds"],
        "train_seconds_device": out["train_seconds"],
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "gradient_steps_per_s": out["gradient_steps"] / out["seconds"],
        "precision": precision,
        "fused_gru_wrapper_calls": calls,
        "fused_gru_bf16_x_wrapper_calls": bf16_calls,
        "fused_gru_captured_per_step": captured,
        "replays": out["replays"],
        "fused_gru_launches": launches,
        "last_metrics": out["metrics"],
    }
    print(f"{label} " + json.dumps(report), flush=True)
    return launches, report


# phase 7: the captured step. (a) replayed against eager steps from the same
# weights and batches with cuDNN's deterministic algorithms: each metric
# within REPLAY_BOUND of the eager one relative to max(|eager|, 1), each
# parameter tensor relative to its largest element; the same kernels run in
# both, the graph only takes the host out
REPLAY_BOUND = 1e-6
REPLAYED_STEPS = 3
# (b) two replays from the same state and batch with the generator moved on
# differ by more than NOISE_MIN in some metric (relative), and re-setting
# the generator reproduces the first within REPLAY_BOUND
NOISE_MIN = 1e-4
REPLAY_TIMED = 8
# (d) the drill: S on PixelCatcher (4 envs), 320 env steps, training from
# 256 (64 steps an env: one sequence), a checkpoint every 64 policy steps, a
# forced NaN at update 72 (one rollback to the checkpoint of policy step
# 256); then a resume from auto to 608. The buffer is not checkpointed, so
# the resumed run refills it for learning_starts past its start (update 81
# + 64) and trains from update 145, where the restored Ratio owes the
# policy steps since its last call
DRILL_CUTS = {"algo.total_steps": 320, "algo.learning_starts": 256, "buffer.size": 4096, "checkpoint.every": 64}
DRILL_FAULT_UPDATE = 72
DRILL_ROLLBACK_TO = "ckpt_256_0.ckpt"
DRILL_RESUME_STEPS = 608


@contextlib.contextmanager
def cudnn_deterministic(torch):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def captured_step(torch, models, step, opts, batch, generator):
    """The train step as ``main`` captures it, over inputs shaped as
    ``batch`` (holding it); returns (CapturedStep, its Moments)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_fn
    from sheeprl_tpu_torch.ops.math import init_moments

    moments = init_moments(torch.device("cuda"))
    inputs = {k: v.clone() for k, v in batch.items()}
    fn = make_train_fn(step, models["wm"], models["actor"], models["critic"], opts, moments, inputs, generator)
    return fn, moments


def rel_err(torch, got, want):
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, precision):
    """REPLAYED_STEPS replays of the captured step (B1 inside) at
    ``precision`` against as many eager steps, discrete (PixelCatcher) and
    continuous (the dummy env), with the smooth samplers and cuDNN's
    deterministic algorithms. Returns the report; raises past REPLAY_BOUND."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    ccfg = train_cfg("dummy_continuous", precision=precision)
    crb, cspace, cdim, ccont = filled_replay(np, ccfg, 70)
    cases = {
        "discrete": (train_cfg("pixel_catcher", precision=precision), rb, obs_space, actions_dim, is_continuous),
        "continuous": (ccfg, crb, cspace, cdim, ccont),
    }
    report = {"bound": REPLAY_BOUND, "precision": precision}
    with cudnn_deterministic(torch), deterministic():
        for name, (cfg, crb_, space, dims, cont) in cases.items():
            graphed, gstep, gopts = train_models(torch, cfg, space, dims, cont)
            eager, estep, eopts = train_models(torch, cfg, space, dims, cont, snapshot(graphed))
            batches = [to_batch(crb_.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(REPLAYED_STEPS)]
            fn, gmoments = captured_step(torch, graphed, gstep, gopts, batches[0], None)
            emoments = init_moments(dev)
            metric_errs = []
            for b in batches:
                for k, v in b.items():
                    fn.inputs[k].copy_(v)
                got = fn()
                _, want = estep(emoments, b, None)
                metric_errs.append(rel_err(torch, got, want))
            torch.cuda.synchronize()
            param_err = max(
                ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for k in ("wm", "actor", "critic")
                for a, b in zip(graphed[k].parameters(), eager[k].parameters())
            )
            moments_err = max(rel_err(torch, gmoments.low, emoments.low), rel_err(torch, gmoments.high, emoments.high))
            counts = [int(o.count) for o in gopts] + [int(o.count) for o in eopts]
            report[name] = {
                "metric_max_rel_err_per_step": metric_errs,
                "param_max_rel_err": param_err,
                "moments_max_rel_err": moments_err,
                "adam_counts": counts,
                "captured_fused_gru_calls": fn.captured_launches,
                "replays": fn.replays,
            }
            if (
                max(metric_errs + [param_err, moments_err]) > REPLAY_BOUND
                or counts != [REPLAYED_STEPS] * 6
                or fn.captured_launches != SCAN_CALLS + IMAGINE_CALLS
            ):
                raise AssertionError(f"replayed against eager ({name}, {precision}): {report[name]}")
            del graphed, eager, fn
    return report


def phase_replay_parity(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(a) REPLAYED_STEPS replays of the captured step (B1 inside) against
    as many eager steps, discrete (PixelCatcher) and continuous (the dummy
    env), with the smooth samplers; (b) fresh noise on each replay from the
    registered generator, with the real samplers."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    dev = torch.device("cuda")
    report = replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, FP32)

    # (b) the real samplers: noise from the registered train generator
    with cudnn_deterministic(torch):
        cfg = train_cfg("pixel_catcher")
        models, step, opts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev)
        fn, _ = captured_step(torch, models, step, opts, batch, gen)
        saved = [t.detach().clone() for t in fn.state]
        gen_state = gen.get_state()

        def restore():
            with torch.no_grad():
                for t, v in zip(fn.state, saved):
                    t.copy_(v)

        first = fn()
        restore()
        second = fn()
        restore()
        gen.set_state(gen_state)
        again = fn()
        torch.cuda.synchronize()
        noise = {
            "metric_max_rel_diff_next_draw": rel_err(torch, second, first),
            "metric_max_rel_err_same_draw": rel_err(torch, again, first),
            "min_rel_diff": NOISE_MIN,
        }
        report["noise"] = noise
        if noise["metric_max_rel_diff_next_draw"] <= NOISE_MIN or noise["metric_max_rel_err_same_draw"] > REPLAY_BOUND:
            raise AssertionError(f"replayed noise: {noise}")
        del models, fn, saved
    print("replay_parity " + json.dumps(report), flush=True)
    return report


def profile_replays(torch, fn, replays: int = 4, top: int = 8):
    """torch.profiler over ``replays`` replays of the captured step ``fn``,
    after one unrecorded warm-up replay (the profiler's first records of a
    session can be lost, as in ``profile_window``): wall and device-busy ms
    a replay, the device's idle share, B1's gru_step kernels a replay, their
    ms and share of the busy time, and the top kernels (ms a replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}

    def ready(prof):
        # the recorded replays' events, read before the profiler clears them
        seen["kernels"] = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready
    ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(replays):
            fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    kernels = seen.get("kernels", [])
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    b1 = [e for e in kernels if any(n in e.name for n in FUSED_GRU_KERNELS)]
    b1_us = sum(e.time_range.elapsed_us() for e in b1)
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    return {
        "wall_ms_per_replay": 1e3 * seconds / replays,
        "device_busy_ms_per_replay": busy_us / 1e3 / replays,
        "device_idle_share": 1.0 - busy_us / 1e6 / seconds if busy_us else None,
        "gru_step_kernels_per_replay": len(b1) / replays,
        "gru_step_ms_per_replay": b1_us / 1e3 / replays,
        "gru_step_share_of_device_time": b1_us / busy_us if busy_us else None,
        "top_kernels_ms_per_replay": [
            [k, v / 1e3 / replays] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ],
    }


def phase_replay_timing(torch, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step replayed and eager, B1 (fused: auto) and
    the plain recurrent model (fused: flax), CUDA events around REPLAY_TIMED
    steps, in turns fused, plain, plain, fused; then torch.profiler over 4
    replays of each: device busy time, idle share, B1's gru_step kernels a
    replayed step (2 launches x 80 calls) and their time, the top kernels."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev)
    runs = {}
    for fused in ("auto", "flax"):
        models, step, opts = train_models(torch, train_cfg("pixel_catcher", fused=fused), obs_space, actions_dim, is_continuous)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        fn, _ = captured_step(torch, models, step, opts, batch, gen)
        fn()  # capture and one replay
        runs[fused] = (models, step, fn, gen, init_moments(dev))

    def timed(body):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPLAY_TIMED):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPLAY_TIMED

    times = {f"{k}_{mode}": [] for k in ("fused", "plain") for mode in ("replayed", "eager")}
    for fused in ("auto", "flax", "flax", "auto"):
        _, step, fn, gen, moments = runs[fused]
        key = "fused" if fused == "auto" else "plain"
        times[f"{key}_replayed"].append(timed(fn))
        times[f"{key}_eager"].append(timed(lambda: step(moments, batch, gen)))
    report = {f"ms_per_gradient_step_{k}": v for k, v in times.items()}
    for fused in ("auto", "flax"):
        report[f"profile_{'fused' if fused == 'auto' else 'plain'}"] = profile_replays(torch, runs[fused][2])
    print("replay_timing " + json.dumps(report), flush=True)
    if report["profile_fused"]["gru_step_kernels_per_replay"] != 2 * (SCAN_CALLS + IMAGINE_CALLS):
        raise AssertionError(f"a replayed step ran {report['profile_fused']['gru_step_kernels_per_replay']} gru_step kernels")
    if report["profile_plain"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError("the plain step ran B1")
    del runs
    return report


def phase_drill(torch, np, tmp):
    """(d) main() with a checkpoint every 64 policy steps and a forced NaN
    at update DRILL_FAULT_UPDATE (one rollback), then a second main()
    resuming from the newest committed checkpoint (auto) to
    DRILL_RESUME_STEPS env steps."""
    import warnings

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main

    fault = {"enabled": True, "faults": [{"kind": "nan", "at_update": DRILL_FAULT_UPDATE}]}
    common = {**DRILL_CUTS, "log_base_dir": tmp, "run_name": "drill"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = train_main(train_cfg("pixel_catcher", **common, **{"resilience.fault_injection": fault}), device="cuda")
        resume = {**common, "checkpoint.resume_from": "auto", "algo.total_steps": DRILL_RESUME_STEPS}
        second = train_main(train_cfg("pixel_catcher", **resume), device="cuda")
    rolled = [str(w.message) for w in caught if "rolled back" in str(w.message)]
    report = {
        "cuts": common,
        "fault_at_update": DRILL_FAULT_UPDATE,
        "first": {k: first[k] for k in ("env_steps", "gradient_steps", "rollbacks", "last_checkpoint", "seconds")},
        "rolled_back": rolled,
        "second": {k: second[k] for k in ("start_update", "env_steps", "gradient_steps", "rollbacks", "seconds")},
        "second_metrics": second["metrics"],
    }
    print("drill " + json.dumps(report), flush=True)
    num_envs = 4
    if (
        first["rollbacks"] != 1
        or first["env_steps"] != DRILL_CUTS["algo.total_steps"]
        or len(rolled) != 1
        or DRILL_ROLLBACK_TO not in rolled[0]
        or second["start_update"] != DRILL_CUTS["algo.total_steps"] // num_envs + 1
        or second["env_steps"] != DRILL_RESUME_STEPS
        or second["gradient_steps"] == 0
        or not all(np.isfinite(v) for v in second["metrics"].values())
    ):
        raise AssertionError(f"rollback and resume drill: {report}")
    return report


# phase 8: the default precision, bf16-mixed. (a) B1 reading a bf16 x at
# the S shapes of the player, the scan and imagination, held to
# reference_step on the same bf16 x at FWD_TOL and GRAD_TOL: both compute in
# fp32 from the same rounded x
BF16_KERNEL_SHAPES = {"S_B4": (4, 1027, 512, 512), "S_B16": (16, 1027, 512, 512), "S_B1024": (1024, 1027, 512, 512)}
BF16_ULP = 2.0**-7
# (b) the eager bf16 S step with B1 against the plain recurrent model at
# bf16 (the flax cell rounds h to bf16 at each of the 64 + 16 steps, B1
# keeps it in fp32) and against the fp32 B1 step, from the same weights and
# batch with the smooth samplers: each metric relative to max(|ref|, 1),
# each gradient tensor relative to its largest element. Both comparisons
# take every bf16 rounding of the step, carried through the scan and
# imagination, so the bounds are bf16's, not the kernel's. Measured on an
# H100 (first run): metrics 3.0e-4 against plain and 1.9e-3 against fp32;
# gradients 2.1e-2 and 3.0e-2 (world model), 6.5e-3 and 5.8e-3 (actor),
# 3.9e-3 and 4.3e-3 (critic)
BF16_METRIC_BOUND = 1e-2
BF16_GRAD_BOUND = 0.1


def phase_bf16_kernel(torch, fg, shapes):
    """(a) B1 with a bf16 x: forward and gradients against reference_step on
    the same bf16 x, dx in bf16; device time (CUDA graph, L2 warm) beside the
    step on the fp32 copy of x and the plain version, and the bound with x
    at 2 bytes. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst = 0.0
    rows = []
    for name, (batch, in_dim, dense, hidden) in shapes.items():
        args = gru_args(torch, batch, in_dim, dense, hidden, gen)
        args[0] = args[0].bfloat16()
        x32 = args[0].float()
        before = fg.bf16_x_launch_count
        with torch.no_grad():
            got = fg.launch(*args)
            want = fg.reference_step(*args)
        torch.cuda.synchronize()
        if fg.bf16_x_launch_count != before + 1:
            raise AssertionError(f"{name}: a bf16 x was not counted as a bf16-x launch")
        if got.shape != (batch, hidden) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: bf16-x kernel output is not finite [{batch}, {hidden}]")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(f"{name}: bf16-x kernel forward differs from reference_step by {err}")
        worst = max(worst, err)
        leaves = [a.clone().requires_grad_(True) for a in args]
        cot = torch.randn(batch, hidden, device="cuda", generator=gen)
        g_kernel = torch.autograd.grad(fg.fused_recurrent_step(*leaves), leaves, cot)
        ref = [a.clone().requires_grad_(True) for a in args]
        g_plain = torch.autograd.grad(fg.reference_step(*ref), ref, cot)
        if g_kernel[0].dtype != torch.bfloat16:
            raise AssertionError(f"{name}: dx is {g_kernel[0].dtype}, not x's bf16")
        gerr = max((a.float() - b.float()).abs().max().item() for a, b in zip(g_kernel, g_plain))
        # dx is an fp32 gradient rounded to bf16: two sums may round a value
        # to neighbouring bf16 numbers, one ulp (2^-7 relative) apart
        rtols = [BF16_ULP] + [GRAD_TOL] * 8
        if not all(torch.allclose(a.float(), b.float(), atol=GRAD_TOL, rtol=r) for a, b, r in zip(g_kernel, g_plain, rtols)):
            raise AssertionError(f"{name}: bf16-x gradients differ from reference_step by {gerr}")
        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.launch(*args))
            fp32_x_ms = device_ms(torch, lambda: fg.launch(x32, *args[1:]))
            plain_ms = device_ms(torch, lambda: fg.reference_step(*args))
        bound_ms, bound_by = gru_bound_ms(batch, in_dim, dense, hidden, x_bytes=2)
        row = {
            "shape": name,
            "B": batch,
            "x_dtype": "bfloat16",
            "max_abs_err": err,
            "grad_max_abs_err": gerr,
            "ms": ms,
            "fp32_x_ms": fp32_x_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "fp32_x_bound_ms": gru_bound_ms(batch, in_dim, dense, hidden)[0],
        }
        rows.append(row)
        print("fused_gru_bf16_x " + json.dumps(row), flush=True)
    return worst, rows


def phase_bf16_train(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """(b) one eager S gradient step at bf16-mixed with B1 against the
    plain recurrent model at bf16-mixed and against the fp32 B1 step, the
    same weights and batch, the smooth samplers; B1 called 80 times a step,
    every call with a bf16 x."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, to_batch

    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    per_step = SCAN_CALLS + IMAGINE_CALLS
    with deterministic():
        b1, b1_step, _ = train_models(torch, train_cfg("pixel_catcher", precision=BF16), obs_space, actions_dim, is_continuous)
        if not b1["wm"].fused or b1["wm"].dtype != torch.bfloat16:
            raise AssertionError("the bf16-mixed S world model is not the bf16 B1 model")
        states = snapshot(b1)
        runs = {"b1_bf16": (b1_step, per_step, per_step)}
        for key, fused, precision, want in (("plain_bf16", "flax", BF16, (0, 0)), ("b1_fp32", "auto", FP32, (per_step, 0))):
            _, step, _ = train_models(
                torch, train_cfg("pixel_catcher", fused, precision), obs_space, actions_dim, is_continuous, states
            )
            runs[key] = (step, *want)
        out = {}
        for key, (step, calls, bf16_calls) in runs.items():
            grads = {}
            metrics, launches = one_step(torch, fg, step, batch, grads)
            if (launches, fg.bf16_x_launch_count) != (calls, bf16_calls) or not torch.isfinite(metrics).all():
                raise AssertionError(
                    f"bf16 train step {key}: {launches} B1 calls, {fg.bf16_x_launch_count} with a bf16 x "
                    f"(want {calls}, {bf16_calls}); metrics {metrics.tolist()}"
                )
            out[key] = (metrics, grads)
    m_b1, g_b1 = out["b1_bf16"]
    report = {"B": TRAIN_B, "T": TRAIN_T, "horizon": HORIZON, "fused_gru_bf16_x_calls_per_step": per_step}
    report["metrics_b1_bf16"] = dict(zip(METRIC_ORDER, m_b1.tolist()))
    for ref in ("plain_bf16", "b1_fp32"):
        m, g = out[ref]
        report[f"vs_{ref}"] = {
            "metric_max_rel_err": ((m_b1 - m).abs() / m.abs().clamp_min(1.0)).max().item(),
            **{
                f"{k}_grad_max_rel_err": max(
                    ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(g_b1[k], g[k])
                )
                for k in ("world_model", "actor", "critic")
            },
        }
    report["metric_bound"], report["grad_bound"] = BF16_METRIC_BOUND, BF16_GRAD_BOUND
    print("bf16_train " + json.dumps(report), flush=True)
    for ref in ("plain_bf16", "b1_fp32"):
        errs = report[f"vs_{ref}"]
        if errs["metric_max_rel_err"] > BF16_METRIC_BOUND or max(
            v for k, v in errs.items() if k.endswith("grad_max_rel_err")
        ) > BF16_GRAD_BOUND:
            raise AssertionError(f"the bf16 B1 step against {ref}: {errs}")
    return report


def step_ms(torch, fn, steps: int = REPLAY_TIMED) -> float:
    """CUDA-event ms of one call of ``fn`` (a replayed step), over ``steps``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def phase_bf16_timing(torch, rb, obs_space, actions_dim, is_continuous):
    """(d) ms per replayed S step, B1 and plain, at bf16-mixed and fp32, in
    turns within this call; then torch.profiler over 4 replays of each
    bf16 step: idle share, top kernels, B1's share."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    variants = {"b1_bf16": ("auto", BF16), "plain_bf16": ("flax", BF16), "b1_fp32": ("auto", FP32), "plain_fp32": ("flax", FP32)}
    runs = {}
    for key, (fused, precision) in variants.items():
        models, step, opts = train_models(
            torch, train_cfg("pixel_catcher", fused, precision), obs_space, actions_dim, is_continuous
        )
        fn, _ = captured_step(torch, models, step, opts, batch, torch.Generator(device="cuda").manual_seed(SEED))
        fn()  # capture and one replay
        runs[key] = (models, fn)
    times = {key: [] for key in variants}
    for key in ("b1_bf16", "plain_bf16", "b1_fp32", "plain_fp32", "plain_fp32", "b1_fp32", "plain_bf16", "b1_bf16"):
        times[key].append(step_ms(torch, runs[key][1]))
    report = {f"ms_per_replayed_step_{k}": v for k, v in times.items()}
    for key in ("b1_bf16", "plain_bf16"):
        report[f"profile_{key}"] = profile_replays(torch, runs[key][1], top=10)
    print("bf16_replay_timing " + json.dumps(report), flush=True)
    if report["profile_b1_bf16"]["gru_step_kernels_per_replay"] != 2 * (SCAN_CALLS + IMAGINE_CALLS):
        raise AssertionError(f"a bf16 replayed step ran {report['profile_b1_bf16']['gru_step_kernels_per_replay']} gru_step kernels")
    if report["profile_plain_bf16"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError("the plain bf16 step ran B1")
    del runs
    return report


def phase_bf16_player(torch, np, fg):
    """(f) the S player at the default precision (bf16-mixed) on 4
    PixelCatcher envs: one B1 call a step, each with a bf16 x; ms a step and
    env-steps/s. Returns (launches, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    cfg = compose("S", overrides={"seed": SEED, "env.num_envs": 4})
    if cfg["fabric"]["precision"] != BF16:
        raise AssertionError(f"the default precision is {cfg['fabric']['precision']}, not {BF16}")
    envs = [make_env(cfg, SEED + i)() for i in range(cfg["env"]["num_envs"])]
    actions_dim, is_continuous = action_dims(envs[0].action_space)
    wm, _, player = build_agent(actions_dim, is_continuous, cfg, envs[0].observation_space)
    if not wm.fused or wm.dtype != torch.bfloat16:
        raise AssertionError("the default S world model is not the bf16 B1 model")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    run_player(torch, np, player, cfg, envs, 2, gen, False, True)  # warm-up
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    _, hs, acts, seconds = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, gen, False, True)
    launches, bf16_launches = fg.launch_count, fg.bf16_x_launch_count
    # ------------------------------------------------------------------
    for env in envs:
        env.close()
    if launches != PLAYER_STEPS or bf16_launches != PLAYER_STEPS:
        raise AssertionError(f"the bf16 player launched B1 {launches} times, {bf16_launches} with a bf16 x, in {PLAYER_STEPS} steps")
    if not torch.isfinite(hs).all() or hs.dtype != torch.float32 or not np.all(acts.sum(-1) == 1.0):
        raise AssertionError("the bf16 player's h is not finite fp32 or its actions are not one-hot")
    report = {
        "precision": BF16,
        "player_steps": PLAYER_STEPS,
        "num_envs": 4,
        "ms_per_player_step": 1e3 * seconds / PLAYER_STEPS,
        "env_steps_per_s": 4 * PLAYER_STEPS / seconds,
        "fused_gru_bf16_x_launches": bf16_launches,
    }
    print("bf16_player " + json.dumps(report), flush=True)
    return launches, report


# phase 9: replay where the JAX package keeps it, at S width and the default
# bf16-mixed. (a) the Atari-100k exps (configs/exp/dreamer_v3_100k_*.yaml:
# buffer.size 100000, 1 env, 64x64x3 pixels) are where buffer.device=auto
# puts the ring on the card; its bytes within RING_BYTES_TOL of the
# estimate; a ring and a host buffer fed the same steps (RING_CAPACITY an
# env: 80 steps wrap it) gather the same windows bit for bit; RING_DRAWS
# in-graph draws start only where the host allows, each env's share within
# 3 sigma of uniform
ATARI_100K = {"buffer.size": 100000, "env.num_envs": 1}
RING_BYTES_TOL = 0.01
RING_CAPACITY = 72
RING_GATHERS = 8
RING_DRAWS = 10000
# (b) a superstep of SUPERSTEP_K steps over pregathered batches against as
# many replays of the per-step graph with the host EMA between them, at
# bf16-mixed with cuDNN's deterministic algorithms and the real samplers:
# bit for bit is expected (the same kernels in the same order, the train
# generator advanced alike); REPLAY_BOUND is the bound otherwise
SUPERSTEP_K = 4
# (c) the four replay paths, each timed over PATH_WINDOWS windows of
# PATH_STEPS gradient steps, in turns, on buffers of the loop's size
# (buffer.size 100000 over 4 envs, PixelCatcher frames repeated)
PATH_STEPS = 2 * SUPERSTEP_K
PATH_WINDOWS = 2
PATHS = ("host_k0", "ring_k0", "ring_k4", "host_k4")
# (d) main(): phase 8(e)'s loop with buffer.size 100000 (auto picks the
# ring), three ways, run in turns (each twice, the order reversed the
# second time); then the drill: the ring checkpointed with the buffer
# (buffer.checkpoint) at 288 env steps, resumed into the memmapped host
# buffer to 320, and from that into the ring with supersteps to 352
RING_LOOP_CUTS = {**LOOP_CUTS, "buffer.size": 100000}
RING_LOOPS = {
    "host_k0": {"buffer.device": False},
    "ring_k0": {},
    "ring_k4": {"algo.fused_gradient_steps": SUPERSTEP_K},
}
RING_DRILL_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096, "buffer.checkpoint": True}
RING_DRILL_RESUMES = (320, 352)


def phase_ring(torch, np):
    """(a) the placement, the ring's bytes, its gather against the host
    buffer's, and the in-graph draw."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.data.device_buffer import (
        DeviceReplayBuffer,
        draw_from_mask,
        estimate_ring_bytes,
        make_sequential_replay,
        resolve_device_buffer,
        sequence_start_mask,
    )
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    dev = torch.device("cuda")
    cfg = train_cfg("pixel_catcher", precision=BF16, **ATARI_100K)
    env = make_env(cfg, SEED)()
    obs_space, (actions_dim, _) = env.observation_space, action_dims(env.action_space)
    size = cfg["buffer"]["size"]
    estimate = estimate_ring_bytes(obs_space, actions_dim, size, 1)
    picked = resolve_device_buffer(cfg, dev, obs_space, actions_dim, size, 1)
    ring = make_sequential_replay(cfg, dev, obs_space, actions_dim, size, 1, ["rgb"], None, SEED)
    obs = prepare_obs({"rgb": env.reset(seed=SEED)[0]["rgb"][None]}, cnn_keys=["rgb"], num_envs=1)
    zeros = np.zeros((1, 1, 1), np.float32)
    ring.add(
        {
            "rgb": obs["rgb"][None],
            "actions": np.zeros((1, 1, sum(actions_dim)), np.float32),
            **{k: zeros for k in ("rewards", "terminated", "truncated", "is_first")},
        }
    )
    env.close()
    report = {
        "atari_100k": {
            "buffer_size": size,
            "num_envs": 1,
            "buffer_device": cfg["buffer"]["device"],
            "device_max_bytes": cfg["buffer"]["device_max_bytes"],
            "picked_ring": picked and isinstance(ring, DeviceReplayBuffer),
            "estimate_bytes": estimate,
            "ring_bytes": ring.ring_bytes(),
            "rel_diff": abs(ring.ring_bytes() - estimate) / estimate,
        }
    }
    del ring
    torch.cuda.empty_cache()

    ring = DeviceReplayBuffer(RING_CAPACITY, n_envs=4, obs_keys=["rgb"], device=dev, seed=SEED)
    rb, *_ = filled_replay(np, train_cfg("pixel_catcher", precision=BF16), 80, capacity=RING_CAPACITY, ring=ring)
    mismatched = []
    for _ in range(RING_GATHERS):
        env_idx, starts = ring.draw_indices(TRAIN_B, TRAIN_T)
        for k, v in ring.gather(env_idx, starts, TRAIN_T).items():
            rows = (starts[:, None] + np.arange(TRAIN_T)) % RING_CAPACITY
            want = np.stack([np.asarray(rb.buffer[e].buffer[k])[r, 0] for e, r in zip(env_idx, rows)], axis=1)
            got = v.cpu().numpy()
            if got.dtype != want.dtype or not np.array_equal(got, want):
                mismatched.append(k)
    bufs, pos, full = ring.superstep_inputs(TRAIN_T)
    mask = sequence_start_mask(pos, full, RING_CAPACITY, TRAIN_T).cpu().numpy()
    valid = [ring._valid_starts(e, TRAIN_T) for e in range(4)]
    mask_ok = all(np.array_equal(np.nonzero(mask[e])[0], valid[e]) for e in range(4))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    env_idx, starts = (t.cpu().numpy() for t in draw_from_mask(gen, torch.from_numpy(mask).to(dev), RING_DRAWS))
    straddling = int(sum(s not in set(valid[e].tolist()) for e, s in zip(env_idx, starts)))
    counts = np.bincount(env_idx, minlength=4)
    sigma = (RING_DRAWS * 0.25 * 0.75) ** 0.5
    report["same_steps"] = {
        "capacity": RING_CAPACITY,
        "env_steps": 80,
        "cursors_ring": ring._pos.tolist(),
        "cursors_host": [b._pos for b in rb.buffer],
        "gathers": RING_GATHERS,
        "mismatched_keys": mismatched,
        "mask_equals_host_valid_starts": mask_ok,
        "draws": RING_DRAWS,
        "straddling_draws": straddling,
        "env_counts": counts.tolist(),
        "worst_env_share_sigmas": float(np.abs(counts - RING_DRAWS / 4).max() / sigma),
    }
    print("ring " + json.dumps(report), flush=True)
    if (
        not report["atari_100k"]["picked_ring"]
        or report["atari_100k"]["rel_diff"] > RING_BYTES_TOL
        or mismatched
        or not mask_ok
        or straddling
        or report["same_steps"]["worst_env_share_sigmas"] > 3
        or report["same_steps"]["cursors_ring"] != report["same_steps"]["cursors_host"]
    ):
        raise AssertionError(f"the device ring: {report}")
    return report


def model_state(models, opts, moments):
    """Every tensor a gradient step updates, by name."""
    out = {f"{k}.{n}": v for k, m in models.items() for n, v in m.state_dict().items()}
    for i, o in enumerate(opts):
        out.update({f"opt{i}.mu{j}": t for j, t in enumerate(o.mu)})
        out.update({f"opt{i}.nu{j}": t for j, t in enumerate(o.nu)})
        out[f"opt{i}.count"] = o.count
    out["moments.low"], out["moments.high"] = moments.low, moments.high
    return out


def phase_superstep_parity(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(b) SUPERSTEP_K steps in one superstep graph against as many replays
    of the per-step graph plus the host EMA, from the same weights, batches
    and train generator; then the gru_step kernels of one superstep replay
    in the profiler."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_, make_fused_train_fn, to_batch
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.ops.superstep import pregathered

    dev = torch.device("cuda")
    cfg = train_cfg("pixel_catcher", precision=BF16)
    freq = int(cfg["algo"]["critic"]["per_rank_target_network_update_freq"])
    tau = float(cfg["algo"]["critic"]["tau"])
    with cudnn_deterministic(torch):
        single, sstep, sopts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        fused, fstep, fopts = train_models(torch, cfg, obs_space, actions_dim, is_continuous, snapshot(single))
        batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(SUPERSTEP_K)]
        sgen = torch.Generator(device="cuda").manual_seed(SEED)
        fgen = torch.Generator(device="cuda").manual_seed(SEED)
        fn, smoments = captured_step(torch, single, sstep, sopts, batches[0], sgen)
        want = []
        for i, b in enumerate(batches):
            if i % freq == 0:
                ema_(single["critic"], single["target"], 1.0 if i == 0 else tau)
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            want.append(fn())
        fmoments = init_moments(dev)
        stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        sfn = make_fused_train_fn(
            fstep, fused["wm"], fused["actor"], fused["critic"], fused["target"], fopts, fmoments, cfg,
            pregathered, SUPERSTEP_K, stack, (fgen,),
        )
        sfn.inputs["counter"].fill_(0)
        got, finite = sfn()
        torch.cuda.synchronize()
        want = torch.stack(want)
        s_state, f_state = model_state(single, sopts, smoments), model_state(fused, fopts, fmoments)
        unequal = [k for k in s_state if not torch.equal(s_state[k], f_state[k])]
        state_err = max(
            ((f_state[k].double() - s_state[k].double()).abs().max() / s_state[k].double().abs().max().clamp_min(1e-30)).item()
            for k in s_state
        )
        report = {
            "K": SUPERSTEP_K,
            "precision": BF16,
            "metrics_bitwise": torch.equal(got, want),
            "metric_max_rel_err": rel_err(torch, got, want),
            "state_tensors": len(s_state),
            "state_tensors_unequal": unequal[:8],
            "state_max_rel_err": state_err,
            "train_generators_equal": torch.equal(sgen.get_state(), fgen.get_state()),
            "finite": finite.tolist(),
            "bound": REPLAY_BOUND,
            "captured_fused_gru_calls": sfn.captured_launches,
        }
        del single, fused, fn
        report["profile"] = profile_replays(torch, sfn, replays=2)
    print("superstep_parity " + json.dumps(report), flush=True)
    per_replay = SUPERSTEP_K * 2 * (SCAN_CALLS + IMAGINE_CALLS)
    if (
        report["metric_max_rel_err"] > REPLAY_BOUND
        or state_err > REPLAY_BOUND
        or not report["train_generators_equal"]
        or not all(report["finite"])
        or sfn.captured_launches != SUPERSTEP_K * (SCAN_CALLS + IMAGINE_CALLS)
        or report["profile"]["gru_step_kernels_per_replay"] != per_replay
    ):
        raise AssertionError(f"a superstep against single replays: {report}")
    del sfn
    return report


def loop_sized_buffers(torch, np, rb):
    """A host buffer and a ring of the loop's size (buffer.size 100000 over
    4 envs), full, holding ``rb``'s PixelCatcher steps repeated."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer

    per_env = RING_LOOP_CUTS["buffer.size"] // 4
    host = EnvIndependentReplayBuffer(per_env, n_envs=4, obs_keys=["rgb"], buffer_cls=SequentialReplayBuffer, seed=SEED)
    for e, sub in enumerate(rb.buffer):
        host.add({k: np.resize(np.asarray(v)[: sub._pos], (per_env, *v.shape[1:])) for k, v in sub.buffer.items()}, [e])
    return host, DeviceReplayBuffer.from_host_buffer(host, device="cuda", seed=SEED)


def profile_window(torch, window):
    """torch.profiler over one ``window()``, after one unrecorded warm-up
    window (the profiler's first records of a session can be lost): wall
    and device-busy ms, the idle share, and the host-to-device bytes its
    copies moved (from the trace's memcpy records; None where the trace
    carries no byte counts)."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}

    def ready(prof):
        # the recorded window's events, read before the profiler clears them
        seen["busy_us"] = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                seen["copies"] = [e for e in json.load(f).get("traceEvents", []) if "HtoD" in str(e.get("name", ""))]

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready
    ) as prof:
        window()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    # nothing recorded (the handler never ran) reads as not measured
    busy_us, copies = seen.get("busy_us", 0), seen.get("copies", [])
    h2d = None
    if copies and all("bytes" in e.get("args", {}) for e in copies):
        h2d = sum(int(e["args"]["bytes"]) for e in copies)
    return {
        "wall_ms": 1e3 * seconds,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / seconds if busy_us else None,
        "h2d_copies": len(copies),
        "h2d_bytes": h2d,
    }


def replay_path(torch, np, name, cfg, host, ring, obs_space, actions_dim, is_continuous):
    """One of the four replay paths as ``main`` runs it, on seeded S models:
    returns ``(window, keep)``; ``window(n)`` trains n gradient steps (a
    multiple of K for the fused paths), ``keep`` holds what must live."""
    import itertools

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
        batch_inputs,
        ema_,
        make_fused_train_fn,
        make_train_fn,
        stream_seed,
    )
    from sheeprl_tpu_torch.data.device_buffer import draw_sequence_batch
    from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.ops.superstep import SAMPLE_KEY_SALT, pregathered

    dev = torch.device("cuda")
    freq = int(cfg["algo"]["critic"]["per_rank_target_network_update_freq"])
    tau = float(cfg["algo"]["critic"]["tau"])
    models, step, opts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    moments = init_moments(dev)
    done = [0]
    use_ring = name.startswith("ring")
    k = int(name.rsplit("_k", 1)[1])
    if k == 0:
        inputs = batch_inputs(ring if use_ring else host, TRAIN_T, TRAIN_B, ["rgb"], dev)
        fn = make_train_fn(step, models["wm"], models["actor"], models["critic"], opts, moments, inputs, gen)
        prefetcher = None if use_ring else BatchPrefetcher(host, TRAIN_B, TRAIN_T, inputs, int(cfg["buffer"]["prefetch"]), fn.done)

        def window(n):
            if use_ring:
                batches = ring.sample_batches(TRAIN_B, TRAIN_T, n, out=fn.inputs)
            else:
                batches = prefetcher.sampled_batches(n)
            for _ in batches:
                if done[0] % freq == 0:
                    ema_(models["critic"], models["target"], 1.0 if done[0] == 0 else tau)
                fn()
                done[0] += 1

        return window, (models, fn, prefetcher)
    feed = None
    if use_ring:
        bufs, pos, full = ring.superstep_inputs(TRAIN_T)
        sample_gen = torch.Generator(device="cuda").manual_seed(stream_seed(SEED, SAMPLE_KEY_SALT))
        fn = make_fused_train_fn(
            step, models["wm"], models["actor"], models["critic"], models["target"], opts, moments, cfg,
            lambda ctx, i: draw_sequence_batch(bufs, pos, full, sample_gen, TRAIN_B, TRAIN_T), k, None, (gen, sample_gen),
        )
    else:
        stack = batch_inputs(host, TRAIN_T, TRAIN_B, ["rgb"], dev, stack=k)
        fn = make_fused_train_fn(
            step, models["wm"], models["actor"], models["critic"], models["target"], opts, moments, cfg,
            pregathered, k, stack, (gen,),
        )
        feed = BatchPrefetcher(host, TRAIN_B, TRAIN_T, stack, int(cfg["buffer"]["prefetch"]), fn.done, n_samples=k)

    def window(n):
        for _ in itertools.repeat(None, n // k) if use_ring else feed.sampled_batches(n // k):
            if use_ring:
                ring.superstep_inputs(TRAIN_T)
            fn.inputs["counter"].fill_(done[0])
            fn()
            done[0] += k

    return window, (models, fn, feed)


def phase_replay_paths(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step, the device's idle share, host-to-device
    bytes per gradient step and peak memory of the four replay paths: the
    host buffer (pinned prefetch) and the ring (a gather on the card), each
    per step (K = 0, the EMA between replays) and in supersteps of K = 4
    (the ring drawing in the graph, the host buffer's batches copied as a
    stack); the K = 1 ring superstep's peak memory beside K = 4's."""
    start = time.perf_counter()
    cfg = train_cfg("pixel_catcher", precision=BF16)
    host, ring = loop_sized_buffers(torch, np, rb)
    report = {"buffer_size": RING_LOOP_CUTS["buffer.size"], "num_envs": 4, "ring_bytes": ring.ring_bytes(), "paths": {}}
    args = (cfg, host, ring, obs_space, actions_dim, is_continuous)
    runs = {}
    for name in ("ring_k1",) + PATHS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        window, keep = replay_path(torch, np, name, *args)
        window(PATH_STEPS)  # the capture, then a window
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        report["paths"][name] = {"peak_allocated_bytes": peak, "peak_added_bytes": peak - base}
        if name == "ring_k1":
            del window, keep
            torch.cuda.empty_cache()
        else:
            runs[name] = (window, keep)
    report["build_seconds"] = time.perf_counter() - start
    times = {name: [] for name in PATHS}
    report["clocks"] = []
    for name in PATHS + PATHS[::-1]:
        window = runs[name][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PATH_WINDOWS):
            window(PATH_STEPS)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / (PATH_WINDOWS * PATH_STEPS))
        report["clocks"].append(f"{name}: {clocks_line()}")
    report["timed_seconds"] = time.perf_counter() - start
    for name in PATHS:
        prof = profile_window(torch, lambda: runs[name][0](PATH_STEPS))
        report["paths"][name].update(
            ms_per_gradient_step=times[name],
            device_idle_share=prof["device_idle_share"],
            device_busy_ms_per_gradient_step=prof["device_busy_ms"] / PATH_STEPS,
            h2d_bytes_per_gradient_step=None if prof["h2d_bytes"] is None else prof["h2d_bytes"] / PATH_STEPS,
            h2d_copies_per_gradient_step=prof["h2d_copies"] / PATH_STEPS,
        )
    report["seconds"] = time.perf_counter() - start
    print("replay_paths " + json.dumps(report), flush=True)
    del runs, host, ring
    torch.cuda.empty_cache()
    return report


def phase_ring_loops(torch, np, fg, tmp):
    """(d) main() at phase 8(e)'s cuts with buffer.size 100000: the host
    buffer (memmapped) per step, the ring per step, the ring in supersteps
    of K = 4, each twice in turns. Returns ({way: the kernel's launches in
    its two runs, each counted from 0 just before it}, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main

    launches, report = {}, {"cuts": RING_LOOP_CUTS, **{name: [] for name in RING_LOOPS}}
    want_buffer = {"host_k0": "memmap", "ring_k0": "device", "ring_k4": "device"}
    for turn, name in enumerate(list(RING_LOOPS) + list(RING_LOOPS)[::-1]):
        extra = RING_LOOPS[name]
        cfg = train_cfg("pixel_catcher", precision=BF16, **RING_LOOP_CUTS, **extra, log_base_dir=tmp, run_name=f"{name}_{turn}")
        # ---- the main path: counts at 0 just before, read just after ----
        fg.reset_launch_count()
        out = train_main(cfg, device="cuda")
        calls, bf16_calls = fg.launch_count, fg.bf16_x_launch_count
        # ------------------------------------------------------------------
        captured = sum(g["captured_launches"] for g in out["graphs"])
        count = calls - captured + sum(g["captured_launches"] * g["replays"] for g in out["graphs"])
        launches[name] = launches.get(name, 0) + count
        run = {
            "replay_buffer": out["replay_buffer"],
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "seconds": out["seconds"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "gradient_steps_per_s": out["gradient_steps"] / out["seconds"],
            "train_seconds_device": out["train_seconds"],
            # the windows after the first two (which capture the graphs),
            # G = 4 steps each
            "steady_ms_per_gradient_step": 1e3 * float(np.median(out["train_window_seconds"][2:])) / 4,
            "graphs": out["graphs"],
            "fused_gru_launches": count,
            "clocks_after": clocks_line(),
        }
        report[name].append(run)
        if (
            out["replay_buffer"] != want_buffer[name]
            or out["captured_launches_per_step"] != SCAN_CALLS + IMAGINE_CALLS
            or sum(g["steps"] * g["replays"] for g in out["graphs"]) != out["gradient_steps"]
            or out["gradient_steps"] == 0
            or bf16_calls != calls
            or not all(np.isfinite(v) for v in out["metrics"].values())
        ):
            raise AssertionError(f"main() {name}: {run}, {bf16_calls} of {calls} wrapper calls with a bf16 x")
    print("ring_loops " + json.dumps(report), flush=True)
    return launches, report


def phase_ring_drill(torch, np, tmp):
    """(d) the drill: main() on the ring with the buffer checkpointed, the
    checkpoint's ring restored into a memmapped host buffer and back into a
    ring (each equal to the saved contents and cursors), then main()
    resumed from it on the memmapped host buffer, and from that run's
    checkpoint on the ring with supersteps; the counters continue."""
    import os

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer, adapt_restored_buffer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    common = {**RING_DRILL_CUTS, "log_base_dir": tmp, "run_name": "ring_drill"}
    first = train_main(train_cfg("pixel_catcher", precision=BF16, **common, **{"buffer.device": True}), device="cuda")
    steps = RING_DRILL_CUTS["algo.total_steps"]
    ckpt = os.path.join(first["log_dir"], "checkpoint", f"ckpt_{steps}_0.ckpt")
    saved = load_checkpoint(ckpt)["rb"]
    want = saved.host_arrays()
    host = adapt_restored_buffer(load_checkpoint(ckpt)["rb"], False, memmap=True, memmap_dir=os.path.join(tmp, "drill_memmap"))
    host_equal = all(host.is_memmap) and all(
        sub._pos == saved._pos[e]
        and sub.full == saved._full[e]
        and all(np.array_equal(np.asarray(sub.buffer[k])[:, 0], want[k][e]) for k in want)
        for e, sub in enumerate(host.buffer)
    )
    ring = adapt_restored_buffer(host, True, seed=SEED, device="cuda")
    back = ring.host_arrays()
    ring_equal = (
        isinstance(ring, DeviceReplayBuffer)
        and np.array_equal(ring._pos, saved._pos)
        and np.array_equal(ring._full, saved._full)
        and all(np.array_equal(back[k], want[k]) for k in want)
    )
    del host, ring
    resume_host = {**common, "buffer.device": False, "checkpoint.resume_from": ckpt, "algo.total_steps": RING_DRILL_RESUMES[0]}
    second = train_main(train_cfg("pixel_catcher", precision=BF16, **resume_host), device="cuda")
    ckpt2 = os.path.join(second["log_dir"], "checkpoint", f"ckpt_{RING_DRILL_RESUMES[0]}_0.ckpt")
    resume_ring = {
        **common,
        "buffer.device": True,
        "algo.fused_gradient_steps": SUPERSTEP_K,
        "checkpoint.resume_from": ckpt2,
        "algo.total_steps": RING_DRILL_RESUMES[1],
    }
    third = train_main(train_cfg("pixel_catcher", precision=BF16, **resume_ring), device="cuda")
    keys = ("replay_buffer", "start_update", "env_steps", "gradient_steps", "seconds")
    report = {
        "cuts": common,
        "restored_host_equals_saved_ring": host_equal,
        "restored_ring_equals_saved_ring": ring_equal,
        "first": {k: first[k] for k in keys},
        "second": {k: second[k] for k in keys},
        "third": {k: third[k] for k in keys},
    }
    print("ring_drill " + json.dumps(report), flush=True)
    num_envs = 4
    resumes = (steps,) + RING_DRILL_RESUMES
    for run, kind, (before, after) in zip((second, third), ("memmap", "device"), zip(resumes, resumes[1:])):
        # the buffer came back, so training resumes at once: Ratio owes one
        # step a policy step since its last call
        if (
            run["replay_buffer"] != kind
            or run["start_update"] != before // num_envs + 1
            or run["env_steps"] != after
            or run["gradient_steps"] != after - before
        ):
            raise AssertionError(f"the ring drill's resume: {report}")
    if first["replay_buffer"] != "device" or not host_equal or not ring_equal:
        raise AssertionError(f"the ring drill: {report}")
    return report


# phase 10: the entry point on the card. The CLI runs 8(e)'s loop (S width,
# bf16-mixed, the ring) with telemetry, a log window every 64 env steps
# (three of them after learning starts) and a checkpoint every 128 with the
# ring in it, so the resume from the mid-run one trains on to the end
CLI_CUTS = {**LOOP_CUTS, "metric.log_every": 64, "checkpoint.every": 128, "buffer.checkpoint": True}
CLI_RESUME_FROM = "ckpt_256_0.ckpt"
CLI_TIMEOUT = 300


def cli_argv(tmp: str, run_name: str, telemetry: bool = True, **extra) -> list:
    """The CLI's arguments: exp=dreamer_v3 on PixelCatcher with the cuts,
    logs and the run registry under ``tmp``."""
    args = {
        "seed": SEED,
        **CLI_CUTS,
        "metric.telemetry.enabled": telemetry,
        "log_base_dir": f"{tmp}/logs",
        "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl",
        "run_name": run_name,
        **extra,
    }
    return ["exp=dreamer_v3", "env=pixel_catcher"] + [f"{k}={v}" for k, v in args.items()]


def run_module(module: str, argv: list, tmp: str) -> tuple:
    """``python -m module argv`` in a temporary cwd with the repository on
    ``PYTHONPATH`` and the run registry under ``tmp``; raises on a non-zero
    exit. Returns (stdout, seconds)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, SHEEPRL_TPU_RUNS_JSONL=f"{tmp}/RUNS.jsonl")
    cwd = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv], cwd=cwd, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout, seconds


def cli_in_process(torch, fg, argv: list) -> tuple:
    """``cli.run(argv)`` in this process, its printing kept apart; returns
    (main's report, wrapper calls, seconds)."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    out = {}
    real_main = dv3.main

    def keep(fabric, cfg):
        out.update(real_main(fabric, cfg))

    buf = io.StringIO()
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    t0 = time.perf_counter()
    with mock.patch.object(dv3, "main", keep), contextlib.redirect_stdout(buf):
        cli.run(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls = fg.launch_count
    # ------------------------------------------------------------------
    return out, calls, seconds


def run_dir(tmp: str, run_name: str) -> str:
    return f"{tmp}/logs/dreamer_v3/pixel_catcher/{run_name}"


def phase_cli(torch, np, fg, tmp: str, loop_report: dict):
    """(a) ``python -m sheeprl_tpu_torch exp=dreamer_v3 env=pixel_catcher``
    with telemetry: exit 0, ``config.yaml``, an event file the port's reader
    decodes with every train metric and ``Time/sps_*`` at each log window
    after learning starts (rewards where episodes ended), all finite,
    heartbeats naming the card with a device memory peak and 0 < MFU <= 1,
    one ``completed`` run record; then the same argv in this process through
    ``cli.run`` for the kernel's launches. (b) ``cli_eval`` on (a)'s last
    checkpoint: one capped episode on the card and an eval record. (c) the
    CLI resuming (a)'s mid-run checkpoint with ``fabric.precision=32-true``
    on the command line: the stored config with that override, trained to
    the end. (d) env-steps/s of the in-process CLI run against 8(e)'s loop,
    telemetry on and off, FLOPs a gradient step and the heartbeat's MFU.
    Returns (launches, report)."""
    import glob
    import os

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.obs.registry import read_run_records
    from sheeprl_tpu_torch.ops.graph import WARMUP_STEPS
    from sheeprl_tpu_torch.utils.logger import read_scalars

    t10 = time.perf_counter()
    card = card_line()
    runs = f"{tmp}/RUNS.jsonl"
    # (a) the CLI in a subprocess
    _, a_seconds = run_module("sheeprl_tpu_torch", cli_argv(tmp, "cli_a"), tmp)
    base = run_dir(tmp, "cli_a")
    version = f"{base}/version_0"
    stored = load_config_file(f"{version}/config.yaml")
    if stored["fabric"]["precision"] != BF16 or any(stored.get_nested(k) != v for k, v in CLI_CUTS.items()):
        raise AssertionError(f"cli (a): the stored config is not the run's: {stored['fabric']} {stored['algo']}")
    events = glob.glob(f"{version}/events.out.tfevents.*")
    if len(events) != 1:
        raise AssertionError(f"cli (a): want one event file, found {events}")
    by_step = {}
    for step, tag, value in read_scalars(events[0]):
        by_step.setdefault(step, {})[tag] = value
    learning_starts = CLI_CUTS["algo.learning_starts"]
    train_windows = [s for s in sorted(by_step) if s >= learning_starts]
    want = set(METRIC_ORDER) | {"Time/sps_train", "Time/sps_env_interaction"}
    for step in sorted(by_step):
        tags = by_step[step]
        missing = (want if step in train_windows else {"Time/sps_env_interaction"}) - set(tags)
        if missing or not all(np.isfinite(v) for v in tags.values()):
            raise AssertionError(f"cli (a): event file at step {step}: missing {sorted(missing)} or non-finite {tags}")
    rewards = [s for s in by_step if "Rewards/rew_avg" in by_step[s] and "Game/ep_len_avg" in by_step[s]]
    if len(train_windows) < 2 or not rewards:
        raise AssertionError(f"cli (a): log windows {sorted(by_step)}, reward windows {rewards}")
    beats = [json.loads(line) for line in open(f"{base}/telemetry.jsonl")]
    beats = [e for e in beats if e["event"] == "heartbeat"]
    kind = torch.cuda.get_device_name(0)
    mfus = [b["mfu"] for b in beats if "mfu" in b]
    if (
        len(beats) != len(by_step)
        or any(b["device_kind"] != kind or not b["hbm_peak_bytes"] > 0 for b in beats)
        or not mfus
        or not all(0 < m <= 1 for m in mfus)
    ):
        raise AssertionError(f"cli (a): heartbeats {beats}")
    records = read_run_records(runs)
    if [(r["kind"], r["outcome"], r["run_name"]) for r in records] != [("train", "completed", "cli_a")]:
        raise AssertionError(f"cli (a): run records {records}")
    last_ckpt = f"ckpt_{CLI_CUTS['algo.total_steps']}_0.ckpt"
    ckpts = sorted(os.listdir(f"{version}/checkpoint"))
    if CLI_RESUME_FROM not in ckpts or last_ckpt not in ckpts:
        raise AssertionError(f"cli (a): checkpoints {ckpts}")
    print(
        "cli_train " + json.dumps({
            "seconds_with_startup": a_seconds, "log_steps": sorted(by_step), "train_log_steps": train_windows,
            "heartbeats": len(beats), "mfu": mfus, "flops_per_train_step": beats[-1].get("flops_per_train_step"),
            "hbm_peak_bytes": beats[-1]["hbm_peak_bytes"], "device_kind": kind, "record": records[0]["outcome"],
            "checkpoints": ckpts, "last_metrics": {k: by_step[max(by_step)][k] for k in METRIC_ORDER},
        }),
        flush=True,
    )
    # the same argv in this process: the kernel's launches on the main path
    out, calls, on_seconds = cli_in_process(torch, fg, cli_argv(tmp, "cli_b"))
    per_step = SCAN_CALLS + IMAGINE_CALLS
    acting = (CLI_CUTS["algo.total_steps"] - learning_starts) // 4
    captured = out["captured_launches_per_step"]
    launches = calls - captured + captured * out["replays"]
    if captured != per_step or out["replays"] != out["gradient_steps"] or calls != acting + (WARMUP_STEPS + 1) * per_step:
        raise AssertionError(
            f"cli in process: {calls} wrapper calls (want {acting} + {WARMUP_STEPS + 1} x {per_step}), "
            f"{captured} captured a step, {out['replays']} replays for {out['gradient_steps']} steps"
        )
    record_b = read_run_records(runs)[-1]
    # (b) cli_eval on (a)'s last checkpoint, one episode capped at EVAL_CAP
    eval_out, b_seconds = run_module(
        "sheeprl_tpu_torch.cli_eval",
        [f"checkpoint_path={version}/checkpoint/{last_ckpt}", f"env.max_episode_steps={EVAL_CAP}"],
        tmp,
    )
    record = read_run_records(runs)[-1]
    if "Test - Reward:" not in eval_out or (record["kind"], record["outcome"]) != ("eval", "completed"):
        raise AssertionError(f"cli_eval: {eval_out[-2000:]} {record}")
    reward = float(eval_out.split("Test - Reward:")[-1].split()[0])
    # (c) resume (a)'s mid-run checkpoint at fp32 from the command line
    _, c_seconds = run_module(
        "sheeprl_tpu_torch",
        [
            "exp=dreamer_v3",
            "env=pixel_catcher",
            f"checkpoint.resume_from={version}/checkpoint/{CLI_RESUME_FROM}",
            f"fabric.precision={FP32}",
            "metric.telemetry.enabled=True",
            f"metric.telemetry.runs_jsonl={runs}",
            "run_name=cli_c",
        ],
        tmp,
    )
    resumed = load_config_file(f"{run_dir(tmp, 'cli_c')}/version_0/config.yaml")
    record_c = read_run_records(runs)[-1]
    resumed_ckpts = sorted(os.listdir(f"{run_dir(tmp, 'cli_c')}/version_0/checkpoint"))
    if (
        resumed["fabric"]["precision"] != FP32
        or resumed["algo"]["total_steps"] != CLI_CUTS["algo.total_steps"]
        or (record_c["kind"], record_c["outcome"]) != ("train", "completed")
        or not record_c["train_gradient_steps"] > 0
        or last_ckpt not in resumed_ckpts
    ):
        raise AssertionError(f"cli resume: {resumed['fabric']} {record_c} {resumed_ckpts}")
    # (d) the same in-process run with telemetry off
    off, _, off_seconds = cli_in_process(torch, fg, cli_argv(tmp, "cli_d", telemetry=False))
    report = {
        "card": card,
        "cuts": CLI_CUTS,
        "env_steps_per_s": {
            "cli_telemetry_on": out["env_steps"] / out["seconds"],
            "cli_telemetry_off": off["env_steps"] / off["seconds"],
            "phase_8e_loop": loop_report["env_steps_per_s"],
        },
        "loop_seconds": {"cli_telemetry_on": out["seconds"], "cli_telemetry_off": off["seconds"], "phase_8e_loop": loop_report["seconds"]},
        "cli_run_seconds_in_process": {"telemetry_on": on_seconds, "telemetry_off": off_seconds},
        "subprocess_seconds": {"train": a_seconds, "eval": b_seconds, "resume": c_seconds},
        "flops_per_gradient_step": record_b.get("flops_per_train_step"),
        "mfu_last_heartbeat": record_b.get("mfu"),
        "mfu_subprocess_heartbeats": mfus,
        "sps_train_registry": record_b.get("sps_train"),
        "fused_gru_wrapper_calls": calls,
        "fused_gru_launches": launches,
        "replays": out["replays"],
        "eval_reward": reward,
        "resume_gradient_steps": record_c["train_gradient_steps"],
        "resume_precision": resumed["fabric"]["precision"],
    }
    print(f"phase 10 on {card}: cli " + json.dumps(report), flush=True)
    print(f"phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    return launches, report


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        from sheeprl_tpu_torch.ops import _build
        from sheeprl_tpu_torch.ops import fused_gru as fg
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False")

    # phase 1: card and build
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fg.load_library()
    print(f"build: {fg.KERNEL} in {time.perf_counter() - t0:.2f} s", flush=True)
    print(_build.PTXAS_REPORT[fg.KERNEL], flush=True)

    # phase 2: kernel against plain (S: X = 32*32 + 3 actions)
    shapes = {
        "S_B1": (1, 1027, 512, 512),
        "S_B4": (4, 1027, 512, 512),
        "S_B16": (16, 1027, 512, 512),
        "M_B4": (4, 1027, 640, 1024),
        "S_B1024": (1024, 1027, 512, 512),
    }
    max_err, rows = phase_kernel(torch, fg, shapes)

    # phase 3: the slice
    launches = phase_slice(torch, np, fg)

    # phase 4: the model-sharded step, (a) its projection kernel, (b) the step
    bf16 = torch.bfloat16
    proj_shapes = {  # (B, H, D, C = 3H/mp, W2s storage)
        "S_mp1_fp32_B4": (4, 512, 512, 1536, torch.float32),
        "S_mp1_fp32_B16": (16, 512, 512, 1536, torch.float32),
        "XL_mp1_bf16_B16": (16, 4096, 1024, 12288, bf16),
        "L_mp4_bf16_B16": (16, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B64": (64, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B256": (256, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B1024": (1024, 2048, 768, 1536, bf16),
        "XL_mp16_bf16_B16": (16, 4096, 1024, 768, bf16),
        "XL_mp16_bf16_B1024": (1024, 4096, 1024, 768, bf16),
    }
    proj_err, proj_rows = phase_proj(torch, fg, proj_shapes)
    proj_launches = phase_sharded_step(torch, np, fg)

    # phase 6: training, (a) fused against plain and (b) launches a step,
    # (c) time an eager step, (d) the short loop (replayed steps)
    step_launches, rb, obs_space, actions_dim, is_continuous = phase_train_parity(torch, np, fg)
    timing = phase_train_timing(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    with tempfile.TemporaryDirectory() as tmp:
        loop_launches, loop = phase_train_loop(torch, np, fg, tmp)

    # phase 7: the captured step, (a) replayed against eager, (b) fresh
    # noise, (c) time a replayed step, (d) rollback and resume on main()
    phase_replay_parity(torch, np, rb, obs_space, actions_dim, is_continuous)
    replay = phase_replay_timing(torch, rb, obs_space, actions_dim, is_continuous)
    with tempfile.TemporaryDirectory() as tmp:
        phase_drill(torch, np, tmp)

    # phase 8: the default precision, bf16-mixed: (a) B1 with a bf16 x, (b)
    # the eager step against plain and fp32, (c) replayed against eager, (d)
    # ms a replayed step with a profile, (e) the short loop, (f) the player
    bf16_err, bf16_rows = phase_bf16_kernel(torch, fg, BF16_KERNEL_SHAPES)
    phase_bf16_train(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    print("bf16_replay_parity " + json.dumps(replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, BF16)), flush=True)
    bf16_timing = phase_bf16_timing(torch, rb, obs_space, actions_dim, is_continuous)
    with tempfile.TemporaryDirectory() as tmp:
        bf16_loop_launches, bf16_loop = phase_train_loop(torch, np, fg, tmp, BF16, "bf16_train_loop")
    bf16_player_launches, bf16_player = phase_bf16_player(torch, np, fg)

    # phase 9: replay where the JAX package keeps it (bf16-mixed): (a) the
    # ring on the card, (b) a superstep against single replays, (c) the four
    # replay paths timed, (d) main() three ways and the drill across modes
    t9 = time.perf_counter()
    phase_ring(torch, np)
    superstep = phase_superstep_parity(torch, np, rb, obs_space, actions_dim, is_continuous)
    paths = phase_replay_paths(torch, np, rb, obs_space, actions_dim, is_continuous)
    with tempfile.TemporaryDirectory() as tmp:
        ring_loop_launches, ring_loops = phase_ring_loops(torch, np, fg, tmp)
        phase_ring_drill(torch, np, tmp)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)

    # phase 10: the entry point, (a) train through the CLI, (b) cli_eval,
    # (c) resume with a precision override, (d) times
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli = phase_cli(torch, np, fg, tmp, bf16_loop)

    # phase 5: the kernels line, then the device line
    main_row = next(r for r in rows if r["shape"] == "S_B4")
    big_row = next(r for r in rows if r["shape"] == "S_B1024")
    proj_row = next(r for r in proj_rows if r["shape"] == "L_mp4_bf16_B16")
    kernels = [
        {
            "name": "fused_gru",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/fused_gru.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:178",
            "launches": launches + loop_launches + bf16_loop_launches + bf16_player_launches + sum(ring_loop_launches.values()) + cli_launches,
            # every launch of the bf16-mixed paths read a bf16 x (checked there)
            "launches_bf16_x": bf16_loop_launches + bf16_player_launches + sum(ring_loop_launches.values()) + cli_launches,
            "launches_by_path": {
                "player_and_evaluate": launches,
                "train_loop": loop_launches,
                "train_loop_replays": loop["replays"],
                "bf16_train_loop": bf16_loop_launches,
                "bf16_train_loop_replays": bf16_loop["replays"],
                "bf16_player": bf16_player_launches,
                "bf16_ring_train_loops": ring_loop_launches,
                "cli_train_loop": cli_launches,
                "cli_train_loop_replays": cli["replays"],
                "per_gradient_step": step_launches,
                "per_superstep_replay_by_profiler": superstep["profile"]["gru_step_kernels_per_replay"] / 2,
                "per_replayed_step_by_profiler": replay["profile_fused"]["gru_step_kernels_per_replay"] / 2,
            },
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            # no single PyTorch call computes the fused step
            "library_ms": None,
            "B1024": {k: big_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "ms_per_gradient_step_eager": min(timing["ms_per_gradient_step_fused"]),
            "ms_per_gradient_step_replayed": min(replay["ms_per_gradient_step_fused_replayed"]),
            "train_loop_env_steps_per_s": loop["env_steps_per_s"],
            "bf16_x": {
                "max_abs_err": bf16_err,
                **{r["shape"]: {k: r[k] for k in ("ms", "fp32_x_ms", "plain_ms", "bound_ms", "bound_by")} for r in bf16_rows},
                "ms_per_replayed_step": min(bf16_timing["ms_per_replayed_step_b1_bf16"]),
                "train_loop_env_steps_per_s": bf16_loop["env_steps_per_s"],
                "player_env_steps_per_s": bf16_player["env_steps_per_s"],
                "ms_per_gradient_step_by_replay_path": {k: min(v["ms_per_gradient_step"]) for k, v in paths["paths"].items() if k in PATHS},
                "ring_train_loop_env_steps_per_s": {k: [r["env_steps_per_s"] for r in ring_loops[k]] for k in RING_LOOPS},
                "cli_env_steps_per_s": cli["env_steps_per_s"],
                "cli_mfu": cli["mfu_last_heartbeat"],
            },
        },
        {
            "name": "sharded_proj",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/fused_gru.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:307",
            "launches": proj_launches,
            "max_abs_err": proj_err,
            "ms": proj_row["ms"],
            "plain_ms": proj_row["plain_ms"],
            "bound_ms": proj_row["bound_ms"],
            "bound_by": proj_row["bound_by"],
            "library_ms": proj_row["library_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # any failed phase: report and exit non-zero, no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
