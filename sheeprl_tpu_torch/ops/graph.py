"""The train step as one CUDA graph (the counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py::make_train_fn``, :331-366,
where the JAX package jits the step into one program).

``CapturedStep`` holds static input tensors for the batch; on a CUDA card
its first call warms the step up on a side stream, puts back every piece
of state the warm-up moved, captures one step with ``torch.cuda.graph``
into the graph's own memory pool, and replays it; every later call replays.
One replay runs the whole step: the world-model scan and imagination
through the fused RSSM kernel, the losses, the three backward passes (the
kernel's recompute backward included) and the three optimizer updates. The
host issues one launch where the eager step issues thousands.

What the graph reads and writes must stay where it was captured: the step
updates the parameters, Adam's ``mu``, ``nu`` and ``count`` and the
Moments in place, and the caller copies each batch into ``inputs``. The
step's noise comes from ``generators``, registered with the graph, so every
replay draws fresh samples from each generator's current state (which a
checkpoint saves and a rollback re-seeds between replays).

One capture may hold several gradient steps: a fused superstep
(``ops/superstep.py``) is a callable that runs K steps and returns their
stacked outputs, captured and replayed here the same way. Its warm-up runs
the whole callable, so fewer calls warm it up (``warmup``).

On the CPU the same callable runs the step eagerly; that is what the tests
run. There is no fallback on the card: a failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from sheeprl_tpu_torch.ops import fused_gru

# warm-up steps before capture: lazy initialisation (cuBLAS and cuDNN
# handles, the kernel library, autograd's streams) must not happen inside it
WARMUP_STEPS = 2
# graphs captured in this process: capture is the port's compile step, and
# run telemetry counts it (``obs/telemetry.py::CaptureWatchdog``)
capture_count = 0


Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


@contextlib.contextmanager
def collector_paused(collect: bool = True) -> Iterator[None]:
    """Collect once (unless ``collect`` is off), then keep Python's cyclic
    collector off inside: a dead graph that the collector frees mid-capture
    resets itself inside the capture, which invalidates it. Nested (a
    caller capturing several graphs under one), the inner one does nothing.
    A caller that pauses other work for its captures (a server pausing its
    replicas) passes ``collect=False``: a full collection holds the
    interpreter lock for as long as it takes, and the pause with it."""
    if not gc.isenabled():
        yield
        return
    if collect:
        gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@contextlib.contextmanager
def _side_stream_capture(graph: torch.cuda.CUDAGraph, device: torch.device) -> Iterator[None]:
    """``torch.cuda.graph(graph)`` without its preamble: the capture begins
    on a side stream that waits for the current one, with no device
    synchronise and no release of the device and pinned-host allocators'
    caches first. In a serving pause that release (every free cached block
    handed back, pinned ones through ``cudaFreeHost``) took 0.15-0.36 s of
    a 0.43 s pause on the H100; a process capturing many large graphs (a
    training run) needs it, so that each new graph's pool reuses the memory
    the last ones left cached."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            yield
        finally:
            graph.capture_end()


@contextlib.contextmanager
def _timed(ctx: contextlib.AbstractContextManager, parts: Dict[str, float]) -> Iterator[None]:
    """``ctx`` entered and left, the seconds of each in ``parts``
    (``enter_s``: the capture begun; ``instantiate_s``: ended and the graph
    instantiated)."""
    t0 = time.perf_counter()
    ctx.__enter__()
    parts["enter_s"] = time.perf_counter() - t0
    try:
        yield
    except BaseException:
        ctx.__exit__(*sys.exc_info())
        raise
    t1 = time.perf_counter()
    ctx.__exit__(None, None, None)
    parts["instantiate_s"] = time.perf_counter() - t1


class CapturedStep:
    """``step(inputs) -> outputs`` on ``inputs``, replayed from one CUDA
    graph on the card and run eagerly on the CPU. ``outputs`` is a tensor
    or a tuple of tensors. ``state`` lists every tensor the step updates in
    place (restored after the warm-up); ``generators`` (one or several) are
    registered with the graph; ``warmup`` calls run before the capture;
    ``release_caches`` (the default) empties the allocators' caches before
    it, as ``torch.cuda.graph`` does (``_side_stream_capture`` does not)."""

    def __init__(
        self,
        step: Callable[[Dict[str, torch.Tensor]], Outputs],
        inputs: Dict[str, torch.Tensor],
        state: Sequence[torch.Tensor],
        generators: Union[None, torch.Generator, Sequence[torch.Generator]] = None,
        warmup: int = WARMUP_STEPS,
        release_caches: bool = True,
    ) -> None:
        self.step = step
        # capture with torch.cuda.graph's cache release or without
        # (``_side_stream_capture``)
        self.release_caches = bool(release_caches)
        self.inputs = inputs
        self.state = list(state)
        if generators is None:
            generators = ()
        self.generators = (generators,) if isinstance(generators, torch.Generator) else tuple(generators)
        self.warmup = int(warmup)
        self.device = next(iter(inputs.values())).device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[Outputs] = None
        # recorded after each replay: a copy into ``inputs`` waits for it
        self.done = torch.cuda.Event() if self.device.type == "cuda" else None
        self.replays = 0
        # fused_gru kernel calls recorded into the graph: each replay
        # launches them again without calling the wrapper
        self.captured_launches = 0
        # with ``count_flops`` set before the first call, that call's first
        # eager run (a warm-up on the card) is counted into ``flops``
        self.count_flops = False
        self.flops: Optional[float] = None
        # the capture's seconds by part: the warm-up, beginning the
        # capture, the step captured, and ending it (the graph
        # instantiated); see ``_timed``
        self.capture_parts: Dict[str, float] = {}

    def _eager(self) -> Outputs:
        if self.count_flops and self.flops is None:
            from sheeprl_tpu_torch.obs.flops import count_flops

            out, self.flops = count_flops(self.step, self.inputs)
            return out
        return self.step(self.inputs)

    @torch.no_grad()
    def _restore(self, saved: Sequence[torch.Tensor]) -> None:
        for t, s in zip(self.state, saved):
            t.copy_(s)

    def warm(self) -> Optional[Outputs]:
        """Run the warm-up calls on a side stream, then restore the state
        and the generators; returns the last call's outputs. A caller that
        pauses other work for its captures (a server pausing its replicas)
        warms up before the pause: no capture is underway, so replays
        elsewhere may run beside it."""
        t0 = time.perf_counter()
        dev = self.device
        saved = [t.detach().clone() for t in self.state]
        gen_states = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        out = None
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                out = self._eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore(saved)
        for g, state in zip(self.generators, gen_states):
            g.set_state(state)
        self.capture_parts["warmup_s"] = time.perf_counter() - t0
        return out

    def capture(self) -> None:
        """Capture one call, warming up first unless :meth:`warm` ran."""
        if "warmup_s" not in self.capture_parts:
            self.warm()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = fused_gru.launch_count
        parts = self.capture_parts
        ctx = torch.cuda.graph(graph) if self.release_caches else _side_stream_capture(graph, self.device)
        with collector_paused(), _timed(ctx, parts):
            t0 = time.perf_counter()
            self._out = self.step(self.inputs)
            parts["capture_s"] = time.perf_counter() - t0
        self.captured_launches = fused_gru.launch_count - before
        self.graph = graph
        global capture_count
        capture_count += 1

    def replay(self) -> Outputs:
        """One replay on the current stream (capturing first if needed);
        returns the graph's own output tensors, which the next replay
        overwrites. On the card only."""
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        return self._out

    def __call__(self) -> Outputs:
        """One call of the step on ``inputs``; returns its outputs (tensors
        of their own: the graph's outputs are copied out)."""
        if self.device.type != "cuda":
            return self._eager()
        self.replay()
        self.done.record(torch.cuda.current_stream(self.device))
        if isinstance(self._out, tuple):
            return tuple(t.clone() for t in self._out)
        return self._out.clone()
