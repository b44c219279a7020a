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
step's noise comes from ``generator``, registered with the graph, so every
replay draws fresh samples from the generator's current state (which a
checkpoint saves and a rollback re-seeds between replays).

On the CPU the same callable runs the step eagerly; that is what the tests
run. There is no fallback on the card: a failed capture or replay raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.ops import fused_gru

# warm-up steps before capture: lazy initialisation (cuBLAS and cuDNN
# handles, the kernel library, autograd's streams) must not happen inside it
WARMUP_STEPS = 2


class CapturedStep:
    """``step(inputs) -> metrics`` on ``inputs``, replayed from one CUDA
    graph on the card and run eagerly on the CPU. ``state`` lists every
    tensor the step updates in place (restored after the warm-up)."""

    def __init__(
        self,
        step: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
        inputs: Dict[str, torch.Tensor],
        state: Sequence[torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> None:
        self.step = step
        self.inputs = inputs
        self.state = list(state)
        self.generator = generator
        self.device = next(iter(inputs.values())).device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        # recorded after each replay: a copy into ``inputs`` waits for it
        self.done = torch.cuda.Event() if self.device.type == "cuda" else None
        self.replays = 0
        # fused_gru kernel calls recorded into the graph: each replay
        # launches them again without calling the wrapper
        self.captured_launches = 0

    @torch.no_grad()
    def _restore(self, saved: Sequence[torch.Tensor]) -> None:
        for t, s in zip(self.state, saved):
            t.copy_(s)

    def capture(self) -> None:
        """Warm up, restore the state, capture one step."""
        dev = self.device
        saved = [t.detach().clone() for t in self.state]
        gen_state = self.generator.get_state() if self.generator is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.step(self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore(saved)
        if self.generator is not None:
            self.generator.set_state(gen_state)
        del saved
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = fused_gru.launch_count
        with torch.cuda.graph(graph):
            self._out = self.step(self.inputs)
        self.captured_launches = fused_gru.launch_count - before
        self.graph = graph

    def __call__(self) -> torch.Tensor:
        """One gradient step on ``inputs``; returns its metrics (a tensor
        of its own: the graph's output is copied out)."""
        if self.device.type != "cuda":
            return self.step(self.inputs)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        self.done.record(torch.cuda.current_stream(self.device))
        return self._out.clone()
