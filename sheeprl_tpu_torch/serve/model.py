"""The model side of the serving tier: one CUDA graph a batch rung, and hot
swap (port of ``sheeprl_tpu/serve/model.py``).

**Batch ladder.** The policy forward is captured as one CUDA graph for each
rung of ``serve.batch_ladder`` (:class:`CompiledLadder`, the counterpart of
the JAX package's AOT-compiled ladder) *before the server accepts traffic*,
so no request pays a warm-up or a capture. A gathered micro-batch is staged
into the rung's pinned host buffers (zero-padded up to the rung), copied to
the rung's static device inputs, replayed, and its actions copied back and
sliced to the requests. On the CPU (``fabric.accelerator=cpu``) a rung runs
the eager forward under ``torch.inference_mode()``. There is no fallback on
the card: a failed capture or replay raises.

**Graphs hold addresses.** A CUDA graph reads its inputs and weights from
the addresses it was captured with, where the JAX executable takes its
params as a call argument. So:

- each replica slot owns its rung graphs, their buffers and its stream
  (two replicas never race on one graph's static tensors), and the graphs
  survive the restarts of that slot's replica thread. One thread at a time
  runs a slot's graphs (:meth:`ModelStore.infer` holds the slot's lock):
  a replica abandoned as hung may still wake inside them, and its
  replacement is started only once it has left (``ModelStore.slot_busy``);
- a slot has a device (``slot_devices``). The replica fleet's device slots
  all sit on the card; its CPU-spill slots sit on ``torch.device("cpu")``
  by configuration, and there a rung runs the eager forward on the
  version's params copied to the CPU once a version (a hot swap re-places
  them with the rest of the version). A standby slot (``standby``) is
  captured only when :meth:`ModelStore.capture_slot` activates it, before
  it takes traffic;
- each :class:`ModelVersion` owns a graph set captured over its own
  weights: a hot swap captures the candidate's set and then flips the
  current version, so a batch is computed by exactly one version, whose
  step the replica stamps on its requests;
- a capture runs in CUDA's global capture mode, in which CUDA work from
  any other thread breaks it (the ``thread_local`` mode, with the
  replicas replaying beside it, does not hold either: such a capture can be
  invalidated). Captures therefore happen only while nothing
  serves: at :class:`ModelStore` construction (before the replicas start)
  and, for a swap or a standby slot's activation, under the
  :class:`ServingGate` held exclusively, which waits for the batches in
  flight and pauses the next ones, one slot's set at a time with serving
  resumed in between (a fleet's three slots captured under one pause held
  requests past a 400 ms deadline). Everything else a slot's set needs
  (the params placed, the forward bound, the staging and static inputs
  allocated, the warm-up run) is built before its pause, while the old
  version serves; the capture itself releases no allocator cache
  (``ops/graph.py::_side_stream_capture``). Without a full collection first, a
  slot's captures pause serving for about a hundredth of a second
  (``pauses_s`` in the swap event, ``pause_s`` the longest, each pause by
  part in ``pause_parts``). Freeing a version's graphs (a flip or a
  rollback dropping one) also happens under the gate.

**Hot swap.** Promotion is validate-then-promote; a candidate must pass ALL
of:

1. committed manifest present (torn writes are invisible by construction —
   the scan only sees :func:`committed_checkpoints`),
2. manifest ``tree_digest``/``leaf_count`` match the loaded state (detects a
   corrupted or foreign checkpoint behind a valid-looking manifest),
3. extracted params are structurally identical to the serving params (same
   names, shapes and dtypes),
4. all weights finite (a NaN-poisoned checkpoint must not reach traffic),
5. its graph set captures, and a smoke inference through its smallest rung
   returns finite outputs.

Any failure leaves the previous version serving; :meth:`ModelStore.rollback`
additionally restores the previous version if a promoted one misbehaves.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.obs.trace import trace_event
from sheeprl_tpu_torch.ops.graph import CapturedStep, collector_paused
from sheeprl_tpu_torch.resilience.manifest import CommittedCheckpoint, committed_checkpoints, tree_digest
from sheeprl_tpu_torch.resilience.sentinel import all_finite, host_all_finite
from sheeprl_tpu_torch.serve.errors import SwapRejected
from sheeprl_tpu_torch.serve.fault_injection import ServeFaultSchedule
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

# per-request observation layout: key -> (shape without the batch axis, numpy dtype)
ObsSpec = Dict[str, Tuple[Tuple[int, ...], np.dtype]]
Params = Dict[str, torch.Tensor]
Forward = Callable[[Dict[str, torch.Tensor]], torch.Tensor]

# how long a capture or a flip waits for the batches in flight
PAUSE_TIMEOUT_S = 10.0
# how often a replica waiting on the gate shows it is alive
BEAT_S = 0.05


@dataclass
class ServedPolicy:
    """Everything the server needs to run one policy:

    - ``bind(params) -> forward`` — the JAX package's ``apply(params, obs)``
      with the weights bound: ``forward(obs) -> actions`` maps a dict of
      batched device tensors to a ``[batch, ...]`` tensor, and reads its
      weights from exactly the tensors of ``params`` (a graph captured over
      it keeps their addresses);
    - ``params`` — the initial weights (name -> tensor on ``device``);
    - ``obs_spec`` — per-request ``(shape, dtype)`` of each observation key
      (no batch axis) that requests must match;
    - ``params_from_state(state)`` — extract the params from a raw loaded
      checkpoint state dict (used again at every hot swap);
    - ``device`` — where the forward runs.
    """

    name: str
    bind: Callable[[Params], Forward]
    params: Params
    obs_spec: ObsSpec
    params_from_state: Callable[[Dict[str, Any]], Params]
    device: torch.device


class ModelVersion(NamedTuple):
    step: int
    path: str
    params: Params
    # one a replica slot; None for a standby slot not captured yet
    ladders: Tuple[Optional["CompiledLadder"], ...]


def stack_obs(obs_spec: ObsSpec, obs_list: Sequence[Any], batch: int, out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """Stack per-request observations into one batch of size ``batch``
    (zero-padding past ``len(obs_list)``), coercing each to the spec dtype;
    into ``out``'s arrays when given (a rung's pinned staging)."""
    if out is None:
        out = {k: np.zeros((batch, *shape), dtype=dtype) for k, (shape, dtype) in obs_spec.items()}
    n = len(obs_list)
    for k, (shape, dtype) in obs_spec.items():
        dst = out[k]
        for i, obs in enumerate(obs_list):
            dst[i] = np.asarray(obs[k], dtype=dtype)
        dst[n:] = 0
    return out


class _Rung:
    """One batch size of a ladder: pinned host staging, and on the card the
    static device inputs, the captured forward and a pinned output."""

    def __init__(self, forward: Forward, obs_spec: ObsSpec, batch: int, device: torch.device, stream: Optional[Any]) -> None:
        self.obs_spec = obs_spec
        self.batch = batch
        self.forward = forward
        self.stream = stream
        cuda = device.type == "cuda"
        self.host = {
            k: torch.zeros((batch, *shape), dtype=torch.from_numpy(np.zeros(0, dtype)).dtype, pin_memory=cuda)
            for k, (shape, dtype) in obs_spec.items()
        }
        self.host_np = {k: t.numpy() for k, t in self.host.items()}
        self.step: Optional[CapturedStep] = None
        # the capture's seconds by part (``CapturedStep.capture_parts``; the
        # warm-up ran before it), the first replay's in ``other_s``
        self.capture_parts: Dict[str, float] = {}
        if cuda:
            inputs = {k: t.to(device) for k, t in self.host.items()}

            def step(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
                with torch.no_grad():
                    return forward(obs)

            # small graphs captured in a serving pause: no cache release
            self.step = CapturedStep(step, inputs, (), release_caches=False)
            out = self.step.warm()
            self.host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

    def capture(self) -> None:
        """Capture the rung's graph and replay it once (on the card; the
        CPU runs the forward eagerly and has nothing to capture)."""
        if self.step is None:
            return
        t0 = time.perf_counter()
        self.step.capture()
        self.step.replay()
        torch.cuda.current_stream(self.step.device).synchronize()
        self.capture_parts = {k: v for k, v in self.step.capture_parts.items() if k != "warmup_s"}
        self.capture_parts["other_s"] = time.perf_counter() - t0 - sum(self.capture_parts.values())

    def run(self, obs_list: Sequence[Any]) -> np.ndarray:
        """The rung's ``[batch, ...]`` actions (a copy) for ``obs_list``."""
        stack_obs(self.obs_spec, obs_list, self.batch, out=self.host_np)
        return self.run_staged()

    def run_staged(self) -> np.ndarray:
        """The rung's ``[batch, ...]`` actions (a copy) for what is staged
        in ``host_np`` already (the slot pool's assembly writes there)."""
        if self.step is None:
            with torch.inference_mode():
                return self.forward(self.host).numpy().copy()
        with torch.cuda.stream(self.stream):
            for k, t in self.step.inputs.items():
                t.copy_(self.host[k], non_blocking=True)
            self.host_out.copy_(self.step.replay(), non_blocking=True)
        self.stream.synchronize()
        return self.host_out.numpy().copy()

    def eager(self, obs_list: Sequence[Any]) -> np.ndarray:
        """The same batch through the forward run eagerly on the rung's
        device (what a replay is held against)."""
        batch = stack_obs(self.obs_spec, obs_list, self.batch)
        device = self.step.device if self.step is not None else torch.device("cpu")
        with torch.inference_mode():
            out = self.forward({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return out.cpu().numpy()


class CompiledLadder:
    """One CUDA graph a batch rung, over one version's weights, for one
    replica slot on ``device`` (default: the policy's). Construction builds
    each rung (its staging, its static inputs and the warm-up); on the card
    the graphs are captured by :meth:`capture`, before the ladder serves.
    Each rung's seconds, both together, are in ``compile_s``. Replays run
    on the slot's ``stream``. On the CPU a rung runs the eager forward."""

    def __init__(
        self,
        policy: ServedPolicy,
        ladder: Sequence[int],
        forward: Forward,
        stream: Optional[Any] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        self.policy = policy
        self.device = torch.device(device) if device is not None else policy.device
        self.rungs = sorted({int(b) for b in ladder})
        self.compile_s: Dict[int, float] = {}
        self._rungs: Dict[int, _Rung] = {}
        for b in self.rungs:
            t0 = time.perf_counter()
            self._rungs[b] = _Rung(forward, policy.obs_spec, b, self.device, stream)
            self.compile_s[b] = time.perf_counter() - t0

    def capture(self) -> "CompiledLadder":
        """Capture every rung's graph (see :class:`ModelStore` for when);
        returns the ladder."""
        for b, rung in self._rungs.items():
            t0 = time.perf_counter()
            rung.capture()
            self.compile_s[b] += time.perf_counter() - t0
        return self

    @property
    def capture_parts(self) -> Dict[str, float]:
        """The rungs' capture seconds by part, summed (none on the CPU, or
        before :meth:`capture`)."""
        parts: Dict[str, float] = {}
        for rung in self._rungs.values():
            for k, v in rung.capture_parts.items():
                parts[k] = parts.get(k, 0.0) + v
        return parts

    @property
    def max_batch(self) -> int:
        return self.rungs[-1]

    def rung_for(self, n: int) -> int:
        for b in self.rungs:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds top ladder rung {self.max_batch}")

    def rung(self, batch: int) -> _Rung:
        return self._rungs[batch]

    def run(self, obs_list: Sequence[Any]) -> List[np.ndarray]:
        """Run ``len(obs_list)`` requests through the nearest rung; returns
        one host-side action array per request (padding sliced away)."""
        n = len(obs_list)
        out = self._rungs[self.rung_for(n)].run(obs_list)
        return [out[i] for i in range(n)]


class ServingGate:
    """Replicas serve under the gate together (:meth:`shared`); a capture,
    a version flip or a rollback holds it alone (:meth:`exclusive`), after
    the batches in flight and before the next ones. A waiting exclusive
    holder goes first, so traffic cannot starve a swap; it gives up with
    ``TimeoutError`` after ``timeout_s``. Pauses taken one after another (a
    fleet's swap captures one slot at a time) each let the replicas the
    previous pause held back in first, so serving runs between them. A
    replica waiting to enter calls ``beat`` every ``BEAT_S`` (paused, not
    hung)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._waiting = 0
        self._held_back = 0  # replicas waiting out a pause

    @contextmanager
    def shared(self, beat: Optional[Callable[[], None]] = None) -> Iterator[None]:
        with self._cond:
            if self._writer or self._waiting:
                self._held_back += 1
                try:
                    while self._writer or self._waiting:
                        self._cond.wait(BEAT_S)
                        if beat is not None:
                            beat()
                finally:
                    self._held_back -= 1
                    self._cond.notify_all()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self, timeout_s: float = PAUSE_TIMEOUT_S) -> Iterator[None]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            # the replicas the last pause held back enter before this one
            while self._held_back and not self._writer:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"{self._held_back} paused replicas did not resume within {timeout_s:.1f}s")
                self._cond.wait(remaining)
            self._waiting += 1
            try:
                while self._writer or self._readers:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"serving did not pause within {timeout_s:.1f}s ({self._readers} batches in flight)")
                    self._cond.wait(remaining)
                self._writer = True
            finally:
                self._waiting -= 1
                self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class ModelStore:
    """The atomically-swappable current model version, with one graph set a
    replica slot for it.

    ``slot_devices`` places each slot (default: every slot on the policy's
    device); the slots in ``standby`` are not captured until
    :meth:`capture_slot`. ``on_event(kind, info)`` (kinds ``swap`` /
    ``swap_rejected`` / ``rollback`` / ``slot_capture``) is the stats hook;
    exceptions from it are swallowed.
    """

    def __init__(
        self,
        policy: ServedPolicy,
        ladder: Sequence[int],
        *,
        step: int,
        path: str,
        slots: int = 1,
        slot_devices: Optional[Sequence[Any]] = None,
        standby: Sequence[int] = (),
        fault_schedule: Optional[ServeFaultSchedule] = None,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    ) -> None:
        self.policy = policy
        self.rungs = sorted({int(b) for b in ladder})
        self._faults = fault_schedule
        self._on_event = on_event
        self.gate = ServingGate()
        # serialises swaps, rollbacks and slot captures: one capturing thread
        # at a time
        self._swap_lock = threading.Lock()
        devices = [policy.device] * int(slots) if slot_devices is None else list(slot_devices)
        self.slot_devices = [torch.device(d) for d in devices]
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self.slot_devices]
        # one owner a slot: its graphs' static buffers and pinned staging
        self._slot_locks = [threading.Lock() for _ in self.slot_devices]
        self._captured = [i not in set(standby) for i in range(len(self.slot_devices))]
        self._current = self._build_version(int(step), str(path), policy.params)
        self._previous: Optional[ModelVersion] = None
        self.warmup_s = {b: sum(lad.compile_s[b] for lad in self._current.ladders if lad is not None) for b in self.rungs}
        self.swap_attempts = 0
        self.swaps = 0
        self.swap_rejects = 0
        self.rollbacks = 0

    def _ladder(self, slot: int, params: Params, forwards: Dict[torch.device, Forward]) -> "CompiledLadder":
        """``slot``'s graph set over ``params``, built and not captured:
        bound once a device within a version, on a copy of the params where
        the slot's device is not theirs (a CPU-spill slot). A failed
        placement or build raises."""
        device = self.slot_devices[slot]
        if device not in forwards:
            placed = params if device == self.policy.device else {k: v.to(device) for k, v in params.items()}
            forwards[device] = self.policy.bind(placed)
        return CompiledLadder(self.policy, self.rungs, forwards[device], self._streams[slot], device)

    def _captured_ladder(self, slot: int, ladder: "CompiledLadder", pauses: Optional[List[Dict[str, Any]]]) -> "CompiledLadder":
        """``ladder`` captured; while replicas serve (``pauses`` given)
        under the gate held alone, the pause appended (:func:`_pause`)."""
        t0 = time.perf_counter()
        with self.gate.exclusive() if pauses is not None else nullcontext():
            t1 = time.perf_counter()
            # the collector stays off through the captures; no full
            # collection first, which would lengthen the pause
            with collector_paused(collect=False):
                ladder.capture()
            t2 = time.perf_counter()
        if pauses is not None:
            pauses.append(_pause(slot, t0, t1, t2, ladder))
        return ladder

    def _build_version(self, step: int, path: str, params: Params, pauses: Optional[List[Dict[str, Any]]] = None) -> ModelVersion:
        """A version over ``params`` with a graph set for each captured slot.
        Each slot's set is built (bound, staged, warmed up) while replicas
        serve, then captured; while replicas serve (``pauses`` given), each
        capture holds the gate alone, one slot at a time: serving resumes
        between slots, so no request waits out more than one slot's
        captures."""
        forwards: Dict[torch.device, Forward] = {}
        ladders: List[Optional[CompiledLadder]] = []
        for i, captured in enumerate(self._captured):
            ladders.append(self._captured_ladder(i, self._ladder(i, params, forwards), pauses) if captured else None)
        return ModelVersion(step, path, params, tuple(ladders))

    def has_graphs(self, slot: int) -> bool:
        return self._captured[slot]

    def capture_slot(self, slot: int) -> Dict[str, Any]:
        """Capture standby ``slot``'s graph set for the serving version (and
        the one a rollback would restore) before it takes traffic. Captures
        run while nothing serves (the gate held alone, once a version), so
        the pauses are counted: ``capture_s`` (their captures in all),
        ``pauses_s`` and ``pause_s`` (the longest), also in the
        ``slot_capture`` event. A failed capture raises and leaves the slot
        on standby."""
        with self._swap_lock:
            if self._captured[slot]:
                return {"capture_s": 0.0, "pause_s": 0.0, "pauses_s": [], "pause_parts": []}
            pauses: List[Dict[str, Any]] = []
            for which in ("_current", "_previous"):
                version = getattr(self, which)
                if version is None or version.ladders[slot] is not None:
                    continue
                ladder = self._captured_ladder(slot, self._ladder(slot, version.params, {}), pauses)
                ladders = list(version.ladders)
                ladders[slot] = ladder
                # the version is replaced whole (a reference write): a
                # replica reads ``_current`` once a batch
                setattr(self, which, version._replace(ladders=tuple(ladders)))
            self._captured[slot] = True
            pauses_s = [p["pause_s"] for p in pauses]
            info = {"capture_s": sum(p["capture_s"] for p in pauses), "pause_s": max(pauses_s), "pauses_s": pauses_s, "pause_parts": pauses}
        self._emit("slot_capture", {"replica": slot, **info})
        return info

    # ---------------------------------------------------------------- serving
    @property
    def current(self) -> ModelVersion:
        return self._current  # reference read is atomic; swaps replace wholesale

    def infer(
        self, obs_list: Sequence[Any], slot: int = 0, beat: Optional[Callable[[], None]] = None
    ) -> Tuple[List[np.ndarray], int]:
        """Serve ``obs_list`` on ``slot``'s graphs of the current version;
        returns the actions and the step of the version that computed them.
        ``beat`` is called while a flip holds the gate."""
        with self._slot_locks[slot], self.gate.shared(beat):
            version = self._current
            try:
                return version.ladders[slot].run(obs_list), version.step
            finally:
                del version  # no reference outlives the gate (see the module doc)

    def infer_staged(
        self,
        slot: int,
        n: int,
        stage: Callable[[Dict[str, np.ndarray], int], Any],
        beat: Optional[Callable[[], None]] = None,
    ) -> Tuple[List[np.ndarray], int, float]:
        """Serve ``n`` requests on ``slot``'s graphs of the current version,
        ``stage(host, rung)`` writing their observations into the chosen
        rung's host staging (``host``: key -> ``[rung, ...]`` array, the
        pinned buffers the rung's graph copies from). Returns the ``n``
        actions, the step of the version that computed them and the
        monotonic time at which staging ended."""
        with self._slot_locks[slot], self.gate.shared(beat):
            version = self._current
            try:
                ladder = version.ladders[slot]
                if ladder is None:
                    raise RuntimeError(f"replica slot {slot} has no graphs: it was never captured")
                rung = ladder.rung(ladder.rung_for(n))
                stage(rung.host_np, rung.batch)
                t_staged = time.monotonic()
                out = rung.run_staged()
                return [out[i] for i in range(n)], version.step, t_staged
            finally:
                del version  # no reference outlives the gate (see the module doc)

    def slot_busy(self, slot: int) -> bool:
        """Whether a thread is inside ``slot``'s graphs (a replica abandoned
        as hung may be: its slot takes no new replica until it leaves)."""
        return self._slot_locks[slot].locked()

    # ------------------------------------------------------------------- swap
    def maybe_swap_newest(self, ckpt_dir: str) -> Optional[ModelVersion]:
        """Promote the newest committed checkpoint in ``ckpt_dir`` if it is
        strictly newer than the serving one. Returns the new version on
        promotion, ``None`` otherwise (including rejections, which are
        recorded, not raised — the watcher must keep serving)."""
        fresh = [c for c in committed_checkpoints(ckpt_dir) if c.step > self._current.step]
        if not fresh:
            return None
        ok, _ = self.try_swap(fresh[-1])
        return self._current if ok else None

    def request_swap(self, candidate: CommittedCheckpoint) -> ModelVersion:
        """Explicit-swap API: promote or raise :class:`SwapRejected`."""
        ok, reason = self.try_swap(candidate)
        if not ok:
            raise SwapRejected(f"checkpoint {candidate.path} rejected: {reason}")
        return self._current

    def try_swap(self, candidate: CommittedCheckpoint) -> Tuple[bool, str]:
        """Validate-then-promote ``candidate``. Never raises on a bad
        checkpoint — returns ``(False, reason)`` and keeps serving."""
        with self._swap_lock:
            self.swap_attempts += 1
            attempt = self.swap_attempts
            try:
                state = load_checkpoint(candidate.path)
            except Exception as err:
                return self._reject(candidate, f"load failed: {err!r}")

            man = candidate.manifest
            if man.get("tree_digest") is not None:
                leaf_count, digest = tree_digest(state)
                if (leaf_count, digest) != (man.get("leaf_count"), man.get("tree_digest")):
                    return self._reject(
                        candidate,
                        f"state digest ({leaf_count}, {digest}) != manifest "
                        f"({man.get('leaf_count')}, {man.get('tree_digest')}) — torn or foreign checkpoint",
                    )

            try:
                params = self.policy.params_from_state(state)
            except Exception as err:
                return self._reject(candidate, f"params extraction failed: {err!r}")
            del state

            mismatch = _structure_mismatch(self._current.params, params)
            if mismatch:
                return self._reject(candidate, f"params structure changed: {mismatch}")

            if self._faults is not None and self._faults.poison_swap(attempt):
                params = _poison(params)

            if not bool(all_finite(list(params.values()))):
                return self._reject(candidate, "non-finite weights (poisoned checkpoint)")

            pauses: List[Dict[str, Any]] = []
            try:
                version = self._build_version(candidate.step, candidate.path, params, pauses)
            except Exception as err:
                return self._reject(candidate, f"graph capture failed: {err!r}")
            try:
                smoke = next(lad for lad in version.ladders if lad is not None).run([_zero_obs(self.policy.obs_spec)])
                if not host_all_finite(smoke):
                    return self._reject(candidate, "smoke inference produced non-finite outputs")
            except Exception as err:
                return self._reject(candidate, f"smoke inference failed: {err!r}")

            t0 = time.perf_counter()
            with self.gate.exclusive():
                # the version two swaps back is freed here, where no replay runs
                self._previous, self._current = self._current, version
                self.swaps += 1
            pauses_s = [p["pause_s"] for p in pauses] + [time.perf_counter() - t0]
            del version
            trace_event("model_swap", ckpt_step=candidate.step, attempt=attempt)
            self._emit(
                "swap",
                {
                    "step": candidate.step,
                    "path": candidate.path,
                    "attempt": attempt,
                    "capture_s": sum(p["capture_s"] for p in pauses),
                    "pause_s": max(pauses_s),  # the longest that serving stood still
                    "pauses_s": pauses_s,  # one a captured slot, then the flip
                    "pause_parts": pauses,  # each slot's pause by part
                },
            )
            return True, "promoted"

    def rollback(self) -> Optional[ModelVersion]:
        """Restore the previous version (post-swap escape hatch). Returns the
        now-serving version, or ``None`` when there is nothing to roll back."""
        with self._swap_lock:
            if self._previous is None:
                return None
            with self.gate.exclusive():
                bad, self._current, self._previous = self._current, self._previous, None
                bad_step = bad.step
                del bad
            self.rollbacks += 1
        self._emit("rollback", {"from_step": bad_step, "to_step": self._current.step})
        return self._current

    # ------------------------------------------------------------------ misc
    def _reject(self, candidate: CommittedCheckpoint, reason: str) -> Tuple[bool, str]:
        self.swap_rejects += 1
        self._emit("swap_rejected", {"step": candidate.step, "path": candidate.path, "reason": reason})
        return False, reason

    def _emit(self, kind: str, info: Dict[str, Any]) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, info)
            except Exception:
                pass


def _pause(slot: int, t0: float, t1: float, t2: float, ladder: Optional["CompiledLadder"]) -> Dict[str, Any]:
    """One pause of serving for ``slot``'s graph set, begun at ``t0``
    (asking for the gate), the gate held from ``t1``, the set captured at
    ``t2``, released now: its seconds in all, waiting for the gate and
    capturing, and the capture's parts (``CompiledLadder.capture_parts``)."""
    parts = ladder.capture_parts if ladder is not None else {}
    return {"slot": slot, "pause_s": time.perf_counter() - t0, "gate_wait_s": t1 - t0, "capture_s": t2 - t1, "parts": parts}


def _structure_mismatch(current: Params, new: Params) -> Optional[str]:
    """Human-readable first difference between two param sets (names,
    shapes or dtypes), or ``None`` when the serving graphs' layout fits."""
    if set(current) != set(new):
        return f"parameter names differ ({sorted(set(current) ^ set(new))})"
    for name, a in current.items():
        b = new[name]
        if tuple(a.shape) != tuple(b.shape):
            return f"{name} shape {tuple(b.shape)} != serving {tuple(a.shape)}"
        if a.dtype != b.dtype:
            return f"{name} dtype {b.dtype} != serving {a.dtype}"
    return None


def _poison(params: Params) -> Params:
    """NaN-poison the first floating tensor (fault injection: a checkpoint
    whose weights were corrupted after commit)."""
    out = dict(params)
    for name, t in out.items():
        if t.is_floating_point():
            bad = t.clone()
            bad.view(-1)[0] = float("nan")
            out[name] = bad
            break
    return out


def _zero_obs(obs_spec: ObsSpec) -> Dict[str, np.ndarray]:
    return {k: np.zeros(shape, dtype=dtype) for k, (shape, dtype) in obs_spec.items()}

