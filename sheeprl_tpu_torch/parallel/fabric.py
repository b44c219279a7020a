"""A one-device ``Fabric`` (port of the single-process part of
``sheeprl_tpu/parallel/fabric.py``): what the composed ``fabric`` node
instantiates, and what the registered entry points take first.

It maps ``accelerator`` to a device (``auto``, ``gpu`` and ``cuda`` give the
CUDA card and raise without one; only ``cpu`` gives the CPU: there is no CPU
fallback), ``precision`` to :class:`~sheeprl_tpu_torch.device.Precision`,
keeps the instantiated ``callbacks`` (the port's ``CheckpointCallback``) and
carries the run's ``logger``. More than one device or node raises
``NotImplementedError``: data parallelism is queued in ``ROADMAP.md``.

It also places the player and the update (JAX :547-640, :832-940):
``resolve_player_device`` and ``resolve_train_device`` read
``algo.player_device`` and ``algo.train_device`` with the JAX rules, the
``auto`` case through :func:`dispatch_roundtrip_seconds`, the round trip of
one tiny op on the card; :class:`HostPlayerParams` gives a player its own
copy of the modules it reads on its device, refreshed from the learner's as
one flat transfer per dtype (``sync_params``), or on a side stream that
lands at the next ``poll_params`` (``stream_params``, ``flush_params``).
"""

from __future__ import annotations

import copy
import time
from itertools import chain
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.device import Precision, resolve_device

ACCELERATORS = ("auto", "gpu", "cuda", "tpu", "cpu")


def accelerator_device(accelerator: str) -> torch.device:
    """``cpu`` -> the CPU; ``auto``, ``gpu``, ``cuda`` and ``tpu`` (the
    config tree's name for its accelerator: ``fabric/tpu.yaml``,
    ``exp=dreamer_v3_dmc_walker_walk``) -> the CUDA card (raises without
    one)."""
    acc = str(accelerator).lower()
    if acc not in ACCELERATORS:
        raise ValueError(f"unsupported accelerator {accelerator!r}; one of {ACCELERATORS}")
    return resolve_device("cpu" if acc == "cpu" else "cuda")


class Fabric:
    def __init__(
        self,
        devices: Any = 1,
        num_nodes: int = 1,
        accelerator: str = "auto",
        precision: str = "bf16-mixed",
        callbacks: Optional[Sequence[Any]] = None,
        mesh_axes: Optional[Sequence[str]] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        compilation_cache_dir: Optional[str] = None,
        aot_cache_dir: Optional[str] = None,
    ) -> None:
        if devices not in (1, "1", "auto") or int(num_nodes) != 1:
            raise NotImplementedError(
                f"fabric.devices={devices!r}, fabric.num_nodes={num_nodes!r}: the port runs one process on one "
                "device; data parallelism over several is queued in ROADMAP.md"
            )
        if list(mesh_axes or ["data"]) != ["data"] or (mesh_shape is not None and list(mesh_shape) != [1]):
            raise NotImplementedError(
                f"fabric.mesh_axes={mesh_axes!r}, fabric.mesh_shape={mesh_shape!r}: a mesh over several devices "
                "is not ported to the Fabric yet (queued in ROADMAP.md)"
            )
        if compilation_cache_dir or aot_cache_dir:
            raise NotImplementedError(
                "fabric.compilation_cache_dir and fabric.aot_cache_dir are XLA caches; the port captures CUDA "
                "graphs at run time and has no cache of them (queued in ROADMAP.md)"
            )
        self.accelerator = str(accelerator)
        self.device = accelerator_device(accelerator)
        self.precision = Precision(str(precision))
        self.callbacks = list(callbacks or [])
        self.logger: Any = None

    @classmethod
    def for_device(cls, device: Any, precision: str, callbacks: Optional[Sequence[Any]] = None) -> "Fabric":
        """The Fabric of a run on ``device`` (``None`` is the CUDA card)."""
        return cls(accelerator=resolve_device(device).type, precision=precision, callbacks=callbacks)


def fabric_from_config(fabric_cfg: Mapping[str, Any]) -> Fabric:
    """Instantiate the composed ``fabric`` node, its callbacks first."""
    from sheeprl_tpu_torch.config.compose import instantiate

    node = dict(fabric_cfg)
    callbacks = [instantiate(cb) for cb in node.pop("callbacks", None) or []]
    return instantiate({**node, "callbacks": callbacks})


# --------------------------------------------------------------------------- #
# Placement of the player and of the update (JAX :547-640)
# --------------------------------------------------------------------------- #

# a card whose tiny-op round trip is longer than this is remote-attached
_RTT_PROBE_THRESHOLD_S = 0.005
# params under which ``train_device: auto`` trains on the host of a remote card
_HOST_TRAIN_PARAM_BUDGET = 300_000
_rtt_cache: Dict[str, float] = {}


def tiny_op_roundtrip_seconds(device: Any = None) -> float:
    """Seconds of one tiny op on ``device`` (the card by default) with its
    result read back: the mean of 3 calls after a warm-up, measured anew on
    every call (the link-health probe of ``metric.telemetry.poll_rtt``)."""
    x = torch.zeros(1, device=resolve_device(device))
    (x + 1.0).cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        (x + 1.0).cpu()
    return (time.perf_counter() - t0) / 3


def dispatch_roundtrip_seconds(device: Any = None) -> float:
    """:func:`tiny_op_roundtrip_seconds`, measured once per device and
    process (the placement decisions' probe)."""
    key = str(resolve_device(device))
    if key not in _rtt_cache:
        _rtt_cache[key] = tiny_op_roundtrip_seconds(device)
    return _rtt_cache[key]


def resolve_player_device(spec: Optional[str] = "auto", device: Any = None) -> Optional[torch.device]:
    """The player's device for ``algo.player_device`` in a run on ``device``
    (the card by default); None is the run's device. ``accelerator`` (or
    None) plays on the run's device; ``cpu`` on the host; ``auto`` on the
    run's device unless its round trip shows a remote card (over 5 ms).
    On a run on the CPU, every spec is the run's device."""
    if spec in (None, "accelerator"):
        return None
    if spec not in ("cpu", "auto"):
        raise ValueError(f"unknown player device spec {spec!r}; use accelerator/cpu/auto")
    run = torch.device("cpu") if device is not None and torch.device(device).type == "cpu" else None
    if run is not None:
        return None
    if spec == "cpu":
        return torch.device("cpu")
    return torch.device("cpu") if dispatch_roundtrip_seconds(device) > _RTT_PROBE_THRESHOLD_S else None


def resolve_train_device(spec: Optional[str], module: Any, world_size: int, device: Any = None) -> Optional[torch.device]:
    """The update's device for ``algo.train_device`` in a run on ``device``;
    None is the run's device. ``accelerator``/``device`` (or None) train
    there; ``cpu`` on the host (one rank only); ``auto`` on the host only
    for one rank, a remote card (the round trip over 5 ms) and a model of
    at most ``_HOST_TRAIN_PARAM_BUDGET`` params (``module``: a module or a
    sequence of tensors)."""
    if spec not in (None, "accelerator", "device", "cpu", "auto"):
        raise ValueError(f"unknown train_device spec {spec!r} (accelerator | cpu | auto)")
    if spec in (None, "accelerator", "device"):
        return None
    if world_size > 1:
        if spec == "cpu":
            raise ValueError("algo.train_device=cpu requires a single-device run")
        return None
    if spec == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).type == "cpu":
        return None
    tensors = module.parameters() if isinstance(module, torch.nn.Module) else module
    n_params = sum(int(t.numel()) for t in tensors)
    if n_params <= _HOST_TRAIN_PARAM_BUDGET and dispatch_roundtrip_seconds(device) > _RTT_PROBE_THRESHOLD_S:
        return torch.device("cpu")
    return None


def _tensors(module: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    return [(n, t) for n, t in chain(module.named_parameters(), module.named_buffers()) if t is not None]


class ParamMirror:
    """A copy of ``source`` on ``device`` (``module``), refreshed from it:
    the tensors named under ``prefixes`` (all by default), one dtype at a
    time, packed into one flat tensor where they live, copied across in one
    transfer (pinned on the host) and unpacked on arrival. Tensors on one
    device are copied directly."""

    def __init__(self, source: torch.nn.Module, device: torch.device, prefixes: Optional[Sequence[str]] = None) -> None:
        self.source = source
        self.device = torch.device(device)
        with torch.no_grad():
            self.module = copy.deepcopy(source).to(self.device)
        keep = (lambda n: True) if prefixes is None else (lambda n: any(n.startswith(p) for p in prefixes))
        dst = dict(_tensors(self.module))
        pairs = [(t, dst[n]) for n, t in _tensors(source) if keep(n)]
        self.src_device = pairs[0][0].device if pairs else self.device
        self.direct = self.src_device == self.device
        self.groups: List[Tuple[List[torch.Tensor], List[torch.Tensor], Any, Any]] = []
        for dtype in dict.fromkeys(s.dtype for s, _ in pairs):
            src = [s for s, _ in pairs if s.dtype == dtype]
            dst_t = [d for s, d in pairs if s.dtype == dtype]
            n = sum(int(s.numel()) for s in src)
            flats = (None, None) if self.direct else (self._flat(n, dtype, self.src_device), self._flat(n, dtype, self.device))
            self.groups.append((src, dst_t, *flats))
        cuda = next((d for d in (self.src_device, self.device) if d.type == "cuda"), None)
        self.stream = torch.cuda.Stream(cuda) if cuda is not None and not self.direct else None
        self.event: Optional[Any] = None
        self.pending = False

    @staticmethod
    def _flat(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        if device.type == "cpu" and torch.cuda.is_available():
            return torch.empty(n, dtype=dtype, pin_memory=True)
        return torch.empty(n, dtype=dtype, device=device)

    @torch.no_grad()
    def start(self) -> None:
        """Start a refresh (landing any refresh still in flight first)."""
        if self.pending:
            self.land(block=True)
        if self.event is not None:
            # the last transfer read the staging buffers this one rewrites
            self.event.synchronize()
        if self.direct:
            for src, dst, _, _ in self.groups:
                torch._foreach_copy_(dst, src)
            return
        for src, _, src_flat, _ in self.groups:
            # packed where the learner's tensors live, after its work
            torch.cat([s.reshape(-1) for s in src], out=src_flat)
        if self.stream is None:
            for _, _, src_flat, dst_flat in self.groups:
                dst_flat.copy_(src_flat)
        else:
            if self.src_device.type == "cuda":
                self.stream.wait_stream(torch.cuda.current_stream(self.src_device))
            with torch.cuda.stream(self.stream):
                for _, _, src_flat, dst_flat in self.groups:
                    dst_flat.copy_(src_flat, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(self.stream)
        self.pending = True

    @torch.no_grad()
    def matches(self) -> bool:
        """Whether the copy equals the source bit for bit (after a landing)."""
        return all(torch.equal(s.to(self.device), d) for src, dst, _, _ in self.groups for s, d in zip(src, dst))

    @torch.no_grad()
    def land(self, block: bool = False) -> bool:
        """Unpack a finished transfer into ``module``; with ``block``, wait
        for it. Returns whether nothing is left in flight."""
        if not self.pending:
            return True
        if self.event is not None:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).wait_event(self.event)
            elif block:
                self.event.synchronize()
            elif not self.event.query():
                return False
        for _, dst, _, dst_flat in self.groups:
            torch._foreach_copy_(dst, [v.view_as(d) for v, d in zip(dst_flat.split([d.numel() for d in dst]), dst)])
        self.pending = False
        return True


class HostPlayerParams:
    """Mixin of the players (JAX ``HostPlayerParams``, :832-940): once
    :func:`place_player` gave a player a device other than its learner's
    (or a snapshot on the same one), each module assigned to an attribute
    named in ``_placed_attrs`` is replaced by its :class:`ParamMirror` on
    the player's device, synced at the assignment (so a switch of actors
    stays synchronous); ``_placed_prefixes`` names, by attribute, the
    tensors the player reads. ``sync_params`` refreshes every mirror now,
    ``stream_params`` starts the refresh on a side stream, which
    ``poll_params`` lands once it arrived (the players poll on each action)
    and ``flush_params`` lands now. Without a placement, each call does
    nothing and the player reads the learner's modules."""

    _placed_attrs: Tuple[str, ...] = ()
    _placed_prefixes: Dict[str, Tuple[str, ...]] = {}

    def __setattr__(self, name: str, value: Any) -> None:
        mirrors = self.__dict__.get("_mirrors")
        if mirrors is not None and name in self._placed_attrs and isinstance(value, torch.nn.Module):
            mirror = self._mirror_of(value, self._placed_prefixes.get(name))
            mirror.start()
            mirror.land(block=True)
            self.__dict__.setdefault("_bound", {})[name] = mirror
            value = mirror.module
        object.__setattr__(self, name, value)

    def _mirror_of(self, source: torch.nn.Module, prefixes: Optional[Sequence[str]]) -> ParamMirror:
        mirrors = self.__dict__["_mirrors"]
        if id(source) not in mirrors:
            mirrors[id(source)] = ParamMirror(source, self.__dict__["_placement"], prefixes)
        return mirrors[id(source)]

    def _bound_mirrors(self) -> List[ParamMirror]:
        return list(self.__dict__.get("_bound", {}).values())

    @property
    def placed(self) -> bool:
        """Whether the player acts on mirrors of the learner's modules."""
        return self.__dict__.get("_mirrors") is not None

    def sync_params(self) -> None:
        for m in self._bound_mirrors():
            m.start()
            m.land(block=True)

    def stream_params(self) -> None:
        for m in self._bound_mirrors():
            m.start()

    def poll_params(self) -> None:
        for m in self._bound_mirrors():
            m.land(block=False)

    def flush_params(self) -> None:
        for m in self._bound_mirrors():
            m.land(block=True)

    def params_match(self) -> bool:
        """Whether every copy the player acts on equals its source."""
        return all(m.matches() for m in self._bound_mirrors())


def place_player(player: Any, device: Optional[torch.device], snapshot: bool = False) -> Any:
    """Put ``player`` on ``device`` (None: its learner's): mirrors of its
    placed modules there, its ``device`` set to it. Without a device of its
    own and without ``snapshot`` (a copy on the learner's device, which the
    overlapped PPO loop acts on while an update writes the learner's), the
    player keeps reading the learner's modules."""
    first = next(iter(player._placed_attrs))
    learner = next(getattr(player, first).parameters()).device
    target = learner if device is None else torch.device(device)
    if target == learner and not snapshot:
        return player
    object.__setattr__(player, "_placement", target)
    object.__setattr__(player, "_mirrors", {})
    for name in player._placed_attrs:
        setattr(player, name, getattr(player, name))
    object.__setattr__(player, "device", target)
    return player
