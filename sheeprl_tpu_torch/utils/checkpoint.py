"""Checkpoint serialization (port of ``sheeprl_tpu/utils/checkpoint.py``:
the pickle backend of ``save_checkpoint`` and ``load_checkpoint``,
``select_buffer`` and ``elastic_per_rank_batch_size``).

A checkpoint is one pickle of numpy trees in plain containers, written to a
temporary file and renamed into place; when a manifest is given it lands
after the payload as the commit marker (``resilience.manifest``). The orbax
backend is not ported: ``backend="orbax"`` raises.

Loading goes through an unpickler with an allow-list, so that a checkpoint
of the JAX package loads without JAX: its optimizer states are optax
``NamedTuple`` records (``_to_host`` there converts only the leaves), and
unpickling them by default would import optax and, with it, JAX. Here:

- numpy's array and dtype reconstructors, its random generators' and a few
  builtins are allowed as they are;
- optax's state classes become the stand-in records below, which keep their
  fields (``ScaleByAdamState(count, mu, nu)``, ``ScaleByRmsState(nu)``,
  ``ScaleByRStdDevState(mu, nu)``, ``TraceState(trace)``, ``EmptyState()``);
- flax's ``FrozenDict`` becomes ``dict``;
- the port's own stand-ins and replay buffers (the host buffers and the
  device ring, both pickled as host arrays) are allowed;
- the JAX package's replay buffers (``ReplayBuffer``,
  ``SequentialReplayBuffer``, ``EnvIndependentReplayBuffer``, the device
  ring) and its ``MemmapArray`` load as the port's classes of the same
  name, whose pickled state has the same fields: the host buffers' arrays
  and cursors, the ring's host arrays and cursors, a numpy generator each.
  A JAX memmapped buffer pickles only its files' names, so it loads while
  those files exist and raises ``FileNotFoundError`` once they are gone;
- any other class raises ``pickle.UnpicklingError`` with its dotted name.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, List, NamedTuple, Optional, Union


class EmptyState(NamedTuple):
    """optax ``EmptyState`` (also its clip and learning-rate states)."""


class ScaleByAdamState(NamedTuple):
    """optax ``ScaleByAdamState``: Adam's step count and moments."""

    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """optax ``ScaleByScheduleState``: a learning-rate schedule's count."""

    count: Any


class ScaleByRmsState(NamedTuple):
    """optax ``ScaleByRmsState``: RMSProp's second moment."""

    nu: Any


class ScaleByRStdDevState(NamedTuple):
    """optax ``ScaleByRStdDevState``: centered RMSProp's two moments."""

    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """optax ``TraceState``: a momentum trace."""

    trace: Any


# the optax state classes of the optimizers the port has (Adam and RMSProp
# behind global-norm clipping, with a scheduled learning rate and RMSProp's
# momentum trace), by name: their module paths vary across optax versions.
# Another optimizer's state raises until that optimizer is ported.
OPTAX_STAND_INS = {
    cls.__name__: cls
    for cls in (EmptyState, ScaleByAdamState, ScaleByScheduleState, ScaleByRmsState, ScaleByRStdDevState, TraceState)
}

_NUMPY_MODULES = frozenset(
    ("numpy", "numpy.core.multiarray", "numpy._core.multiarray", "numpy.core.numeric", "numpy._core.numeric")
)
_NUMPY_NAMES = frozenset(("_reconstruct", "scalar", "_frombuffer", "dtype", "ndarray"))
_NUMPY_RANDOM = frozenset(
    (
        "__generator_ctor",
        "__bit_generator_ctor",
        "__randomstate_ctor",
        "__pyx_unpickle_SeedSequence",
        "SeedSequence",
        "PCG64",
        "PCG64DXSM",
        "MT19937",
        "Philox",
        "SFC64",
    )
)
_BUILTINS = frozenset(
    ("set", "frozenset", "complex", "slice", "range", "bytearray", "tuple", "list", "dict", "int", "float", "bool", "str")
)
# the JAX package's classes that load as the port's (module, name)
_JAX_CLASSES = {
    ("sheeprl_tpu.data.buffers", "ReplayBuffer"): ("sheeprl_tpu_torch.data.buffers", "ReplayBuffer"),
    ("sheeprl_tpu.data.buffers", "SequentialReplayBuffer"): ("sheeprl_tpu_torch.data.buffers", "SequentialReplayBuffer"),
    ("sheeprl_tpu.data.buffers", "EnvIndependentReplayBuffer"): (
        "sheeprl_tpu_torch.data.buffers",
        "EnvIndependentReplayBuffer",
    ),
    ("sheeprl_tpu.data.device_buffer", "DeviceReplayBuffer"): ("sheeprl_tpu_torch.data.device_buffer", "DeviceReplayBuffer"),
    ("sheeprl_tpu.data.memmap", "MemmapArray"): ("sheeprl_tpu_torch.data.memmap", "MemmapArray"),
}
# a pickled buffer's memmap directory
_PATHS = frozenset(("PosixPath", "PurePosixPath", "WindowsPath", "PureWindowsPath"))
_PORT_CLASSES = {
    "sheeprl_tpu_torch.utils.checkpoint": frozenset(OPTAX_STAND_INS),
    "sheeprl_tpu_torch.data.buffers": frozenset(("ReplayBuffer", "SequentialReplayBuffer", "EnvIndependentReplayBuffer")),
    "sheeprl_tpu_torch.data.device_buffer": frozenset(("DeviceReplayBuffer",)),
    "sheeprl_tpu_torch.data.memmap": frozenset(("MemmapArray",)),
}


class CheckpointUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` whose ``find_class`` works from the allow-list
    of the module docstring."""

    def find_class(self, module: str, name: str) -> Any:
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or (
            module.startswith("numpy.random") and name in _NUMPY_RANDOM
        ):
            return super().find_class(module, name)
        if module.startswith("numpy.dtypes") and name.endswith("DType"):
            return super().find_class(module, name)
        if (module == "builtins" and name in _BUILTINS) or (module, name) in (
            ("collections", "OrderedDict"),
            ("_codecs", "encode"),
        ):
            return super().find_class(module, name)
        if module.split(".")[0] == "optax" and name in OPTAX_STAND_INS:
            return OPTAX_STAND_INS[name]
        if module.split(".")[0] == "flax" and name == "FrozenDict":
            return dict
        if name in _PORT_CLASSES.get(module, ()):
            return super().find_class(module, name)
        if (module, name) in _JAX_CLASSES:
            return super().find_class(*_JAX_CLASSES[(module, name)])
        if module in ("pathlib", "pathlib._local") and name in _PATHS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint refers to {module}.{name}, which is not on the allow-list")


def save_checkpoint(
    path: str,
    state: Dict[str, Any],
    backend: str = "pickle",
    manifest: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``state`` (numpy trees) to ``path`` atomically: the pickle is
    staged under a temporary name and renamed into place, then ``manifest``
    (when given) commits it."""
    if backend == "orbax":
        raise ValueError(
            "checkpoint.backend=orbax is not ported: the port writes the pickle layout only "
            "(orbax's array store needs JAX); use checkpoint.backend=pickle"
        )
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r} (the port writes 'pickle')")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if manifest is not None:
        from sheeprl_tpu_torch.resilience.manifest import write_manifest

        write_manifest(path, manifest)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a pickle checkpoint of the port or of the JAX package through
    :class:`CheckpointUnpickler`. A directory is an orbax checkpoint, which
    the port does not read."""
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is an orbax checkpoint directory; the port reads the pickle layout only")
    with open(path, "rb") as f:
        return CheckpointUnpickler(f).load()


def select_buffer(rb_state: Union[Any, List[Any]], process_index: int, num_processes: int) -> Any:
    """This process's replay buffer from a checkpoint: one per process in a
    list, or the buffer itself."""
    if isinstance(rb_state, list):
        if len(rb_state) == num_processes:
            return rb_state[process_index]
        if num_processes == 1:
            return rb_state[0]
        raise RuntimeError(
            f"checkpoint holds {len(rb_state)} replay buffers but {num_processes} processes are running"
        )
    return rb_state


def elastic_per_rank_batch_size(global_batch: int, world_size: int) -> int:
    """The checkpoint's global batch split over ``world_size`` data-parallel
    devices; raises where it does not divide (or divides to zero)."""
    if world_size <= 0 or global_batch % world_size != 0 or global_batch // world_size == 0:
        raise ValueError(
            f"cannot resume: the checkpoint's global batch size ({global_batch}) does not split "
            f"evenly over {world_size} data-parallel devices — resume on a mesh whose data axis "
            f"divides {global_batch}, or start a fresh run"
        )
    return global_batch // world_size
