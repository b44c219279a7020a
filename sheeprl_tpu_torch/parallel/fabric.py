"""A one-device ``Fabric`` (port of the single-process part of
``sheeprl_tpu/parallel/fabric.py``): what the composed ``fabric`` node
instantiates, and what the registered entry points take first.

It maps ``accelerator`` to a device (``auto``, ``gpu`` and ``cuda`` give the
CUDA card and raise without one; only ``cpu`` gives the CPU: there is no CPU
fallback), ``precision`` to :class:`~sheeprl_tpu_torch.device.Precision`,
keeps the instantiated ``callbacks`` (the port's ``CheckpointCallback``) and
carries the run's ``logger``. More than one device or node raises
``NotImplementedError``: data parallelism is queued in ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

from sheeprl_tpu_torch.device import Precision, resolve_device

ACCELERATORS = ("auto", "gpu", "cuda", "cpu")


def accelerator_device(accelerator: str) -> torch.device:
    """``cpu`` -> the CPU; ``auto``, ``gpu`` and ``cuda`` -> the CUDA card
    (raises without one)."""
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
