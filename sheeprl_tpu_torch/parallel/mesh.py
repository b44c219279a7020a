"""The (data, model) mesh of ranks (port of the topology part of
``sheeprl_tpu/parallel/fabric.py:309-365``).

One process drives one rank. ``init_distributed`` joins the process group:
NCCL for ``cuda``, gloo for ``cpu``; a ``cuda`` group never falls back to
gloo or the CPU. ``make_mesh`` then lays the world out as ``data x model``
with ``init_device_mesh``, ranks in row-major order, so a rank's model
peers are the ``model`` ranks of its data row.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from sheeprl_tpu_torch.device import DeviceLike, resolve_device

AXES = ("data", "model")
# how long a collective waits for its peers before it fails
_TIMEOUT = timedelta(seconds=300)


def backend_for(device: DeviceLike = None) -> str:
    """``nccl`` for a CUDA device (raises where NCCL is missing), ``gloo``
    for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL and this PyTorch has none")
        return "nccl"
    return "gloo"


def init_distributed(device: DeviceLike, init_method: str, world_size: int, rank: int) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` through
    ``init_method`` (``file://...`` or ``tcp://host:port``). A CUDA rank
    takes card ``rank % device_count``. Returns this rank's device."""
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, timeout=_TIMEOUT)
    return dev


@dataclass(frozen=True)
class Mesh:
    """A ``data x model`` layout of the process group and this rank's place
    in it (the ``Fabric`` topology properties)."""

    device_mesh: "dist.device_mesh.DeviceMesh"

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.device_mesh.shape)

    @property
    def data_parallel_size(self) -> int:
        return self.shape[0]

    @property
    def model_parallel_size(self) -> int:
        return self.shape[1]

    @property
    def model_axis(self) -> Optional[str]:
        """``"model"``, or None when the model axis has size 1."""
        return "model" if self.model_parallel_size > 1 else None

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (data, model) coordinates."""
        return self.device_mesh.get_local_rank("data"), self.device_mesh.get_local_rank("model")

    @property
    def model_group(self) -> dist.ProcessGroup:
        return self.device_mesh.get_group("model")

    @property
    def data_group(self) -> dist.ProcessGroup:
        return self.device_mesh.get_group("data")


def make_mesh(data: int, model: int, device: DeviceLike = None) -> Mesh:
    """The ``data x model`` mesh of the initialised process group, whose
    world size must be ``data * model`` and whose backend must suit
    ``device``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    want = backend_for(dev)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: join the process group first (init_distributed or parallel.launch.run)")
    if dist.get_backend() != want:
        raise RuntimeError(f"make_mesh: a {dev.type} mesh needs the {want} backend, the group runs {dist.get_backend()}")
    if data * model != dist.get_world_size():
        raise ValueError(f"make_mesh: {data} x {model} ranks, but the world has {dist.get_world_size()}")
    return Mesh(init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES))
