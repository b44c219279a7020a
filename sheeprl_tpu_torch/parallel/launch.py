"""Run one function on N ranks, one process each (the port's counterpart of
``tests/conftest.py:53-100``, ``run_multi_process``).

``run(fn, nprocs, *args, device=None)`` starts ``nprocs`` processes with
the ``spawn`` method. ``device=None`` means the CUDA cards (NCCL, rank ``r``
on card ``r % device_count``) and raises without one; ``device="cpu"`` runs
gloo ranks on the host, as the tests do. Each joins the process group through a file store in a
fresh temporary directory (``init_method="file://..."``), so concurrent runs
never race for a port, then calls ``fn(rank, nprocs, *args)``. ``fn`` must be
importable by its module path in a fresh interpreter. ``run`` returns when
every rank has exited 0; as soon as one rank fails it raises with every
failed rank's traceback, and it raises ``TimeoutError`` when the run
outlasts ``timeout`` seconds. Either way it kills the ranks left running.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from sheeprl_tpu_torch.device import DeviceLike, resolve_device
from sheeprl_tpu_torch.parallel.mesh import backend_for, init_distributed

_POLL_S = 0.05


def _rank_main(fn: Callable[..., Any], rank: int, nprocs: int, device: str, workdir: str, args: tuple) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)  # nprocs ranks share the host's cores
        init_distributed(device, f"file://{os.path.join(workdir, 'store')}", nprocs, rank)
        fn(rank, nprocs, *args)
    except BaseException:
        # written while the group still stands: a peer that then fails on the
        # broken connection does so after this rank's cause is on disk
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    dist.destroy_process_group()


def run(fn: Callable[..., Any], nprocs: int, *args: Any, device: DeviceLike = None, timeout: float = 120.0) -> None:
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` spawned ranks."""
    dev = resolve_device(device)
    backend_for(dev)  # a cuda run without NCCL fails here, before any spawn
    device = dev.type
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="sheeprl_tpu_torch_launch_") as workdir:
        procs = [
            ctx.Process(target=_rank_main, args=(fn, rank, nprocs, device, workdir, args), daemon=True)
            for rank in range(nprocs)
        ]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(_failures(workdir, procs))
                if time.monotonic() > deadline:
                    late = [r for r, p in enumerate(procs) if p.exitcode is None]
                    raise TimeoutError(f"ranks {late} of {nprocs} still running after {timeout} s")
                time.sleep(_POLL_S)
            if any(p.exitcode != 0 for p in procs):
                raise RuntimeError(_failures(workdir, procs))
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()


def _failures(workdir: str, procs) -> str:
    """Every failed rank's traceback (a rank whose peer died first fails too,
    on the broken connection, so the first cause may be any of them)."""
    lines = []
    for rank, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"rank {rank} of {len(procs)} failed:\n{f.read()}")
        elif p.exitcode not in (None, 0):
            lines.append(f"rank {rank} of {len(procs)} failed with exit code {p.exitcode}, no traceback")
    return "\n".join(lines)
