"""Rank bodies for tests/test_torch_sharded_gru.py.

Spawned ranks import this module by its path, so it imports no JAX: the JAX
side of each comparison runs in the pytest process. Inputs and outputs pass
through ``.npz`` files.
"""

import numpy as np
import torch
import torch.distributed as dist

from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
from sheeprl_tpu_torch.ops import fused_gru as tgru
from sheeprl_tpu_torch.parallel.mesh import make_mesh


def sharded_step(rank, world, data, model, in_path, out_dir):
    """Forward (kernel path and plain path) and the gradients of
    ``sum(h'**2)``, for fp32 and bf16 storage of the W2 slice, on this rank
    of a ``data x model`` gloo mesh. The replicated weights' gradients and
    the slices' are summed over the data axis here, as data parallelism
    would."""
    mesh = make_mesh(data, model, "cpu")
    di, mi = mesh.coords
    with np.load(in_path) as f:
        args = [f[f"a{i}"] for i in range(9)]
    shard = args[0].shape[0] // data
    rows = slice(di * shard, (di + 1) * shard)
    out = {
        "coords": np.array(mesh.coords),
        "sizes": np.array([mesh.data_parallel_size, mesh.model_parallel_size]),
        "model_axis": np.array(mesh.model_axis or ""),
    }
    tgru.reset_launch_count()
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        local = shard_recurrent(args, model, mi, dtype)
        local[0], local[1] = local[0][rows].contiguous(), local[1][rows].contiguous()
        # both values run proj_reference on CPU tensors; each is compared
        # with its own JAX side
        for use_pallas in (True, False):
            with torch.no_grad():
                out[f"{tag}_fwd_{int(use_pallas)}"] = tgru.sharded_recurrent_step(
                    *local, mesh=mesh, use_pallas=use_pallas
                ).numpy()
        leaves = [t.clone().requires_grad_(True) for t in local]
        tgru.sharded_recurrent_step(*leaves, mesh=mesh).square().sum().backward()
        for i, leaf in enumerate(leaves):
            g = leaf.grad.float()
            if i >= 2:
                dist.all_reduce(g, group=mesh.data_group)
                g = g.to(leaf.dtype).float()  # a bf16 slice's gradient is stored in bf16
            out[f"{tag}_grad{i}"] = g.numpy()
    out["proj_launches"] = np.array(tgru.proj_launch_count)
    if model > 1:
        # an indivisible hidden size (6 % model != 0) is refused before any collective
        bad = [torch.zeros(s) for s in ((2, 3), (2, 6), (3, 4), (4,), (4,), (4,), (10, 3), (3,), (3,))]
        try:
            tgru.sharded_recurrent_step(*bad, mesh=mesh)
            out["rejected"] = np.array("")
        except ValueError as e:
            out["rejected"] = np.array(str(e))
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def fail_on_rank_one(rank, world):
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    dist.barrier()


def hang(rank, world, seconds):
    import time

    time.sleep(seconds)
