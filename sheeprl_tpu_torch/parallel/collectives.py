"""Autograd-aware collectives over one process group (the collectives that
``shard_map`` gives ``sheeprl_tpu/ops/pallas_gru.py::sharded_recurrent_step``
implicitly: ``lax.psum`` at :417-418, ``lax.all_gather(..., tiled=True)`` at
:425, and the summed cotangents of its replicated inputs).

Every model rank of the step holds the same replicated output and computes
the same loss from it, and each rank's backward sees only its own columns.
So a tensor that every rank computes alike (a replicated input, a ``psum``)
collects its gradient by an all-reduce over the group, while the gathered
output hands each rank back only its own slice of the cotangent. PyTorch's
``torch.distributed.nn.functional.all_gather`` sums the cotangent over ranks
instead, which with a replicated loss makes each gradient group-size times
too large.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = dist.get_world_size(group)
        ctx.group_rank = dist.get_rank(group)
        ctx.width = x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.group_rank * ctx.width
        return grad[..., start : start + ctx.width].contiguous(), None


class _ToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def psum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Sum over the group; the cotangent is summed over the group too."""
    return _Psum.apply(x, group)


def all_gather_tiled(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the last axis in group-rank order;
    the backward keeps this rank's slice of the (replicated) cotangent."""
    return _AllGatherTiled.apply(x, group)


def to_model_region(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Identity on a replicated input; its gradient is the sum of every
    rank's contribution."""
    return _ToModelRegion.apply(x, group)
