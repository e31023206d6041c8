"""Collectives over one mesh axis, and the autograd functions that tensor
parallelism is built from (Megatron-LM's f and g operators).

JAX inserts these through GSPMD; here they are written where the layers
need them. Each takes a `mesh.Axis`; over an axis of size 1 (or None)
every function is the identity and issues nothing, so a (1, 1) mesh runs
the single-process arithmetic exactly. Nothing is caught: a collective
that the backend refuses raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis

# collectives issued since the last `reset_count` (identities over an axis
# of size 1 are not issued and do not count)
COUNT = {"all_reduce": 0, "all_gather": 0}


def reset_count():
    for k in COUNT:
        COUNT[k] = 0


def _active(axis) -> bool:
    return axis is not None and axis.size > 1


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum `t` in place over the axis."""
    if _active(axis):
        dist.all_reduce(t, group=axis.group)
        COUNT["all_reduce"] += 1
    return t


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t` (at least 1-D), in axis order."""
    if not _active(axis):
        return t[None]
    out = t.new_empty((axis.size * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=axis.group)
    COUNT["all_gather"] += 1
    return out.view(axis.size, *t.shape)


class _CopyTo(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim forward; this rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        return torch.cat(all_gather(x, axis).unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.axis.index * ctx.n, ctx.n), None


class _GatherShard(torch.autograd.Function):
    """A stored shard -> the full weight (`Sharding.unshard`); backward
    returns this rank's part of the full gradient (`Sharding.take`)."""

    @staticmethod
    def forward(ctx, shard, sharding):
        ctx.sharding = sharding
        return sharding.unshard(shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharding.take(g), None


def copy_to(x, axis: Axis):
    """The input of a column-parallel layer (or of a slice taken for a
    row-parallel one): its gradient is summed over the axis."""
    return _CopyTo.apply(x, axis) if _active(axis) else x


def reduce_from(x, axis: Axis):
    """The partial output of a row-parallel layer, summed over the axis."""
    return _ReduceFrom.apply(x, axis) if _active(axis) else x


def gather_last(x, axis: Axis):
    """A column-parallel output, gathered along its last dim."""
    return _GatherLast.apply(x, axis) if _active(axis) else x


def gather_shard(shard, sharding):
    """The full weight from this rank's stored shard."""
    return _GatherShard.apply(shard, sharding)
