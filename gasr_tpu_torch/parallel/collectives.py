"""The collectives of the tensor-parallel forward, as autograd Functions.

GSPMD writes these for JAX. Each rank computes its loss from replicated
activations, so the ranks' losses are one loss counted once, and the
backward of each collective follows from that:

  all_gather(x, group, dim)  forward: the ranks' x concatenated along
                             `dim`; backward: the cotangents reduced and
                             scattered (rank r keeps the sum over ranks of
                             slice r). The gathered tensor feeds this
                             rank's columns of the next product, so each
                             rank's cotangent is a partial one.
  all_reduce(x, group)       forward: the sum over ranks; backward: the
                             identity (what follows is replicated).
  copy_to_group(x, group)    forward: the identity; backward: the sum over
                             ranks (a replicated tensor feeding each rank's
                             share of the work).

A rank's share is a contiguous slice along `dim`, in group-rank order,
as `parallel/sharding.py` splits the params.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    # contiguous as x: a product then takes the operand in the layout the
    # single-device forward gives it (the same bits at one rank)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    g0 = g.movedim(dim, 0).contiguous()
    out = g0.new_empty((g0.shape[0] // n,) + tuple(g0.shape[1:]))
    dist.reduce_scatter_tensor(out, g0, group=group)
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    dim = dim % x.ndim
    return _AllGather.apply(x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)
