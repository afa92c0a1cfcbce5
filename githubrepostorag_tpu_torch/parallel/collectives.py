"""Differentiable collectives over one mesh axis's process group.

The JAX package gets these from ``lax`` (``ppermute`` inside
``shard_map``) and from GSPMD (the Megatron all-reduces it inserts around
the column- and row-parallel matmuls).  Here they are written once, as
``torch.autograd.Function``s whose backward is the transpose of their
forward:

  ppermute          send along ``perm``; backward sends along its inverse
  copy_to_axis      identity; backward all-reduces the gradient
  reduce_from_axis  all-reduce; backward passes the gradient through
  gather_from_axis  all-gather along a dim; backward keeps this rank's slice

``torch.distributed.nn.functional.all_reduce`` is not ``reduce_from_axis``:
its backward all-reduces the gradient as well, which multiplies a
row-parallel output's gradient (already whole on every rank) by the axis
size.  A ``group`` of None (no world, ``parallel/mesh.py``) makes each of
them the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _send_recv(x: torch.Tensor, group, perm) -> torch.Tensor:
    """This rank's receive of the permutation ``perm`` (pairs of group
    indices, source to destination); a rank no pair sends to gets zeros,
    as under ``lax.ppermute``."""
    me = dist.get_group_rank(group, dist.get_rank())
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _send_recv(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _send_recv(grad, ctx.group, inverse), None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.n = group, dim, n
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        me = dist.get_group_rank(ctx.group, dist.get_rank())
        return grad.chunk(ctx.n, dim=ctx.dim)[me].contiguous(), None, None


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``lax.ppermute`` over ``group``: ``perm`` pairs (source, destination)
    of indices in the group."""
    return x if group is None else _PPermute.apply(x, group, perm)


def copy_to_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel matmul."""
    return x if group is None else _CopyToAxis.apply(x, group)


def reduce_from_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of a row-parallel matmul's partial outputs."""
    return x if group is None else _ReduceFromAxis.apply(x, group)


def gather_from_axis(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim`` (vocab-parallel logits)."""
    return x if group is None else _GatherFromAxis.apply(x, group, dim)


def all_reduce_sum(tensors: list[torch.Tensor], groups) -> None:
    """Sum ``tensors`` in place over each group of ``groups`` in turn (no
    autograd): one flat buffer a group, so a tree of gradients costs one
    collective per axis.  A group of None is skipped."""
    groups = [g for g in groups if g is not None]
    if not groups or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for g in groups:
        dist.all_reduce(flat, group=g)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
