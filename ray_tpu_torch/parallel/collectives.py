"""Differentiable collectives over one mesh axis's group — the PyTorch port
of ``ray_tpu/parallel/collectives.py``.

The JAX functions run inside ``shard_map`` and compile to XLA collectives;
these run on every rank of a ``DeviceMesh`` (``parallel/mesh.py``) over
the process group of ``axis`` (a name, or a tuple of names taken as one
axis, the first major), through ``torch.distributed`` (NCCL on the card,
gloo on the CPU). Each is an autograd function whose backward is its
transpose, as JAX differentiates them: all-gather and reduce-scatter
transpose into each other, a sum into a sum, a shift into the opposite
shift. So the gradient a rank receives is its share of the gradient of
the sum of every rank's objective. Over an axis of one rank each is the
identity. ``max`` and ``min`` carry no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_group

# the names torch 2.13 gives the tensor forms (older releases: *_tensor)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce(x, group, op="sum"):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op],
                    group=group)
    if op == "mean":
        out /= dist.get_world_size(group)
    return out


def _gather0(x, group):
    """All-gather along dim 0 (tiled: [n * s, ...])."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _gather_into(out, x, group=group)
    return out


def _scatter0(x, group):
    """Reduce-scatter (sum) along dim 0: [n * s, ...] -> [s, ...]."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim of {x.shape[0]} not divisible over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _scatter_into(out, x, group=group)
    return out


def gather_dim(x, group, dim):
    return _gather0(x.movedim(dim, 0), group).movedim(0, dim)


def scatter_dim(x, group, dim):
    return _scatter0(x.movedim(dim, 0), group).movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op not in ("sum", "mean"):
            raise RuntimeError(f"allreduce op {ctx.op!r} has no gradient")
        return _all_reduce(g, ctx.group, ctx.op), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root):
        ctx.group, ctx.root = group, root
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, root),
                       group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group)
        if dist.get_group_rank(ctx.group, dist.get_rank()) != ctx.root:
            total.zero_()
        return total, None, None


def _all_to_all(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} not "
                         f"divisible over {n} ranks")
    send = torch.stack(x.chunk(n, split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, \
            None


def _shift(x, group, shift):
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def allreduce(x, mesh, axis_name, op: str = "sum"):
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"unknown op {op!r}")
    group = axis_group(mesh, axis_name)
    return x if group is None else _AllReduce.apply(x, group, op)


def allgather(x, mesh, axis_name, axis: int = 0, tiled: bool = True):
    """Tiled: shards concatenated along ``axis``; untiled: stacked on a
    new ``axis``."""
    group = axis_group(mesh, axis_name)
    if not tiled:
        x = x.unsqueeze(axis)
    return x if group is None else _AllGather.apply(x, group, axis)


def reducescatter(x, mesh, axis_name, axis: int = 0):
    group = axis_group(mesh, axis_name)
    return x if group is None else _ReduceScatter.apply(x, group, axis)


def broadcast(x, mesh, axis_name, root: int = 0):
    """Every rank of the axis receives the value of the axis's ``root``."""
    group = axis_group(mesh, axis_name)
    return x if group is None else _Broadcast.apply(x, group, root)


def alltoall(x, mesh, axis_name, split_axis: int, concat_axis: int):
    group = axis_group(mesh, axis_name)
    return x if group is None else _AllToAll.apply(x, group, split_axis,
                                                   concat_axis)


def ppermute_shift(x, mesh, axis_name, shift: int = 1):
    """Rotate values around the axis ring by ``shift`` (rank i's value
    lands on rank i + shift)."""
    group = axis_group(mesh, axis_name)
    return x if group is None else _Shift.apply(x, group, shift)


def tie(x, t):
    """``x`` plus 0 times one element of ``t``: the same values, with ``t``
    on the path to ``x`` when ``t`` takes a gradient. A rank that leaves
    the result of a shift unused would skip that shift's backward, which
    its peers wait for; tying the unused result into a used value keeps
    every shift's backward on every rank."""
    if not (isinstance(t, torch.Tensor) and t.requires_grad):
        return x
    return x + t.flatten()[0].to(x.dtype) * 0


class _LossMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, world):
        ctx.world = world
        return x if group is None else _all_reduce(x, group, "mean")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None, None


def loss_mean(x, mesh, axis_name):
    """The mean over ``axis_name`` of each rank's ``x``, as the one loss
    that every rank of the mesh then holds. Every rank runs the backward
    from its copy, so each takes 1/(ranks of the mesh) of the cotangent:
    the sum of the ranks' gradients is then the loss's, and each
    parameter's gradient is that sum over the axes the parameter is
    replicated on (``train.train_step.reduce_gradients``). Without a
    mesh ``x`` as is."""
    if mesh is None:
        return x
    return _LossMean.apply(x, axis_group(mesh, axis_name), mesh.size())
