"""FSDP parameter gathers, and their overlap with layer compute — the
PyTorch port of ``ray_tpu/parallel/fsdp_overlap.py``.

``gather_params`` all-gathers each leaf along the dim its spec shards over
a mesh axis; the gather's backward is the reduce-scatter (the transpose of
the tiled all-gather, ``parallel/collectives.py``), so each rank's shard
receives the sum of every rank's gradient for it. ``overlap_scan`` runs a
stack of layers, issuing the asynchronous gather of layer ``i + 1``'s
shards before layer ``i``'s compute and waiting for it only after: one
gather in flight at a time (on the card NCCL runs it on its own stream;
``Work.wait`` orders the compute stream after it without blocking the
host). The gathered layer is what the layer body receives, so a
checkpointed (remat) body saves it for the backward, as the JAX scan's
carry does.

The backward's reduce-scatters run where autograd reaches each gather,
interleaved with the backward of the layers.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import P, axis_group


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts, lists and tuples (parameter
    trees), the structure taken from the first tree: the others (specs,
    say) are indexed by its keys and positions."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def spec_axis_dim(spec, axis: str):
    """Index of the array dim ``spec`` shards over mesh axis ``axis``, or
    None."""
    if spec is None:
        return None
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, (tuple, list))
                             and axis in entry):
            return i
    return None


def _is_spec(x) -> bool:
    return x is None or isinstance(x, P)


def _spec_map(fn, specs):
    if _is_spec(specs):
        return fn(specs)
    return {k: _spec_map(fn, v) for k, v in specs.items()}


def project_specs(specs, keep_axes) -> Any:
    """Drop every mesh-axis name not in ``keep_axes`` from a spec tree (the
    dropped dims become replicated)."""
    keep = set(keep_axes)

    def proj(spec):
        if spec is None:
            return P()
        out = []
        for entry in spec:
            if isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in keep)
                out.append(kept if len(kept) > 1
                           else (kept[0] if kept else None))
            else:
                out.append(entry if entry in keep else None)
        return P(*out)

    return _spec_map(proj, specs)


def drop_leading_dim(specs) -> Any:
    """Specs of one layer's leaves, the stacked layer dim removed."""
    return _spec_map(lambda s: P(*tuple(s or ())[1:]), specs)


def gather_params(tree, specs, mesh, axis_name: str):
    """All-gather every leaf along its ``axis_name``-sharded dim (tiled, so
    the backward reduce-scatters); leaves not sharded on ``axis_name``
    pass through."""

    def g(x, spec):
        d = spec_axis_dim(spec, axis_name)
        if d is None:
            return x
        return collectives.allgather(x, mesh, axis_name, axis=d)

    return tree_map(g, tree, specs)


class _Pending:
    """An issued gather's work handle (set by ``_AsyncGather``): its
    output may be read once ``work.wait()`` returned."""

    def __init__(self):
        self.work = None


class _AsyncGather(torch.autograd.Function):
    """Tiled all-gather along dim 0, issued without waiting: the output
    may be read only after ``pending.work.wait()``. The backward is the
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        pending.work = collectives._gather_into(out, x.contiguous(),
                                                group=group, async_op=True)
        return out

    @staticmethod
    def backward(ctx, g):
        return collectives._scatter0(g, ctx.group), None, None


def _start_gather(layer, specs, mesh, axis_name):
    """Issue the gathers of one layer's sharded leaves: -> (the leaves as
    they will be once the gathers completed, the pending works)."""
    group = axis_group(mesh, axis_name)
    works = []

    def g(x, spec):
        d = spec_axis_dim(spec, axis_name)
        if d is None or group is None:
            return x
        pending = _Pending()
        out = _AsyncGather.apply(x.movedim(d, 0), group, pending)
        works.append(pending)
        return out.movedim(0, d)

    return tree_map(g, layer, specs), works


def overlap_scan(layers, layer_specs, x, apply_fn: Callable,
                 n_layers: int, mesh, axis_name: str = "fsdp"):
    """Apply ``apply_fn(gathered_layer_params, x) -> x`` over stacked
    layers, prefetching: the gather of layer ``i + 1``'s shards is issued
    before layer ``i``'s compute.

    layers: tree of [n_layers, ...] local shards, sharded on
    ``axis_name`` per ``layer_specs`` (the specs of one layer, layer dim
    removed).
    """
    unbound = {}     # one unbind per leaf: the backward stacks its layers

    def layer(i):
        def take(w):
            if id(w) not in unbound:
                unbound[id(w)] = w.unbind(0)
            return unbound[id(w)][i]
        return tree_map(take, layers)

    nxt = _start_gather(layer(0), layer_specs, mesh, axis_name)
    for i in range(n_layers):
        w, works = nxt
        for pending in works:
            pending.work.wait()
        # prefetch first: the next gather does not depend on this layer
        if i + 1 < n_layers:
            nxt = _start_gather(layer(i + 1), layer_specs, mesh, axis_name)
        x = apply_fn(w, x)
    return x
