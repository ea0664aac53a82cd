"""Train-step builder — the PyTorch port of ``ray_tpu/train/train_step.py``.

Where the JAX step is a pure function that returns new parameters and
optimizer state, this one updates the parameter tensors IN PLACE (the
optimizer steps them) and returns the same objects; gradients live only
between the backward and the update.

On a device mesh the parameters are DTensors (``shard_params``: each leaf
sharded by its spec) and every rank runs the same step on its shards: the
optimizer steps the local shards (``local_shard``, which share the
DTensors' storage), the loss's backward leaves each rank its share of
each gradient (``parallel.collectives.loss_mean``), and
``reduce_gradients`` sums each leaf's gradient over the mesh axes the
leaf is replicated on, so every replica holds the whole gradient of its
shard. ``grad_norm`` is the norm of the global leaves, each counted once.

The optimizer's state of a sharded parameter is local too; its
``state_dict()`` gives each such state tensor as a DTensor laid out like
its parameter (``_state_placements``), so a checkpoint writes every
rank's piece, and ``load_state_dict`` takes those DTensors, or the whole
arrays a checkpoint loads, and keeps this rank's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.parallel.fsdp_overlap import tree_map


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a (nested) parameter dict or list, in the order JAX
    flattens them: a dict by sorted key, a list in order, depth first."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, list):
        return [leaf for p in params for leaf in param_leaves(p)]
    return [leaf for key in sorted(params) for leaf in
            param_leaves(params[key])]


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and not isinstance(x, torch.Tensor))


def shard_params(params, mesh, specs):
    """Each leaf as a DTensor sharded by its spec (``parallel.mesh.P``):
    ``Shard(d)`` on the mesh axes the spec names at dim d, ``Replicate()``
    on the others. Every rank passes the same global leaves (made from
    one seed); each keeps its slice. Raises on a leaf whose device type
    is not the mesh's (``distribute_tensor`` would copy it there)."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel.mesh import placements

    def put(leaf, spec):
        if leaf.device.type != mesh.device_type:
            raise ValueError(f"a {leaf.device.type} tensor on a "
                             f"{mesh.device_type} mesh: make the leaves on "
                             f"the mesh's device")
        return distribute_tensor(leaf.detach(), mesh,
                                 placements(mesh, spec))

    if isinstance(params, torch.Tensor) or _is_spec(specs):
        return put(params, specs)
    return tree_map(put, params, specs)


def shard_batch(batch, mesh, spec=None):
    """Each array of ``batch`` as a DTensor with dim 0 over (dp, fsdp) (or
    over ``spec``), the other dims replicated. Raises when the ranks of
    (dp, fsdp) do not divide dim 0 (the loss averages the shards' means,
    which is the batch's mean only for equal shards), and, as
    ``shard_params``, on an array on another device type than the
    mesh's."""
    from ray_tpu_torch.parallel.mesh import P, axis_size
    spec = spec if spec is not None else P(("dp", "fsdp"))
    n = axis_size(mesh, spec[0]) if spec and spec[0] is not None else 1

    def put(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n} equal shards over {spec[0]}")
        return shard_params(x, mesh, spec)

    return tree_map(put, batch)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Where a local shard sits in its global leaf: the mesh, the
    leaf's placements and its global shape."""

    mesh: Any
    placements: Tuple[Any, ...]
    global_shape: Tuple[int, ...]

    def _names(self, keep) -> Tuple[str, ...]:
        from ray_tpu_torch.parallel.mesh import AXIS_ORDER
        return tuple(a for a, pl in zip(AXIS_ORDER, self.placements)
                     if keep(pl))

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that shard array dim ``dim``."""
        return self._names(lambda pl: pl.is_shard(dim))

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        return self._names(lambda pl: pl.is_shard())

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        return self._names(lambda pl: pl.is_replicate())


def local_shard(leaf) -> torch.Tensor:
    """A DTensor's local shard as a plain leaf tensor sharing its storage
    (an update of one is an update of the other), with ``shard_info``
    set; any other tensor as is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return leaf
    with torch.no_grad():
        local = leaf.to_local().detach()
    local.shard_info = ShardInfo(leaf.device_mesh, tuple(leaf.placements),
                                 tuple(leaf.shape))
    return local


def _groups(leaves, axes_of) -> Dict[Tuple[str, ...], List[torch.Tensor]]:
    out: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for t in leaves:
        info = getattr(t, "shard_info", None)
        if info is not None:
            out.setdefault(axes_of(info), []).append(t)
    return out


def reduce_gradients(leaves: List[torch.Tensor]) -> None:
    """Sum each sharded leaf's gradient over the mesh axes the leaf is
    replicated on (one all-reduce per set of axes, over the gradients
    flattened together). Leaves without ``shard_info`` are left alone."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import axis_group
    for axes, ts in _groups(leaves, lambda i: i.replicated_axes).items():
        group = axis_group(ts[0].shard_info.mesh, axes)
        if group is None:
            continue
        flat = torch.cat([t.grad.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for t, g in zip(ts, flat.split([t.numel() for t in ts])):
            t.grad.copy_(g.view_as(t.grad))


def global_norm(tensors, infos: Optional[List[Any]] = None) -> torch.Tensor:
    """L2 norm over all tensors together, in fp32 (``optax.global_norm``).
    With ``infos`` (a ``ShardInfo`` or None per tensor) the tensors are
    local shards: each squared sum is summed over the axes its leaf is
    sharded on, so every global leaf counts once."""
    if infos is None or all(i is None for i in infos):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.float()) for t in tensors]))
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import axis_group
    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    mesh = next(i.mesh for i in infos if i is not None)
    for t, info in zip(tensors, infos):
        by_axes.setdefault(info.sharded_axes if info else (), []).append(
            torch.linalg.vector_norm(t.float()) ** 2)
    total = []
    for axes, parts in by_axes.items():
        part = torch.stack(parts).sum()
        group = axis_group(mesh, axes) if axes else None
        if group is not None:
            dist.all_reduce(part, group=group)
        total.append(part)
    return torch.stack(total).sum().sqrt()


def _state_placements(opt, p, name: str, ndim: int):
    """(placements, kept dims) of the state tensor ``name`` (``ndim``
    dims) of the sharded parameter ``p``: the dims of ``p`` it keeps come
    from ``opt.state_dims(p, name)`` where the optimizer has that
    (Adafactor's factored moments drop a dim), else all of them (a state
    of the parameter's rank: AdamW's moments). A mesh axis sharding a
    kept dim shards the state's dim there; one sharding a dropped dim
    (the state is a mean over it) replicates it."""
    from torch.distributed.tensor import Replicate, Shard
    info = p.shard_info
    dims = getattr(opt, "state_dims", None)
    kept = tuple(dims(p, name)) if dims is not None else None
    if kept is None:
        if ndim != p.dim():
            raise ValueError(
                f"state {name!r} ({ndim} dims) of a sharded {p.dim()}-dim "
                f"parameter: {type(opt).__name__} does not say which "
                f"dims it keeps (state_dims)")
        kept = tuple(range(p.dim()))
    pl = tuple(Shard(kept.index(q.dim)) if q.is_shard() and q.dim in kept
               else Replicate() for q in info.placements)
    return pl, kept


def _sharded_state(opt, params: List[torch.Tensor], fn) -> Callable:
    """A state-dict hook applying ``fn(p, value, placements,
    global_shape)`` to each non-scalar state tensor of each sharded
    parameter, into new per-parameter dicts (``state_dict()`` hands out
    the optimizer's own)."""
    def hook(_opt, sd):
        state = {}
        for idx, st in sd["state"].items():
            p = params[idx]
            if getattr(p, "shard_info", None) is not None:
                st = dict(st)
                for name, v in st.items():
                    if getattr(v, "ndim", 0):
                        pl, kept = _state_placements(opt, p, name, v.ndim)
                        gshape = tuple(p.shard_info.global_shape[d]
                                       for d in kept)
                        st[name] = fn(p, v, pl, gshape)
            state[idx] = st
        return {**sd, "state": state}
    return hook


def _state_as_dtensor(p, v, pl, gshape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(v, p.shard_info.mesh, pl, run_check=False)


def _state_to_local(p, v, pl, gshape):
    """This rank's slice of a loaded state tensor: a DTensor's local
    shard on ``pl``, or the slice of a whole array (numpy or torch)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train.checkpoint import shard_bounds
    mesh = p.shard_info.mesh
    if isinstance(v, DTensor):
        return v.redistribute(mesh, pl).to_local()
    if tuple(v.shape) != gshape:
        raise ValueError(f"optimizer state of shape {tuple(v.shape)} for a "
                         f"leaf whose state is {gshape} across the mesh: "
                         f"load the whole array or its DTensor")
    return v[tuple(slice(a, b) for a, b in
                   shard_bounds(gshape, mesh, pl))].contiguous()


def _numpy_to_torch(_opt, sd):
    """A checkpoint loaded without a target holds numpy arrays: as
    tensors, for ``load_state_dict``."""
    import numpy as np

    def conv(v):
        return torch.from_numpy(np.array(v)) if isinstance(
            v, (np.ndarray, np.generic)) else v
    return {**sd, "state": {int(i): {k: conv(v) for k, v in st.items()}
                            for i, st in sd["state"].items()}}


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    optimizer: Callable[[List[torch.Tensor]],
                                        torch.optim.Optimizer]):
    """Build (init_fn, step_fn).

    loss_fn(params, batch) -> scalar loss. optimizer(leaves) builds a
    ``torch.optim.Optimizer`` over the list of parameter leaves (e.g.
    ``lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)``, which
    is ``optax.adamw(1e-3)``). ``init_fn(params)`` marks the leaves as
    requiring grad and returns the optimizer (the optimizer state; on a
    mesh its ``state_dict()`` holds DTensors, see the module's doc);
    ``step_fn(params, opt_state, batch)`` returns
    ``(params, opt_state, {"loss", "grad_norm"})``, both values 0-dim
    tensors on the parameters' device (read them when needed: reading
    waits for the card).

    DTensor leaves (``shard_params``) train on every rank of their mesh:
    ``loss_fn`` receives the tree of local shards (and the batch as
    given: ``llama.loss_fn(..., mesh=)`` takes DTensors or local
    tensors), the optimizer steps the local shards, and the gradients
    are reduced over each leaf's replicas before the update.
    """
    local: Dict[int, torch.Tensor] = {}

    def to_local(params):
        return tree_map(lambda leaf: local.get(id(leaf), leaf), params) \
            if local else params

    def init_fn(params) -> torch.optim.Optimizer:
        leaves = []
        for leaf in param_leaves(params):
            shard = local_shard(leaf)
            if shard is not leaf:
                local[id(leaf)] = shard
            shard.requires_grad_(True)
            leaves.append(shard)
        opt = optimizer(leaves)
        ordered = [p for g in opt.param_groups for p in g["params"]]
        opt.register_state_dict_post_hook(
            _sharded_state(opt, ordered, _state_as_dtensor))
        opt.register_load_state_dict_pre_hook(_numpy_to_torch)
        opt.register_load_state_dict_pre_hook(
            _sharded_state(opt, ordered, _state_to_local))
        return opt

    def step_fn(params, opt_state: torch.optim.Optimizer, batch):
        tree = to_local(params)
        loss = loss_fn(tree, batch)
        loss.backward()
        leaves = param_leaves(tree)
        infos = [getattr(t, "shard_info", None) for t in leaves]
        reduce_gradients(leaves)
        gnorm = global_norm([t.grad for t in leaves], infos)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {"loss": loss.detach(),
                                            "grad_norm": gnorm}
        return params, opt_state, metrics

    return init_fn, step_fn
