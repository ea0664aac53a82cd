"""The device mesh — the PyTorch port of ``ray_tpu/parallel/mesh.py``.

A ``MeshSpec`` names the parallelism degrees; ``build_mesh`` lays the ranks
of the process group out as a ``torch.distributed.device_mesh.DeviceMesh``
with the five canonical axes, tp innermost. Where the JAX package has one
controller driving every device of its mesh, here each process holds one
device and is one rank of the group: every rank runs the same program on
its own shard, so ``shard_map`` has no counterpart.

A spec for one array (``P``, the ``PartitionSpec`` counterpart) names, per
array dim, the mesh axis (or the tuple of axes, in mesh order) that shards
it, or None. ``placements`` turns it into DTensor placements: ``Shard(dim)``
on each named axis, ``Replicate()`` on every other.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp")
#: the expert axis: not a ``MeshSpec`` axis (the JAX package's is not
#: either); it lives on meshes made by hand, and has size 1 elsewhere
EXPERT_AXIS = "ep"
#: seconds a collective of the run's process group, or of a group a mesh
#: builds over it, waits for its peers before it fails. Far above the
#: longest wait between two collectives of a healthy run (a sharded
#: checkpoint's save, whose barrier gives up after
#: ``CheckpointConfig.barrier_timeout_s``, 60 s by default) and far below
#: torch's defaults (30 minutes for gloo, 10 for NCCL), which a dead peer
#: would otherwise hold every survivor for.
GROUP_TIMEOUT_S = 300.0


class P(tuple):
    """PartitionSpec: one entry per array dim, each None, an axis name or
    a tuple of axis names (sharded over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parallelism degrees for one job. -1 on at most one axis = "fill".

    Example: MeshSpec(fsdp=-1, tp=4) on 32 ranks -> pp1 x dp1 x fsdp8 x
    sp1 x tp4.

    ``dcn_dp``/``dcn_pp`` add an outer data/pipeline dimension that spans
    nodes (the JAX package's slices): the built mesh still has the five
    axes, its dp axis ``dcn_dp x dp`` with the node dimension major, so
    tp/sp/fsdp groups stay inside one node.
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    dcn_dp: int = 1
    dcn_pp: int = 1

    def degrees(self) -> dict:
        """Per-node degrees only."""
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_slices(self) -> int:
        return self.dcn_dp * self.dcn_pp

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill the single -1 axis so slices x inner == n_devices."""
        d = self.degrees()
        for a, v in d.items():
            if v != -1 and v < 1:
                raise ValueError(f"axis {a!r} degree must be -1 or >= 1, got {v}")
        if self.dcn_dp < 1 or self.dcn_pp < 1:
            raise ValueError("dcn degrees must be >= 1")
        if n_devices % self.num_slices:
            raise ValueError(
                f"{n_devices} devices not divisible into "
                f"{self.num_slices} slices")
        per_slice = n_devices // self.num_slices
        fill = [a for a, v in d.items() if v == -1]
        if len(fill) > 1:
            raise ValueError(f"at most one -1 axis, got {fill}")
        fixed = math.prod(v for v in d.values() if v != -1)
        if fill:
            if per_slice % fixed:
                raise ValueError(
                    f"{per_slice} devices/slice not divisible by fixed "
                    f"degrees {fixed}")
            d[fill[0]] = per_slice // fixed
        elif fixed != per_slice:
            raise ValueError(
                f"mesh {d} needs {fixed} devices per slice, have "
                f"{per_slice}")
        return MeshSpec(**d, dcn_dp=self.dcn_dp, dcn_pp=self.dcn_pp)

    @property
    def size(self) -> int:
        return math.prod(self.degrees().values()) * self.num_slices


def _dist():
    import torch.distributed as dist
    return dist


def device_count() -> int:
    """Ranks (one device each) in the process group; 1 without a group."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """Devices this process drives: one (a rank holds one device)."""
    return 1


def _group_by_slice(node_ids: Sequence[str], num_slices: int) -> list:
    """Partition ranks into per-node groups, rank order kept: by node id
    when the ranks span exactly ``num_slices`` nodes in equal numbers,
    else contiguous equal chunks (warning when the ranks span several
    nodes: inner-axis groups may then cross nodes)."""
    n = len(node_ids)
    per = n // num_slices
    keys = sorted(set(node_ids))
    if len(keys) == num_slices:
        groups = [[r for r in range(n) if node_ids[r] == k] for k in keys]
        if all(len(g) == per for g in groups):
            return groups
    if len(keys) > 1:
        warnings.warn(
            f"ranks span {len(keys)} nodes but the node ids do not group "
            f"them into {num_slices} equal slices; falling back to "
            f"contiguous chunks whose inner-axis groups may cross nodes",
            stacklevel=3)
    return [list(range(i * per, (i + 1) * per)) for i in range(num_slices)]


def _rank_layout(spec: MeshSpec, node_ids: Optional[Sequence[str]]):
    """[pp, dp, fsdp, sp, tp] array of ranks, the slice dimension major
    in dp and pp."""
    import numpy as np
    world = spec.size
    shape = tuple(spec.degrees()[a] for a in AXIS_ORDER)
    if spec.num_slices == 1:
        return np.arange(world).reshape(shape)
    slices = _group_by_slice(list(node_ids or ["local"] * world),
                             spec.num_slices)
    full = np.empty((spec.dcn_pp * spec.pp, spec.dcn_dp * spec.dp,
                     spec.fsdp, spec.sp, spec.tp), dtype=np.int64)
    sid = 0
    for a in range(spec.dcn_pp):
        for b in range(spec.dcn_dp):
            full[a * spec.pp:(a + 1) * spec.pp,
                 b * spec.dp:(b + 1) * spec.dp] = \
                np.asarray(slices[sid]).reshape(shape)
            sid += 1
    return full


def build_mesh(spec: MeshSpec, device_type: Optional[str] = None,
               node_ids: Optional[Sequence[str]] = None):
    """The DeviceMesh of ``spec`` over every rank of the process group
    (which must be up), axes ``AXIS_ORDER``, tp innermost.

    device_type: "cuda" or "cpu"; None takes "cuda" under NCCL, else
    "cpu". node_ids (one per rank; with dcn axes only) group the ranks
    into slices. Besides the group of each axis, the mesh carries a group
    for every combination of its axes larger than 1 (``axis_group``): all
    ranks create them here together, as ``new_group`` requires.
    """
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed's process "
                           "group (train.backend.setup_torch_worker)")
    spec = spec.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = _rank_layout(spec, node_ids)
    if spec.num_slices == 1:
        mesh = init_device_mesh(device_type, layout.shape,
                                mesh_dim_names=AXIS_ORDER)
    else:
        mesh = DeviceMesh(device_type, torch.as_tensor(layout),
                          mesh_dim_names=AXIS_ORDER)
    mesh._rtpt_groups = _combined_groups(mesh, layout)
    _bound_waits(mesh)
    return mesh


def group_timeout():
    """``GROUP_TIMEOUT_S`` as the timedelta torch takes."""
    import datetime
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


def _bound_waits(mesh) -> None:
    """Give the groups of each mesh axis the run's timeout: torch creates
    them with its backend default, not the world group's."""
    from torch.distributed.distributed_c10d import _set_pg_timeout
    for i in range(mesh.ndim):
        _set_pg_timeout(group_timeout(), mesh.get_group(i))


def _combined_groups(mesh, layout) -> Dict[Tuple[str, ...], object]:
    """A process group for each combination of two or more mesh axes
    larger than 1, keyed by the axes in mesh order; every rank creates
    every group, in the same order."""
    import numpy as np
    dist = _dist()
    big = [a for a in AXIS_ORDER if mesh.size(AXIS_ORDER.index(a)) > 1]
    groups = {}
    for n in range(2, len(big) + 1):
        for axes in itertools.combinations(big, n):
            keep = [AXIS_ORDER.index(a) for a in axes]
            moved = np.moveaxis(layout, keep, list(range(len(keep))))
            members = moved.reshape(math.prod(moved.shape[:len(keep)]), -1)
            groups[axes], _ = dist.new_subgroups_by_enumeration(
                [sorted(int(r) for r in members[:, j])
                 for j in range(members.shape[1])], timeout=group_timeout())
    return groups


def _axes(axis, mesh=None) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = _dim_names(mesh)
    for a in axes:
        if a not in AXIS_ORDER + (EXPERT_AXIS,) and a not in names:
            raise ValueError(f"unknown mesh axis {a!r}")
    return axes


def _dim_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: ``AXIS_ORDER`` for a ``build_mesh`` mesh,
    whatever a mesh made by hand names (the JAX tests' ``Mesh(devices,
    ("dp", "ep"))`` counterpart: ``init_device_mesh(..., mesh_dim_names=
    ("dp", "ep"))``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names else AXIS_ORDER


def _size(mesh, a: str) -> int:
    """Ranks along one axis; 1 for an axis the mesh does not have."""
    names = _dim_names(mesh)
    return mesh.size(names.index(a)) if a in names else 1


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names); 1 without a
    mesh, and for a canonical axis a hand-made mesh does not have."""
    if mesh is None:
        return 1
    return math.prod(_size(mesh, a) for a in _axes(axis, mesh))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along one axis (``lax.axis_index``'s
    counterpart); 0 without a mesh or where the axis holds one rank."""
    if mesh is None or _size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(_dim_names(mesh).index(axis))


def axis_group(mesh, axis):
    """The process group over ``axis`` (a name or a tuple of names), its
    ranks in row-major order of the axes, the first major; None when the
    axes hold one rank or there is no mesh (a collective over them is
    the identity)."""
    if mesh is None:
        return None
    wanted = _axes(axis, mesh)
    big = tuple(a for a in _dim_names(mesh) if a in wanted
                and _size(mesh, a) > 1)
    if not big:
        return None
    if len(big) == 1:
        return mesh.get_group(big[0])
    return mesh._rtpt_groups[big]


def placements(mesh, spec):
    """DTensor placements of an array sharded by ``spec`` on ``mesh``: for
    each mesh axis, ``Shard(d)`` when the spec names it at array dim d,
    else ``Replicate()``. Axes sharing one dim must come in mesh order
    (their product shards it, the first major)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in AXIS_ORDER]
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        names = _axes(entry)
        order = [AXIS_ORDER.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} of dim {d} must come in mesh "
                             f"order {AXIS_ORDER}")
        for i in order:
            out[i] = Shard(d)
    return out


def named_sharding(mesh, *axes):
    """The placements of ``P(*axes)`` on ``mesh`` (``NamedSharding``'s
    counterpart)."""
    return placements(mesh, P(*axes))


def shard_constraint(x, mesh, *axes):
    """``x`` laid out as ``P(*axes)``: a DTensor redistributed to those
    placements, a plain tensor (the same on every rank) distributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = named_sharding(mesh, *axes)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl)
