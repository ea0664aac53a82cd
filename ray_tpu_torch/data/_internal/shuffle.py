"""All-to-all exchange: hash/range partition via tasks + reduce build.

Role-equivalent to the reference's shuffle-family operator planner
(reference: python/ray/data/_internal/planner/exchange/ —
ShuffleTaskSpec map-side partitioning into N outputs, reduce-side build;
operators wired in data/_internal/execution/operators/); the port of
``ray_tpu/data/_internal/shuffle.py``. On this package's runtime's
primitives: the map task uses ``num_returns=P`` so each
partition travels as its own object (reduce j pulls only column j of the
partition matrix — the same data movement as the reference's exchange,
without a dedicated shuffle service).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor


def key_fn(key) -> Callable[[Any], Any]:
    """Row -> sort/group key. A string key indexes dict rows (table
    datasets); a callable is used as-is; None = identity."""
    if key is None:
        return lambda r: r
    if callable(key):
        return key
    return lambda r, _k=key: r[_k]


def _partition_rows(rows: List[Any], part_of: Callable[[Any], int],
                    num_parts: int) -> List[Block]:
    buckets: List[List[Any]] = [[] for _ in range(num_parts)]
    for r in rows:
        buckets[part_of(r)].append(r)
    return [BlockAccessor.from_rows(b) for b in buckets]


def _stable_hash(value: Any) -> int:
    """Process-independent hash: builtin hash() is salted per process
    (PYTHONHASHSEED), so two map workers would send the same string key
    to DIFFERENT partitions — the shuffle would silently split groups."""
    import hashlib
    import pickle
    try:
        blob = pickle.dumps(value, protocol=4)
    except Exception:  # noqa: BLE001 — unpicklable key: fall back to repr
        blob = repr(value).encode()
    return int.from_bytes(hashlib.md5(blob).digest()[:8], "little")


def _map_hash_partition(block: Block, key, num_parts: int) -> tuple:
    if num_parts == 1:
        return block  # single partition: skip per-row hashing entirely
    kf = key_fn(key)
    rows = BlockAccessor.for_block(block).to_rows()
    parts = _partition_rows(
        rows, lambda r: _stable_hash(kf(r)) % num_parts, num_parts)
    return tuple(parts)


def _map_range_partition(block: Block, key, boundaries: list) -> tuple:
    if not boundaries:
        return block  # single partition
    kf = key_fn(key)
    rows = BlockAccessor.for_block(block).to_rows()
    num_parts = len(boundaries) + 1

    def part_of(r):
        import bisect
        return bisect.bisect_right(boundaries, kf(r))
    parts = _partition_rows(rows, part_of, num_parts)
    return tuple(parts)


def exchange(block_refs: List[Any], map_fn: Callable[..., tuple],
             map_args: tuple, reduce_fn: Callable[..., Block],
             reduce_args: tuple, num_parts: int,
             ray_remote_args: Optional[Dict[str, Any]] = None
             ) -> List[Any]:
    """Generic 2-phase exchange: every input block is partitioned into
    ``num_parts`` outputs by a map task; reduce task j builds its final
    block from partition j of every map. Returns the reduce block refs."""
    remote_args = dict(ray_remote_args or {})

    mapper = ray_tpu_torch.remote(map_fn).options(
        num_returns=num_parts, **remote_args)
    part_matrix: List[Sequence[Any]] = []  # [map][part] -> ref
    for ref in block_refs:
        out = mapper.remote(ref, *map_args)
        part_matrix.append((out,) if num_parts == 1 else out)

    reducer = ray_tpu_torch.remote(reduce_fn).options(**remote_args)
    return [reducer.remote(*reduce_args,
                           *[row[j] for row in part_matrix])
            for j in range(num_parts)]


# --------------------------------------------------------------- reducers


def _reduce_sort(key, descending: bool, *parts: Block) -> Block:
    kf = key_fn(key)
    rows: List[Any] = []
    for p in parts:
        rows.extend(BlockAccessor.for_block(p).to_rows())
    rows.sort(key=kf, reverse=descending)
    return BlockAccessor.from_rows(rows)


def _reduce_groups(key, agg_specs: list, *parts: Block) -> Block:
    """Build {key -> rows}, apply each aggregation, one output row per
    group (reference: SortAggregateTaskSpec's combine step)."""
    kf = key_fn(key)
    groups: Dict[Any, List[Any]] = {}
    for p in parts:
        for r in BlockAccessor.for_block(p).to_rows():
            groups.setdefault(kf(r), []).append(r)
    out_rows = []
    key_name = key if isinstance(key, str) else "key"
    for k in sorted(groups, key=lambda x: (str(type(x)), x)):
        rows = groups[k]
        out: Dict[str, Any] = {key_name: k}
        for name, fn in agg_specs:
            out[name] = fn(rows)
        out_rows.append(out)
    return BlockAccessor.from_rows(out_rows)


def _reduce_map_groups(key, fn, *parts: Block) -> Block:
    kf = key_fn(key)
    groups: Dict[Any, List[Any]] = {}
    for p in parts:
        for r in BlockAccessor.for_block(p).to_rows():
            groups.setdefault(kf(r), []).append(r)
    out_rows: List[Any] = []
    for k in sorted(groups, key=lambda x: (str(type(x)), x)):
        res = fn(groups[k])
        if isinstance(res, list):
            out_rows.extend(res)
        else:
            out_rows.append(res)
    return BlockAccessor.from_rows(out_rows)


# ------------------------------------------------------------ aggregations


def _values(rows: List[Any], col: Optional[str]) -> list:
    if col is None:
        return rows
    return [r[col] for r in rows]


class AggregateFn:
    """A named aggregation over a group's rows (reference:
    data/aggregate.py AggregateFn — collapsed to a whole-group callable,
    which is exact because groups are fully assembled reduce-side)."""

    def __init__(self, name: str, fn: Callable[[List[Any]], Any]):
        self.name = name
        self.fn = fn

    @classmethod
    def count(cls) -> "AggregateFn":
        return cls("count()", len)

    @classmethod
    def sum(cls, col: Optional[str] = None) -> "AggregateFn":
        return cls(f"sum({col or ''})",
                   lambda rows: float(np.sum(_values(rows, col))))

    @classmethod
    def mean(cls, col: Optional[str] = None) -> "AggregateFn":
        return cls(f"mean({col or ''})",
                   lambda rows: float(np.mean(_values(rows, col))))

    @classmethod
    def min(cls, col: Optional[str] = None) -> "AggregateFn":
        return cls(f"min({col or ''})",
                   lambda rows: np.min(_values(rows, col)).item())

    @classmethod
    def max(cls, col: Optional[str] = None) -> "AggregateFn":
        return cls(f"max({col or ''})",
                   lambda rows: np.max(_values(rows, col)).item())

    @classmethod
    def std(cls, col: Optional[str] = None) -> "AggregateFn":
        return cls(f"std({col or ''})",
                   lambda rows: float(np.std(_values(rows, col), ddof=1)))
