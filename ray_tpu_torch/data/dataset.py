"""Dataset — lazy, streaming, block-partitioned datasets.

The port of ``ray_tpu/data/dataset.py``: its tasks and actor pools run
on this package's runtime; nothing else changed. Role-equivalent to the
reference's Dataset (reference: python/ray/data/dataset.py:153 with the
logical-plan machinery under data/_internal/logical/):

  - a Dataset is a list of picklable read thunks plus a linear chain of
    per-block transforms — no operator DAG, because the ingest path is a
    straight line ending in a host→device feed;
  - execution is the streaming executor (one fused task per block, bounded
    in-flight window — see _internal/streaming_executor.py);
  - ``iter_batches`` re-chunks rows to EXACT batch_size across block
    boundaries so a downstream step sees one static shape.

``to_pandas`` and ``write_parquet`` import pandas and pyarrow only when
called: neither is needed to import or run the rest.
"""

from __future__ import annotations

import copy
import inspect
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, block_meta
from ray_tpu_torch.data._internal.streaming_executor import (
    ExecStats, execute_streaming)


#: internal transform signature: fn(block, block_index) -> block; the index
#: lets stateless per-block transforms derive distinct randomness per block
_Transform = Callable[[Block, int], Block]


@dataclass
class _Plan:
    """read thunks + fused transform chain (+ executor knobs)."""
    read_fns: List[Callable[[], Block]]
    transforms: List[_Transform] = field(default_factory=list)
    limit_rows: Optional[int] = None
    max_in_flight: int = 8
    ray_remote_args: Dict[str, Any] = field(default_factory=dict)

    def fused(self) -> Optional[_Transform]:
        if not self.transforms:
            return None
        chain = list(self.transforms)

        def _fused(block: Block, idx: int) -> Block:
            for t in chain:
                block = t(block, idx)
            return block
        return _fused


def _map_rows_transform(fn: Callable[[Any], Any]) -> _Transform:
    def _t(block: Block, idx: int) -> Block:
        rows = BlockAccessor.for_block(block).to_rows()
        return BlockAccessor.from_rows([fn(r) for r in rows])
    return _t


def _flat_map_transform(fn: Callable[[Any], Sequence[Any]]) -> _Transform:
    def _t(block: Block, idx: int) -> Block:
        out: List[Any] = []
        for r in BlockAccessor.for_block(block).to_rows():
            out.extend(fn(r))
        return BlockAccessor.from_rows(out)
    return _t


def _filter_transform(fn: Callable[[Any], bool]) -> _Transform:
    def _t(block: Block, idx: int) -> Block:
        rows = BlockAccessor.for_block(block).to_rows()
        return BlockAccessor.from_rows([r for r in rows if fn(r)])
    return _t


def _map_batches_transform(fn, batch_format: str,
                           batch_size: Optional[int]) -> _Transform:
    def _t(block: Block, idx: int) -> Block:
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        if batch_size is None or n <= batch_size:
            return _normalize_batch(fn(acc.to_batch(batch_format)))
        outs = []
        for s in range(0, n, batch_size):
            sub = BlockAccessor.for_block(acc.slice(s, min(s + batch_size, n)))
            outs.append(_normalize_batch(fn(sub.to_batch(batch_format))))
        return BlockAccessor.concat(outs)
    return _t


def _normalize_batch(batch: Any) -> Block:
    if isinstance(batch, (dict, np.ndarray, list)):
        return batch
    raise TypeError(
        f"map_batches fn must return dict/ndarray/list, got {type(batch)}")


def _shuffle_transform(seed: int) -> _Transform:
    def _t(block: Block, idx: int) -> Block:
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        # seed per (epoch seed, block index): a single seed would permute
        # every same-size block identically, correlating rows across blocks
        perm = np.random.default_rng((seed, idx)).permutation(n)
        if isinstance(block, dict):
            return {k: v[perm] for k, v in acc.to_table().items()}
        if isinstance(block, np.ndarray):
            return block[perm]
        rows = acc.to_rows()
        return [rows[i] for i in perm]
    return _t


def _copy_chunk(b: Block) -> Block:
    """Per-block COPY of a slice — binding views would make every
    downstream task cloudpickle the whole source block (numpy views
    pickle only their elements, but deep-copy drops the base ref)."""
    if isinstance(b, dict):
        return {k: np.array(v) for k, v in b.items()}
    if isinstance(b, np.ndarray):
        return np.array(b)
    return list(b)


def _slice_into_reads(block: Block, num_blocks: int) -> List[Callable[[], Block]]:
    """Near-even re-slice of one block into num_blocks copied read thunks
    (shared by repartition and zip)."""
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    reads = []
    for i in range(num_blocks):
        s, e = i * n // num_blocks, (i + 1) * n // num_blocks
        chunk = _copy_chunk(acc.slice(s, e))
        reads.append(lambda _c=chunk: _c)
    return reads


class Dataset:
    def __init__(self, plan: _Plan):
        self._plan = plan
        self._last_stats: Optional[ExecStats] = None

    # ---------------------------------------------------------- transforms
    def _with_transform(self, t: Callable[[Block], Block]) -> "Dataset":
        plan = copy.copy(self._plan)
        plan.transforms = self._plan.transforms + [t]
        return Dataset(plan)

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._with_transform(_map_rows_transform(fn))

    def flat_map(self, fn: Callable[[Any], Sequence[Any]]) -> "Dataset":
        return self._with_transform(_flat_map_transform(fn))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        return self._with_transform(_filter_transform(fn))

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_format: str = "dict",
                    batch_size: Optional[int] = None,
                    compute: Optional["ActorPoolStrategy"] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None
                    ) -> "Dataset":
        """Per-batch transform. With ``compute=ActorPoolStrategy(n)`` and
        a CLASS for ``fn``, batches run on a pool of n stateful actors —
        the class is constructed once per actor (model-per-actor
        inference; reference: ActorPoolMapOperator,
        data/_internal/execution/operators/actor_pool_map_operator.py)."""
        if compute is not None or inspect.isclass(fn):
            if not inspect.isclass(fn):
                raise ValueError(
                    "compute=ActorPoolStrategy requires a class UDF "
                    "(constructed once per pool actor)")
            compute = compute or ActorPoolStrategy()
            return _ActorStageDataset(
                upstream=self, cls=fn,
                ctor_args=tuple(fn_constructor_args),
                ctor_kwargs=dict(fn_constructor_kwargs or {}),
                size=compute.size, batch_format=batch_format,
                batch_size=batch_size,
                ray_remote_args=dict(self._plan.ray_remote_args))
        return self._with_transform(
            _map_batches_transform(fn, batch_format, batch_size))

    # ----------------------------------------------------- shuffle family

    def _materialize_exact(self) -> "MaterializedDataset":
        """Materialize with limit_rows APPLIED to the stored blocks.
        materialize() only stops submission at the limit — the boundary
        block keeps its extra rows, which exchange-based ops (sort/
        groupby) would otherwise process and silently un-limit."""
        if self._plan.limit_rows is None:
            return self.materialize()

        @ray_tpu_torch.remote
        def trunc(block: Block, n: int) -> Block:
            acc = BlockAccessor.for_block(block)
            sub = acc.slice(0, n)
            # slices are views into the parent block: copy so the stored
            # object doesn't pin the untruncated original
            if isinstance(sub, dict):
                return {k: np.array(v) for k, v in sub.items()}
            if isinstance(sub, np.ndarray):
                return np.array(sub)
            return list(sub)

        refs: List[Any] = []
        budget = self._plan.limit_rows
        for ref, meta in self._execute():
            if budget <= 0:
                break
            take = min(meta["num_rows"], budget)
            refs.append(ref if take == meta["num_rows"]
                        else trunc.remote(ref, take))
            budget -= take
        return MaterializedDataset(refs)

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        """Global sort via range-partition exchange (reference:
        dataset.sort -> SortTaskSpec sample + range partition + per-range
        sort, data/_internal/planner/exchange/sort_task_spec.py)."""
        from ray_tpu_torch.data._internal import shuffle as sh
        mat = self._materialize_exact()
        refs = mat._refs  # noqa: SLF001
        if not refs:
            return mat
        num_parts = max(1, len(refs))
        kf = sh.key_fn(key)

        # sample each block for range boundaries (one small task per block)
        @ray_tpu_torch.remote
        def sample(block, k=32):
            rows = BlockAccessor.for_block(block).to_rows()
            if not rows:
                return []
            idx = np.linspace(0, len(rows) - 1,
                              min(k, len(rows))).astype(int)
            return [kf(rows[i]) for i in idx]

        samples: List[Any] = []
        for part in ray_tpu_torch.get([sample.remote(r) for r in refs],
                                timeout=600):
            samples.extend(part)
        samples.sort()
        if not samples:
            return mat
        # fewer samples than partitions (tiny/ragged datasets) would index
        # negatively and build non-monotonic boundaries -> silent missort
        num_parts = min(num_parts, len(samples))
        boundaries = [samples[max(0, (i + 1) * len(samples)
                                  // num_parts - 1)]
                      for i in range(num_parts - 1)]
        out = sh.exchange(
            refs, sh._map_range_partition, (key, boundaries),
            sh._reduce_sort, (key, descending), num_parts,
            ray_remote_args=self._plan.ray_remote_args)
        if descending:
            out = list(reversed(out))
        return MaterializedDataset(out)

    def groupby(self, key) -> "GroupedData":
        """Hash-partition the dataset by key for aggregation /
        per-group transforms (reference: dataset.groupby -> GroupedData,
        grouped_data.py over the aggregate exchange)."""
        return GroupedData(self, key)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Whole-dataset aggregation (single implicit group)."""
        gd = GroupedData(self, key=None, whole=True)
        rows = gd.aggregate(*aggs).take_all()
        if not rows:
            return {}
        row = dict(rows[0])
        row.pop("key", None)
        return row

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Shuffle block order globally + rows within each block.

        An approximation of the reference's all-to-all shuffle
        (data/_internal/planner/exchange/) that never materializes the
        dataset — adequate for training-epoch decorrelation; not a uniform
        global permutation.
        """
        rng = random.Random(seed)
        plan = copy.copy(self._plan)
        plan.read_fns = list(self._plan.read_fns)
        rng.shuffle(plan.read_fns)
        plan.transforms = self._plan.transforms + [
            _shuffle_transform(rng.randrange(2**31))]
        return Dataset(plan)

    def limit(self, n: int) -> "Dataset":
        plan = copy.copy(self._plan)
        plan.limit_rows = n if plan.limit_rows is None \
            else min(plan.limit_rows, n)
        return Dataset(plan)

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets. Each side's transform chain is baked into
        its read thunks so the union has a single (empty) chain."""
        def _baked(ds: "Dataset") -> List[Callable[[], Block]]:
            if type(ds)._execute is not Dataset._execute:
                # custom execution (e.g. an actor-pool stage): its plan has
                # no read thunks — materialize to capture its real blocks
                ds = ds.materialize()
            fused = ds._plan.fused()
            if fused is None:
                return list(ds._plan.read_fns)

            def bake(rf, i, _fused=fused):
                return lambda: _fused(rf(), i)
            return [bake(rf, i)
                    for i, rf in enumerate(ds._plan.read_fns)]

        for ds in (self, *others):
            if ds._plan.limit_rows is not None:
                raise ValueError("union after limit is not supported")
        reads: List[Callable[[], Block]] = []
        for ds in (self, *others):
            reads.extend(_baked(ds))
        return Dataset(_Plan(read_fns=reads,
                             max_in_flight=self._plan.max_in_flight,
                             ray_remote_args=dict(self._plan.ray_remote_args)))

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-wise combine with another dataset of the SAME length
        (reference: dataset.py zip): dict blocks merge columns (right
        side's colliding names get a ``_1`` suffix, as the reference
        suffixes duplicates); other block kinds pair rows into tuples.
        Both sides materialize — zip is an alignment barrier by nature."""
        left = self._materialize_exact()
        right = other._materialize_exact()
        lb = [ray_tpu_torch.get(r) for r in left._refs]    # noqa: SLF001
        rb = [ray_tpu_torch.get(r) for r in right._refs]   # noqa: SLF001
        la = BlockAccessor.concat(lb) if lb else []
        ra = BlockAccessor.concat(rb) if rb else []
        lacc = BlockAccessor.for_block(la)
        racc = BlockAccessor.for_block(ra)
        if lacc.num_rows() != racc.num_rows():
            raise ValueError(
                f"zip needs equal lengths, got {lacc.num_rows()} vs "
                f"{racc.num_rows()}")
        if isinstance(la, dict) and isinstance(ra, dict):
            merged = dict(la)
            for k, v in ra.items():
                name = k
                i = 1
                while name in merged:   # find a FREE suffix — writing to
                    name = f"{k}_{i}"   # an occupied one would clobber a
                    i += 1              # left-side column silently
                merged[name] = v
            combined: Block = merged
        else:
            lrows = lacc.to_rows()
            rrows = racc.to_rows()
            combined = [(a, b) for a, b in zip(lrows, rrows)]
        # preserve the left side's block count so parallelism carries over
        return Dataset(_Plan(
            read_fns=_slice_into_reads(combined, max(1, len(lb)))))

    def split(self, n: int) -> List["Dataset"]:
        """Round-robin block partition into n shards (reference:
        dataset.py streaming_split's per-consumer sharding role), used to
        give each train worker a disjoint shard."""
        if n <= 0:
            raise ValueError("split(n) needs n >= 1")
        shards: List[Dataset] = []
        for i in range(n):
            plan = copy.copy(self._plan)
            plan.read_fns = self._plan.read_fns[i::n]
            plan.transforms = list(self._plan.transforms)
            shards.append(Dataset(plan))
        return shards

    def repartition(self, num_blocks: int) -> "Dataset":
        """Materialize then re-slice into num_blocks near-even blocks
        (sizes differ by at most one row; blocks are empty only when the
        dataset has fewer rows than num_blocks)."""
        mat = self.materialize()
        block = BlockAccessor.concat(
            [ray_tpu_torch.get(r) for r in mat._refs])  # noqa: SLF001
        return Dataset(_Plan(
            read_fns=_slice_into_reads(block, num_blocks)))

    # ---------------------------------------------------------- execution
    def _execute(self) -> Iterator:
        stats = ExecStats()
        self._last_stats = stats
        return execute_streaming(
            self._plan.read_fns, self._plan.fused(),
            max_in_flight=self._plan.max_in_flight,
            limit_rows=self._plan.limit_rows,
            stats=stats,
            ray_remote_args=self._plan.ray_remote_args)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "dict",
                     drop_last: bool = False) -> Iterator[Any]:
        """Stream exact-size batches, re-chunking across block boundaries.

        Blocks are buffered as (accessor, offset) and consumed by advancing
        the offset — table slices are numpy views, so each row is copied at
        most once (by the concat of a boundary-straddling batch), never
        re-concatenated per yielded batch.
        """
        budget = self._plan.limit_rows
        buf: List[BlockAccessor] = []
        head_off = 0  # consumed rows of buf[0]
        buffered = 0

        def emit(k: int) -> Block:
            nonlocal head_off, buffered
            parts: List[Block] = []
            need = k
            while need:
                acc = buf[0]
                avail = acc.num_rows() - head_off
                take = min(avail, need)
                parts.append(acc.slice(head_off, head_off + take))
                head_off += take
                need -= take
                buffered -= take
                if head_off == acc.num_rows():
                    buf.pop(0)
                    head_off = 0
            merged = parts[0] if len(parts) == 1 \
                else BlockAccessor.concat(parts)
            return BlockAccessor.for_block(merged).to_batch(batch_format)

        for block_ref, meta in self._execute():
            block = ray_tpu_torch.get(block_ref)
            acc = BlockAccessor.for_block(block)
            if budget is not None:
                take = min(acc.num_rows(), budget)
                acc = BlockAccessor.for_block(acc.slice(0, take))
                budget -= take
            if acc.num_rows():
                buf.append(acc)
                buffered += acc.num_rows()
            while buffered >= batch_size:
                yield emit(batch_size)
            if budget is not None and budget <= 0:
                break
        if buffered and not drop_last:
            yield emit(buffered)

    def iter_rows(self) -> Iterator[Any]:
        for batch in self.iter_batches(batch_size=4096, batch_format="rows"):
            yield from batch

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        if self._plan.limit_rows is not None:
            return sum(1 for _ in self.iter_rows())
        total = 0
        for _, meta in self._execute():
            total += meta["num_rows"]
        return total

    def schema(self) -> Any:
        for block_ref, _ in self._execute():
            return BlockAccessor.for_block(ray_tpu_torch.get(block_ref)).schema()
        return None

    def materialize(self) -> "MaterializedDataset":
        refs = [block_ref for block_ref, _ in self._execute()]
        return MaterializedDataset(refs, limit_rows=self._plan.limit_rows)

    # --------------------------------------------------------------- output

    def to_pandas(self):
        """Whole dataset as one pandas DataFrame (reference:
        dataset.py to_pandas). Assembled from columnar batches — no
        per-row dict churn for table datasets."""
        import pandas as pd
        parts = list(self.iter_batches(batch_size=65536,
                                       batch_format="dict"))
        if not parts:
            return pd.DataFrame()
        first = parts[0]
        if isinstance(first, dict) and first and \
                all(isinstance(v, np.ndarray) for v in first.values()):
            cols = {k: np.concatenate([p[k] for p in parts])
                    for k in first}
            return pd.DataFrame(cols)
        rows = [r for p in parts
                for r in BlockAccessor.for_block(p).to_rows()]
        if rows and isinstance(rows[0], dict):
            return pd.DataFrame(rows)
        return pd.DataFrame({"value": rows})

    def _write_blocks(self, path: str, suffix: str,
                      write_one: Callable[[Block, str], None]) -> List[str]:
        """Write one file per block via remote tasks (reference:
        data write tasks fan out per block). Returns written paths."""
        import os
        os.makedirs(path, exist_ok=True)
        src = self
        if self._plan.limit_rows is not None:
            # _execute() only stops SUBMISSION at the limit: the boundary
            # block keeps its overshoot rows; materialize-exact truncates
            src = self._materialize_exact()

        @ray_tpu_torch.remote
        def _write(block: Block, out_path: str) -> str:
            write_one(block, out_path)
            return out_path

        refs = []
        for i, (block_ref, meta) in enumerate(src._execute()):
            out_path = os.path.join(path, f"part-{i:05d}{suffix}")
            refs.append(_write.remote(block_ref, out_path))
        return ray_tpu_torch.get(refs)

    def write_json(self, path: str) -> List[str]:
        """One JSON-lines file per block under ``path`` (reference:
        dataset.py write_json)."""
        def write_one(block: Block, out_path: str) -> None:
            import json
            acc = BlockAccessor.for_block(block)

            def clean(r):
                if isinstance(r, dict):
                    return {k: v.tolist() if hasattr(v, "tolist") else v
                            for k, v in r.items()}
                return r.tolist() if hasattr(r, "tolist") else r
            with open(out_path, "w") as f:
                for r in acc.to_rows():
                    f.write(json.dumps(clean(r)) + "\n")
        return self._write_blocks(path, ".jsonl", write_one)

    def write_csv(self, path: str) -> List[str]:
        """One CSV file per block under ``path`` (reference:
        dataset.py write_csv). Requires dict (columnar) blocks."""
        def write_one(block: Block, out_path: str) -> None:
            import csv
            acc = BlockAccessor.for_block(block)
            rows = acc.to_rows()
            if rows and not isinstance(rows[0], dict):
                rows = [{"value": r} for r in rows]
            cols = list(rows[0].keys()) if rows else []
            with open(out_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=cols)
                w.writeheader()
                for r in rows:
                    w.writerow({k: (v.item() if hasattr(v, "item") else v)
                                for k, v in r.items()})
        return self._write_blocks(path, ".csv", write_one)

    def write_parquet(self, path: str) -> List[str]:
        """One parquet file per block under ``path`` (reference:
        dataset.py write_parquet). Gated on pyarrow."""
        try:
            import pyarrow  # noqa: F401
        except ImportError as e:
            raise ImportError("write_parquet requires pyarrow; use "
                              "write_json/write_csv") from e

        def write_one(block: Block, out_path: str) -> None:
            import pyarrow as pa
            import pyarrow.parquet as pq
            acc = BlockAccessor.for_block(block)
            table = acc.to_table()
            pq.write_table(
                pa.table({k: np.asarray(v) for k, v in table.items()}),
                out_path)
        return self._write_blocks(path, ".parquet", write_one)

    def write_npy(self, path: str) -> List[str]:
        """One .npy file per block under ``path`` — TENSOR datasets only
        (a dict/row block would pickle into an object array that
        read_npy's allow_pickle=False then refuses to load; use
        write_parquet/write_json for tables)."""
        def write_one(block: Block, out_path: str) -> None:
            if not isinstance(block, np.ndarray):
                arr = np.asarray(block)
                if arr.dtype == object:
                    raise TypeError(
                        "write_npy needs tensor blocks; this dataset has "
                        f"{type(block).__name__} blocks — use "
                        "write_parquet or write_json")
            else:
                arr = block
            np.save(out_path, arr)
        return self._write_blocks(path, ".npy", write_one)

    def iterator(self):
        """A DataIterator over this dataset (reference: dataset.py
        iterator() -> DataIterator)."""
        from ray_tpu_torch.data.iterator import DataIterator
        return DataIterator(self)

    def num_blocks(self) -> int:
        return len(self._plan.read_fns)

    def stats(self) -> Dict[str, Any]:
        return self._last_stats.summary() if self._last_stats else {}

    def __repr__(self) -> str:
        return (f"Dataset(num_blocks={self.num_blocks()}, "
                f"num_transforms={len(self._plan.transforms)})")


class MaterializedDataset(Dataset):
    """A Dataset whose blocks already live in the object store; holding the
    MaterializedDataset pins them (refcount via the held ObjectRefs)."""

    def __init__(self, refs: List[ray_tpu_torch.ObjectRef],
                 limit_rows: Optional[int] = None):
        self._refs = list(refs)

        def mk(ref):
            return lambda: ray_tpu_torch.get(ref)
        super().__init__(_Plan(read_fns=[mk(r) for r in self._refs],
                               limit_rows=limit_rows))


class GroupedData:
    """Result of ``ds.groupby(key)`` (reference: data/grouped_data.py)."""

    def __init__(self, ds: Dataset, key, whole: bool = False):
        self._ds = ds
        self._key = key
        # whole=True: single implicit group (Dataset.aggregate)
        self._whole = whole

    def _exchange(self, reduce_fn, reduce_args) -> Dataset:
        from ray_tpu_torch.data._internal import shuffle as sh
        mat = self._ds._materialize_exact()
        refs = mat._refs  # noqa: SLF001
        if not refs:
            return mat
        num_parts = 1 if self._whole else max(1, len(refs))
        key = (lambda r: 0) if self._whole else self._key
        out = sh.exchange(
            refs, sh._map_hash_partition, (key, num_parts),
            reduce_fn, reduce_args, num_parts,
            ray_remote_args=self._ds._plan.ray_remote_args)
        return MaterializedDataset(out)

    def aggregate(self, *aggs) -> Dataset:
        """One output row per group: the key plus one column per
        aggregation (AggregateFn instances)."""
        from ray_tpu_torch.data._internal import shuffle as sh
        specs = [(a.name, a.fn) for a in aggs]
        key = (lambda r: 0) if self._whole else self._key
        return self._exchange(sh._reduce_groups, (key, specs))

    def map_groups(self, fn) -> Dataset:
        """Apply ``fn(rows) -> row | list[row]`` per group (reference:
        grouped_data.map_groups)."""
        from ray_tpu_torch.data._internal import shuffle as sh
        key = (lambda r: 0) if self._whole else self._key
        return self._exchange(sh._reduce_map_groups, (key, fn))

    def count(self) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.count())

    def sum(self, col=None) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.sum(col))

    def mean(self, col=None) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.mean(col))

    def min(self, col=None) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.min(col))

    def max(self, col=None) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.max(col))

    def std(self, col=None) -> Dataset:
        from ray_tpu_torch.data._internal.shuffle import AggregateFn
        return self.aggregate(AggregateFn.std(col))


class ActorPoolStrategy:
    """Compute strategy for stateful map_batches (reference:
    data/_internal/compute.py ActorPoolStrategy — fixed size here; the
    reference's min/max autoscaling rides the serve autoscaler design)."""

    def __init__(self, size: int = 2):
        if size < 1:
            raise ValueError("ActorPoolStrategy size must be >= 1")
        self.size = size


class _BatchMapWorker:
    """Pool actor hosting one constructed UDF instance."""

    def __init__(self, cls_blob: bytes, args: tuple, kwargs: dict):
        import cloudpickle
        self._fn = cloudpickle.loads(cls_blob)(*args, **kwargs)

    def apply(self, block: Block, batch_format: str,
              batch_size: Optional[int]):
        t = _map_batches_transform(self._fn, batch_format, batch_size)
        out = t(block, 0)
        return out, block_meta(out)


class _ActorStageDataset(Dataset):
    """Dataset whose execution feeds upstream blocks through a pool of
    stateful actors (reference: ActorPoolMapOperator). Transforms chained
    AFTER this stage run as ordinary fused tasks on the stage's outputs."""

    def __init__(self, upstream: Dataset, cls, ctor_args: tuple,
                 ctor_kwargs: dict, size: int, batch_format: str,
                 batch_size: Optional[int],
                 ray_remote_args: Dict[str, Any]):
        super().__init__(_Plan(read_fns=[],
                               ray_remote_args=dict(ray_remote_args),
                               limit_rows=upstream._plan.limit_rows))
        self._upstream = upstream
        self._cls = cls
        self._ctor_args = ctor_args
        self._ctor_kwargs = ctor_kwargs
        self._size = size
        self._batch_format = batch_format
        self._batch_size = batch_size

    def _clone(self) -> "_ActorStageDataset":
        clone = _ActorStageDataset(
            self._upstream, self._cls, self._ctor_args, self._ctor_kwargs,
            self._size, self._batch_format, self._batch_size,
            dict(self._plan.ray_remote_args))
        clone._plan.transforms = list(self._plan.transforms)
        clone._plan.limit_rows = self._plan.limit_rows
        return clone

    def _with_transform(self, t) -> "Dataset":
        clone = self._clone()
        clone._plan.transforms = clone._plan.transforms + [t]
        return clone

    def num_blocks(self) -> int:
        return self._upstream.num_blocks()

    def split(self, n: int) -> List["Dataset"]:
        return self.materialize().split(n)

    def union(self, *others: "Dataset") -> "Dataset":
        return self.materialize().union(*others)

    def limit(self, n: int) -> "Dataset":
        # base limit() rebuilds a plain Dataset from our plan, whose
        # read_fns is [] (blocks flow through _execute) — every row would
        # silently vanish. Clone the stage and let iter_batches' row
        # budget enforce the cap.
        clone = self._clone()
        clone._plan.limit_rows = n if self._plan.limit_rows is None \
            else min(self._plan.limit_rows, n)
        return clone

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self.materialize().random_shuffle(seed=seed)

    def repartition(self, num_blocks: int) -> "Dataset":
        return self.materialize().repartition(num_blocks)

    def _execute(self) -> Iterator:
        import time as _time

        import cloudpickle
        stats = ExecStats()
        self._last_stats = stats
        cls_blob = cloudpickle.dumps(self._cls)
        worker_cls = ray_tpu_torch.remote(_BatchMapWorker)
        if self._plan.ray_remote_args:
            worker_cls = worker_cls.options(**self._plan.ray_remote_args)
        actors = [worker_cls.remote(cls_blob, self._ctor_args,
                                    self._ctor_kwargs)
                  for _ in range(self._size)]
        fused = self._plan.fused()

        @ray_tpu_torch.remote(num_returns=2)
        def _post(block: Block, idx: int):
            out = fused(block, idx)
            return out, block_meta(out)

        t0 = _time.monotonic()

        def emit(pair):
            block_ref, meta_ref = pair
            meta = ray_tpu_torch.get(meta_ref, timeout=600)
            stats.tasks += 1
            stats.rows += meta["num_rows"]
            stats.bytes += meta["size_bytes"]
            stats.wall_s = _time.monotonic() - t0
            return block_ref, meta

        # round-robin over the pool with a bounded window; results yield
        # in submission order (actor method queues keep per-actor FIFO, so
        # each actor runs one batch at a time — the statefulness contract)
        window: List[tuple] = []
        cap = max(2, 2 * self._size)
        try:
            idx = 0
            for block_ref, _ in self._upstream._execute():
                actor = actors[idx % self._size]
                pair = actor.apply.options(num_returns=2).remote(
                    block_ref, self._batch_format, self._batch_size)
                if fused is not None:
                    pair = _post.remote(pair[0], idx)
                window.append(pair)
                idx += 1
                while len(window) >= cap:
                    yield emit(window.pop(0))
            while window:
                yield emit(window.pop(0))
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:  # noqa: BLE001
                    pass
