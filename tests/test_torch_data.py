"""The port's datasets (``ray_tpu_torch.data``) against the JAX package's
(``ray_tpu.data``), each on its own package's local-mode runtime.

Each program runs through both packages, with the same inputs (literals,
or numpy arrays from a seed), and its rows must be equal, row by row:
numpy values are compared with their dtypes. The programs are those of
tests/test_data.py (all but the trainer with dataset shards), and those
of tests/test_data_shuffle.py and tests/test_data_io.py, which the JAX
package runs on its cluster runtime there and here in its local mode.

The JAX package's local-mode memory store takes a non-reentrant lock,
and an ObjectRef's ``__del__``, run by the cyclic collector inside an
allocation under that lock, frees its object through the same lock on
the same thread: a deadlock, in about two of three runs of a groupby.
The port's store takes a reentrant lock (tests/test_torch_runtime.py
holds it to that); here the JAX package's side of each program runs with
the collector paused, and collects once it is done.
"""

import contextlib
import gc
import json

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(local_mode=True, num_cpus=4)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@contextlib.contextmanager
def collector_paused():
    """The JAX package's side of a program: no cyclic collection inside
    its memory store's lock (see the module docstring)."""
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        gc.enable()


def plain(x):
    """Rows as comparable Python values; numpy values keep their dtype."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (np.ndarray, np.generic)):
        return (x.dtype.str, x.tolist())
    if isinstance(x, torch.Tensor):
        return ("torch", str(x.dtype), x.device.type, x.tolist())
    return x


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the programs compare the kind
        cause = getattr(e, "cause_cls_name", None)
        return type(e).__name__, cause
    return None


# ------------------------------------------- tests/test_data.py's programs


def range_count_take(rd, tmp):
    ds = rd.range(100, num_blocks=7)
    return ds.num_blocks(), ds.count(), ds.take(5)


def from_items_and_schema(rd, tmp):
    ds = rd.from_items([{"x": i, "y": 2 * i} for i in range(10)],
                       num_blocks=3)
    return {k: v.str for k, v in ds.schema().items()}, ds.count()


def from_numpy_batches(rd, tmp):
    arr = np.random.default_rng(0).normal(size=20).astype(np.float32)
    ds = rd.from_numpy(arr, num_blocks=4)
    return list(ds.iter_batches(batch_size=6, batch_format="numpy"))


def map_filter_flat_map(rd, tmp):
    ds = (rd.range(20, num_blocks=4)
          .map(lambda r: {"id": r["id"] * 10})
          .filter(lambda r: r["id"] % 20 == 0)
          .flat_map(lambda r: [r, r]))
    return ds.take_all()


def map_batches_columnar(rd, tmp):
    ds = rd.range(32, num_blocks=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_size=8)
    return list(ds.iter_batches(batch_size=32))


def map_batches_numpy_format(rd, tmp):
    ds = rd.from_numpy(np.ones(16), num_blocks=2).map_batches(
        lambda a: a * 3.0, batch_format="numpy")
    return list(ds.iter_batches(batch_size=8, batch_format="numpy"))


def limit_pushdown(rd, tmp):
    ds = rd.range(1000, num_blocks=100).limit(5)
    rows = ds.take_all()
    return rows, ds.stats()["tasks"] <= 10


def union_and_shuffle(rd, tmp):
    a = rd.range(10, num_blocks=2).map(lambda r: {"id": r["id"]})
    b = rd.range(10, num_blocks=2).map(lambda r: {"id": r["id"] + 100})
    u = a.union(b)
    sh = rd.range(50, num_blocks=5).random_shuffle(seed=7)
    return u.count(), u.take_all(), sh.take_all()


def repartition(rd, tmp):
    ds = rd.range(30, num_blocks=3).repartition(5)
    return ds.num_blocks(), [len(b["id"]) for b in ds.iter_batches(
        batch_size=7)], ds.take_all()


def iter_batches_exact_sizes(rd, tmp):
    ds = rd.range(25, num_blocks=4)
    return (list(ds.iter_batches(batch_size=8)),
            list(ds.iter_batches(batch_size=8, drop_last=True)))


def iter_jax_batches_pad_and_mask(rd, tmp):
    it = rd.DataIterator(rd.range(25, num_blocks=4))
    return (list(it.iter_jax_batches(batch_size=8)),
            list(it.iter_jax_batches(batch_size=8, pad_last=False,
                                     mask_column="ok")))


def iter_torch_batches_on_the_cpu(rd, tmp):
    x = np.random.default_rng(1).normal(size=10).astype(np.float32)
    ds = rd.from_numpy({"x": x, "i": np.arange(10)})
    it = ds.iterator()
    return (list(it.iter_torch_batches(batch_size=4, device="cpu")),
            list(it.iter_torch_batches(batch_size=4, device="cpu",
                                       dtypes=torch.float64,
                                       drop_last=True)))


def split_disjoint_and_complete(rd, tmp):
    shards = rd.range(40, num_blocks=8).split(3)
    return [(s.num_blocks(), s.take_all()) for s in shards]


def materialize_pins_blocks(rd, tmp):
    mat = rd.range(20, num_blocks=2).map(
        lambda r: {"id": r["id"] + 1}).materialize()
    return mat.count(), mat.take_all()


def read_text_and_json(rd, tmp):
    (tmp / "a.txt").write_text("alpha\nbeta\n")
    (tmp / "b.txt").write_text("gamma\n")
    with open(tmp / "rows.jsonl", "w") as f:
        for i in range(5):
            f.write(json.dumps({"v": i, "s": f"r{i}"}) + "\n")
    return (rd.read_text(str(tmp)).take_all(),
            rd.read_json(str(tmp / "rows.jsonl")).take_all())


def read_npy_and_csv(rd, tmp):
    np.save(tmp / "x.npy", np.arange(6))
    (tmp / "t.csv").write_text("a,b\n1,2\n3,4.5\n")
    return (list(rd.read_npy(str(tmp / "x.npy")).iter_batches(
                batch_size=6, batch_format="numpy")),
            list(rd.read_csv(str(tmp / "t.csv")).iter_batches(
                batch_size=2)))


# ------------------------------ tests/test_data_shuffle.py's programs


def sort_scalars(rd, tmp):
    ds = rd.from_items([5, 3, 8, 1, 9, 2, 7, 4, 6, 0], num_blocks=3)
    return ds.sort().take_all(), ds.sort(descending=True).take_all()


def sort_by_column(rd, tmp):
    rows = [{"k": (7 * i + 3) % 20, "v": i} for i in range(20)]
    return rd.from_items(rows, num_blocks=4).sort(key="k").take_all()


def sort_with_key_fn(rd, tmp):
    ds = rd.from_items(["bbb", "a", "cc", "dddd"], num_blocks=2)
    return ds.sort(key=len).take_all()


def groupby_count_and_sum(rd, tmp):
    ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(12)],
                       num_blocks=4)
    return (ds.groupby("k").count().take_all(),
            ds.groupby("k").sum("v").take_all())


def groupby_multi_aggregate(rd, tmp):
    rows = [{"k": "a" if i < 5 else "b", "v": float(i)} for i in range(10)]
    agg = rd.AggregateFn
    return rd.from_items(rows, num_blocks=3).groupby("k").aggregate(
        agg.mean("v"), agg.min("v"), agg.max("v"), agg.std("v")).take_all()


def groupby_map_groups(rd, tmp):
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(8)],
                       num_blocks=2)
    return ds.groupby("k").map_groups(
        lambda rows: {"k": rows[0]["k"],
                      "vs": sorted(r["v"] for r in rows)}).take_all()


def dataset_level_aggregate(rd, tmp):
    agg = rd.AggregateFn
    return rd.range(100, num_blocks=5).aggregate(agg.sum("id"),
                                                 agg.count())


class AddBias:
    """A stateful UDF constructed once per pool actor."""

    def __init__(self, bias):
        self.bias = bias
        self.calls = 0

    def __call__(self, batch):
        self.calls += 1
        return {"x": batch["x"] + self.bias,
                "calls": np.full(len(batch["x"]), self.calls)}


def map_batches_actor_pool(rd, tmp):
    rows = [{"x": float(i)} for i in range(40)]
    ds = rd.from_items(rows, num_blocks=8).map_batches(
        AddBias, compute=rd.ActorPoolStrategy(size=2),
        fn_constructor_args=(100.0,))
    return ds.take_all()


def actor_pool_then_transform(rd, tmp):
    class Doubler:
        def __call__(self, batch):
            return {"x": batch["x"] * 2}

    ds = (rd.from_items([{"x": float(i)} for i in range(10)], num_blocks=2)
          .map_batches(Doubler, compute=rd.ActorPoolStrategy(size=1))
          .map(lambda r: {"x": r["x"] + 1}))
    return ds.take_all()


# ---------------------------------- tests/test_data_io.py's programs


def zip_dict_blocks(rd, tmp):
    a = rd.from_numpy({"x": np.arange(10)}, num_blocks=3)
    b = rd.from_numpy({"y": np.arange(10) * 2}, num_blocks=2)
    z = a.zip(b)
    return z.num_blocks(), z.take_all()


def zip_column_collisions(rd, tmp):
    a = rd.from_numpy({"x": np.arange(4)})
    b = rd.from_numpy({"x": np.arange(4) + 100})
    c = rd.from_numpy({"x": np.arange(4), "x_1": np.arange(4) + 10})
    return a.zip(b).take_all(), c.zip(b).take_all()


def zip_row_blocks_pairs(rd, tmp):
    return rd.from_items(["a", "b", "c"]).zip(
        rd.from_items([1, 2, 3])).take_all()


def zip_length_mismatch_raises(rd, tmp):
    return raised(lambda: rd.from_items([1, 2]).zip(rd.from_items([1, 2,
                                                                   3])))


def zip_applies_pending_transforms(rd, tmp):
    a = rd.range(6).map(lambda r: {"x": r["id"] * 10})
    b = rd.range(6).filter(lambda r: True)
    return a.zip(b).take_all()


def pandas_roundtrip(rd, tmp):
    import pandas as pd
    df = pd.DataFrame({"a": [1, 2, 3], "b": [4.0, 5.0, 6.0]})
    ds = rd.from_pandas(df, num_blocks=2)
    back = ds.to_pandas()
    return ds.count(), list(back.columns), back.to_dict("list")


def write_json_roundtrip(rd, tmp):
    paths = rd.from_numpy({"v": np.arange(7)}, num_blocks=2).write_json(
        str(tmp / "out"))
    return ([p.rsplit("/", 1)[1] for p in paths],
            rd.read_json([str(tmp / "out")]).take_all())


def write_csv_roundtrip(rd, tmp):
    rd.from_numpy({"a": np.arange(5), "b": np.arange(5) * 1.5}).write_csv(
        str(tmp / "csvs"))
    return rd.read_csv([str(tmp / "csvs")]).take_all()


def write_parquet_roundtrip(rd, tmp):
    paths = rd.from_numpy({"k": np.arange(6)}, num_blocks=2).write_parquet(
        str(tmp / "pq"))
    return len(paths), rd.read_parquet([str(tmp / "pq")]).take_all()


def write_respects_limit(rd, tmp):
    rd.range(100, num_blocks=1).limit(5).write_json(str(tmp / "lim"))
    return rd.read_json([str(tmp / "lim")]).take_all()


def write_npy_tensor_roundtrip(rd, tmp):
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    rd.from_numpy(arr, num_blocks=2).write_npy(str(tmp / "npy"))
    return list(rd.read_npy([str(tmp / "npy")]).iter_batches(
        batch_size=6, batch_format="numpy"))


def write_npy_rejects_tables(rd, tmp):
    return raised(lambda: rd.from_items([{"a": 1}, {"a": 2}]).write_npy(
        str(tmp / "bad")))


PROGRAMS = [
    range_count_take, from_items_and_schema, from_numpy_batches,
    map_filter_flat_map, map_batches_columnar, map_batches_numpy_format,
    limit_pushdown, union_and_shuffle, repartition,
    iter_batches_exact_sizes, iter_jax_batches_pad_and_mask,
    iter_torch_batches_on_the_cpu, split_disjoint_and_complete,
    materialize_pins_blocks, read_text_and_json, read_npy_and_csv,
    sort_scalars, sort_by_column, sort_with_key_fn, groupby_count_and_sum,
    groupby_multi_aggregate, groupby_map_groups, dataset_level_aggregate,
    map_batches_actor_pool, actor_pool_then_transform, zip_dict_blocks,
    zip_column_collisions, zip_row_blocks_pairs, zip_length_mismatch_raises,
    zip_applies_pending_transforms, pandas_roundtrip, write_json_roundtrip,
    write_csv_roundtrip, write_parquet_roundtrip, write_respects_limit,
    write_npy_tensor_roundtrip, write_npy_rejects_tables,
]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_port_data_matches_ray_tpu_data(program, runtimes, tmp_path):
    if program in (pandas_roundtrip,):
        pytest.importorskip("pandas")
    if program in (write_parquet_roundtrip,):
        pytest.importorskip("pyarrow")
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    with collector_paused():
        want = plain(program(jdata, tmp_path / "jax"))
    got = plain(program(tdata, tmp_path / "torch"))
    assert got == want
    assert want not in (None, [], ())


def test_iter_torch_batches_defaults_to_the_card(runtimes, monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without a card, the default raises instead of carrying on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = tdata.from_numpy({"x": np.arange(4.0)}).iterator()
    with pytest.raises(RuntimeError, match="cuda"):
        next(it.iter_torch_batches(batch_size=2))
