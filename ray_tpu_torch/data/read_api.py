"""Dataset constructors.

The port of ``ray_tpu/data/read_api.py``, copied. Role-equivalent to
the reference's read API (reference:
python/ray/data/read_api.py — range :2367, from_items :87, read_* family
over datasource/). Reads are lazy thunks executed inside block tasks, so
file IO happens on workers, parallel across blocks, never in the caller.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from builtins import range as _builtin_range

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, _Plan

_DEFAULT_BLOCK_ROWS = 64 * 1024


def _num_blocks(n_rows: int, override: Optional[int]) -> int:
    if override is not None:
        return max(1, min(override, max(n_rows, 1)))
    return max(1, math.ceil(n_rows / _DEFAULT_BLOCK_ROWS))


def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    """Integers [0, n) as an {"id": int64} table (reference: range())."""
    nb = _num_blocks(n, num_blocks)
    bounds = np.linspace(0, n, nb + 1).astype(np.int64)

    def mk(lo: int, hi: int):
        return lambda: {"id": np.arange(lo, hi, dtype=np.int64)}
    return Dataset(_Plan(read_fns=[
        mk(int(bounds[i]), int(bounds[i + 1])) for i in _builtin_range(nb)]))


def from_items(items: Sequence[Any], *,
               num_blocks: Optional[int] = None) -> Dataset:
    items = list(items)
    nb = _num_blocks(len(items), num_blocks)
    bounds = np.linspace(0, len(items), nb + 1).astype(int)

    def mk(chunk: List[Any]):
        return lambda: BlockAccessor.from_rows(chunk)
    reads = [mk(items[int(bounds[i]):int(bounds[i + 1])])
             for i in _builtin_range(nb)]
    return Dataset(_Plan(read_fns=reads))


def from_pandas(df, *, num_blocks: Optional[int] = None) -> Dataset:
    """Dataset from a pandas DataFrame (reference: data/read_api.py
    from_pandas): columns become the dict-block table."""
    cols = [str(c) for c in df.columns]
    if len(set(cols)) != len(cols):
        # pandas allows duplicate labels; df[c] would then return a 2-D
        # frame and the dict would silently drop all but one column
        raise ValueError(f"from_pandas needs unique column names, got "
                         f"{cols}")
    table = {str(c): df[c].to_numpy() for c in df.columns}
    return from_numpy(table, num_blocks=num_blocks)


def from_numpy(arr: Union[np.ndarray, Dict[str, np.ndarray]], *,
               num_blocks: Optional[int] = None) -> Dataset:
    if isinstance(arr, dict):
        n = len(next(iter(arr.values())))
    else:
        n = len(arr)
    nb = _num_blocks(n, num_blocks)
    bounds = np.linspace(0, n, nb + 1).astype(int)

    # Bind per-block COPIES at construction: a closure over (arr, s, e)
    # would cloudpickle the entire source array into every block task (and
    # every train-worker shard); numpy slices are views whose pickle still
    # serializes only their own elements, but .copy() also releases the
    # base-array reference so the caller can drop `arr`.
    def mk(s: int, e: int):
        if isinstance(arr, dict):
            chunk = {k: v[s:e].copy() for k, v in arr.items()}
            return lambda: chunk
        chunk = arr[s:e].copy()
        return lambda: chunk
    reads = [mk(int(bounds[i]), int(bounds[i + 1]))
             for i in _builtin_range(nb)]
    return Dataset(_Plan(read_fns=reads))


def _expand_paths(paths: Union[str, Sequence[str]], suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(suffix)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no {suffix or 'input'} files under {paths}")
    return out


def read_text(paths: Union[str, Sequence[str]], *,
              suffix: str = ".txt") -> Dataset:
    """One block per file; rows are stripped lines."""
    files = _expand_paths(paths, suffix)

    def mk(path: str):
        def read() -> Block:
            with open(path, "r", encoding="utf-8") as f:
                return [ln.rstrip("\n") for ln in f]
        return read
    return Dataset(_Plan(read_fns=[mk(p) for p in files]))


def read_json(paths: Union[str, Sequence[str]], *,
              suffix: str = ".jsonl") -> Dataset:
    """JSONL files; one block per file, dict rows → columnar when uniform."""
    files = _expand_paths(paths, suffix)

    def mk(path: str):
        def read() -> Block:
            with open(path, "r", encoding="utf-8") as f:
                return BlockAccessor.from_rows(
                    [json.loads(ln) for ln in f if ln.strip()])
        return read
    return Dataset(_Plan(read_fns=[mk(p) for p in files]))


def read_npy(paths: Union[str, Sequence[str]]) -> Dataset:
    """One .npy file per block, zero-copy numpy load on the worker."""
    files = _expand_paths(paths, ".npy")

    def mk(path: str):
        return lambda: np.load(path)
    return Dataset(_Plan(read_fns=[mk(p) for p in files]))


def read_csv(paths: Union[str, Sequence[str]], *,
             suffix: str = ".csv") -> Dataset:
    """Header-row CSVs via numpy; one block per file."""
    files = _expand_paths(paths, suffix)

    def mk(path: str):
        def read() -> Block:
            data = np.genfromtxt(path, delimiter=",", names=True,
                                 dtype=None, encoding="utf-8")
            data = np.atleast_1d(data)  # single-row files come back 0-d
            names = data.dtype.names or ()
            return {n: np.asarray(data[n]) for n in names}
        return read
    return Dataset(_Plan(read_fns=[mk(p) for p in files]))


def read_parquet(paths: Union[str, Sequence[str]]) -> Dataset:
    """Parquet via pyarrow when available (gated: pyarrow is optional)."""
    try:
        import pyarrow.parquet as pq  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_parquet requires pyarrow, which is not installed in this "
            "environment; use read_npy/read_json/read_csv") from e
    files = _expand_paths(paths, ".parquet")

    def mk(path: str):
        def read() -> Block:
            import pyarrow.parquet as pq
            t = pq.read_table(path)
            return {name: t.column(name).to_numpy()
                    for name in t.column_names}
        return read
    return Dataset(_Plan(read_fns=[mk(p) for p in files]))
