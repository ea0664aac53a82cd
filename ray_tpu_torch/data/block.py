"""Blocks — the unit of data the streaming executor moves through the store.

The port of ``ray_tpu/data/block.py``, copied as it is. Role-equivalent
to the reference's Block/BlockAccessor (reference:
python/ray/data/block.py:256), columnar-numpy-first: batches come out as
dense ``np.ndarray`` columns with static dtypes, which a training loop
turns into tensors without another conversion. Arrow/pandas interop is
out of scope — numpy is the host-side lingua franca.

A block is one of:
  - ``dict[str, np.ndarray]``  columnar table (canonical form)
  - ``np.ndarray``             single unnamed column (wrapped as {"data": a})
  - ``list``                   rows of arbitrary Python objects
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], np.ndarray, list]

#: metadata travelling beside every block in the owner's memory store so the
#: executor can make flow decisions without fetching block payloads
#: (reference: BlockMetadata in data/block.py).
BlockMeta = Dict[str, Any]  # {"num_rows": int, "size_bytes": int}


def block_meta(block: Block) -> BlockMeta:
    acc = BlockAccessor.for_block(block)
    return {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


class BlockAccessor:
    """Format-generic view over one block."""

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if isinstance(block, dict):
            return _TableAccessor(block)
        if isinstance(block, np.ndarray):
            return _TableAccessor({"data": block})
        if isinstance(block, list):
            return _ListAccessor(block)
        raise TypeError(f"unsupported block type {type(block).__name__}")

    @staticmethod
    def concat(blocks: Sequence[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor.for_block(b).num_rows()]
        if not blocks:
            return []
        first = BlockAccessor.for_block(blocks[0])
        if isinstance(first, _ListAccessor):
            out: list = []
            for b in blocks:
                out.extend(BlockAccessor.for_block(b).to_rows())
            return out
        cols: Dict[str, List[np.ndarray]] = {}
        for b in blocks:
            tbl = BlockAccessor.for_block(b).to_table()
            for k, v in tbl.items():
                cols.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) for k, v in cols.items()}

    @staticmethod
    def from_rows(rows: Sequence[Any]) -> Block:
        """Build a block from rows; dict rows become a columnar table."""
        rows = list(rows)
        if rows and all(isinstance(r, dict) for r in rows):
            keys = rows[0].keys()
            if all(r.keys() == keys for r in rows):
                try:
                    return {k: np.asarray([r[k] for r in rows]) for k in keys}
                except (ValueError, TypeError):
                    return rows
        return rows

    # -- interface -----------------------------------------------------------
    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def to_rows(self) -> list:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        return iter(self.to_rows())

    def to_table(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def to_batch(self, batch_format: str) -> Any:
        """Materialize as a user-facing batch.

        ``"dict"``/``"numpy"`` → dict of numpy columns; ``"rows"`` → list.
        A bare-ndarray block round-trips to the array itself under "numpy"
        (reference's simple-dataset ergonomics).
        """
        if batch_format == "rows":
            return self.to_rows()
        tbl = self.to_table()
        if batch_format == "numpy" and set(tbl) == {"data"}:
            return tbl["data"]
        if batch_format in ("numpy", "dict"):
            return tbl
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def schema(self) -> Any:
        raise NotImplementedError


class _TableAccessor(BlockAccessor):
    def __init__(self, table: Dict[str, np.ndarray]):
        self._t = {k: np.asarray(v) for k, v in table.items()}

    def num_rows(self) -> int:
        if not self._t:
            return 0
        return len(next(iter(self._t.values())))

    def size_bytes(self) -> int:
        return int(sum(v.nbytes for v in self._t.values()))

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._t.items()}

    def to_rows(self) -> list:
        keys = list(self._t)
        n = self.num_rows()
        return [{k: self._t[k][i] for k in keys} for i in range(n)]

    def to_table(self) -> Dict[str, np.ndarray]:
        return dict(self._t)

    def schema(self):
        return {k: v.dtype for k, v in self._t.items()}


class _ListAccessor(BlockAccessor):
    def __init__(self, rows: list):
        self._rows = rows

    def num_rows(self) -> int:
        return len(self._rows)

    def size_bytes(self) -> int:
        # cheap estimate; exact pickled size is not worth computing per block
        return sum(getattr(r, "nbytes", 64) for r in self._rows)

    def slice(self, start: int, end: int) -> Block:
        return self._rows[start:end]

    def to_rows(self) -> list:
        return list(self._rows)

    def to_table(self) -> Dict[str, np.ndarray]:
        b = BlockAccessor.from_rows(self._rows)
        if isinstance(b, dict):
            return b
        try:
            return {"data": np.asarray(self._rows)}
        except (ValueError, TypeError):
            raise TypeError("list block is not convertible to columns; "
                            "use batch_format='rows'") from None

    def schema(self):
        return type(self._rows[0]) if self._rows else None
