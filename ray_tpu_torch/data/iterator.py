"""DataIterator — the train-worker-facing view of a dataset shard.

The port of ``ray_tpu/data/iterator.py``. Role-equivalent to the
reference's DataIterator (reference: python/ray/data/iterator.py, surfaced
in train via session.get_dataset_shard). ``iter_jax_batches`` pads the
trailing partial batch to the full batch_size (mask column supplied) so a
step sees one static shape for the whole epoch; it returns numpy, imports
nothing of JAX, and keeps its name so that callers of the reference find
it. ``iter_torch_batches`` puts numeric columns on the card unless the
caller asks for another device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.dataset import Dataset


class DataIterator:
    def __init__(self, dataset: Dataset):
        self._ds = dataset

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "dict",
                     drop_last: bool = False) -> Iterator[Any]:
        return self._ds.iter_batches(batch_size=batch_size,
                                     batch_format=batch_format,
                                     drop_last=drop_last)

    def iter_rows(self) -> Iterator[Any]:
        return self._ds.iter_rows()

    def iter_jax_batches(self, *, batch_size: int = 256,
                         pad_last: bool = True,
                         mask_column: str = "__valid__",
                         ) -> Iterator[Dict[str, np.ndarray]]:
        """Dict-of-numpy batches with a guaranteed static leading dim.

        The final partial batch is zero-padded to ``batch_size`` and a
        boolean ``mask_column`` marks real rows — one static shape for the
        whole epoch, the ragged tail included.
        """
        for batch in self._ds.iter_batches(batch_size=batch_size,
                                           batch_format="dict",
                                           drop_last=False):
            n = len(next(iter(batch.values()))) if batch else 0
            if n == 0:
                continue
            if n == batch_size or not pad_last:
                # mask present on EVERY batch (also the unpadded tail) so
                # the epoch yields one consistent pytree structure
                batch = dict(batch)
                batch[mask_column] = np.ones(n, dtype=bool)
                yield batch
                continue
            padded: Dict[str, np.ndarray] = {}
            for k, v in batch.items():
                pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
                padded[k] = np.pad(v, pad_width)
            mask = np.zeros(batch_size, dtype=bool)
            mask[:n] = True
            padded[mask_column] = mask
            yield padded

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device="cuda",
                           drop_last: bool = False) -> Iterator[Any]:
        """Dict-of-torch-tensor batches (reference: data/iterator.py
        iter_torch_batches). Numeric columns convert zero-copy via
        torch.from_numpy and go to ``device`` — the card unless the caller
        asks for the CPU, which raises where there is no card; others
        stay as they are."""
        import torch

        from ray_tpu_torch.models.llama import resolve_device
        device = resolve_device(device)

        def to_tensor(v):
            if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
                arr = np.ascontiguousarray(v)
                if not arr.flags.writeable:
                    # torch.from_numpy warns on (and can't track) read-
                    # only arrays, e.g. zero-copy views out of shm
                    arr = arr.copy()
                t = torch.from_numpy(arr)
                if dtypes is not None:
                    t = t.to(dtypes)
                return t.to(device)
            return v
        for batch in self._ds.iter_batches(batch_size=batch_size,
                                           batch_format="dict",
                                           drop_last=drop_last):
            yield {k: to_tensor(v) for k, v in batch.items()}

    def materialize(self) -> Dataset:
        return self._ds.materialize()

    def count(self) -> int:
        return self._ds.count()

    def __repr__(self) -> str:
        return f"DataIterator({self._ds!r})"
