"""ray_tpu_torch.data — streaming, block-partitioned datasets.

The port of ``ray_tpu/data``, which imports no JAX and is copied with its
imports pointed at this package: a linear fused block pipeline with
numpy-columnar blocks and static-shape batch iteration (reference:
python/ray/data — Dataset at dataset.py:153, StreamingExecutor at
_internal/execution/streaming_executor.py:48), run on this package's
local-mode runtime (``ray_tpu_torch.init(local_mode=True)``).
``iter_torch_batches`` puts numeric columns on the card unless the
caller asks for the CPU, as the package's other entry points do.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset,
                                  GroupedData, MaterializedDataset)
from ray_tpu_torch.data._internal.shuffle import AggregateFn
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_items, from_numpy, from_pandas, range, read_csv, read_json,
    read_npy, read_parquet, read_text)

__all__ = [
    "ActorPoolStrategy", "AggregateFn", "GroupedData",
    "Block", "BlockAccessor", "Dataset", "MaterializedDataset",
    "DataIterator", "from_items", "from_numpy", "from_pandas", "range",
    "read_csv", "read_json", "read_npy", "read_parquet", "read_text",
]
