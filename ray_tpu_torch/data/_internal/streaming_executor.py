"""Streaming executor: bounded-in-flight task dispatch over blocks.

The port of ``ray_tpu/data/_internal/streaming_executor.py``, its tasks
on this package's runtime. Role-equivalent to the reference's
StreamingExecutor (reference:
python/ray/data/_internal/execution/streaming_executor.py:48 with
backpressure policies under .../backpressure_policy/), for the common
ingest shape — a linear chain of per-block transforms feeding a device
loop — instead of a general operator DAG:

  - the whole transform chain is FUSED into one task per input block
    (the reference fuses compatible MapOperators the same way), so a block
    crosses the object store exactly twice (produce, consume);
  - backpressure is a sliding in-flight window: at most ``max_in_flight``
    block tasks outstanding, new work submitted only as the consumer drains
    results, so the store holds O(window) blocks, not O(dataset);
  - ordering is preserved: blocks are yielded in plan order so iteration is
    deterministic (needed for resumable training epochs).

Block payloads stay in the object store; only (ref, meta) pairs flow here.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_meta


@ray_tpu_torch.remote(num_returns=2)
def _run_block_task(read_fn: Callable[[], Block],
                    fused: Optional[Callable[[Block, int], Block]],
                    index: int):
    """Produce one block: run the read, then the fused transform chain.

    Returns (block, meta); meta is small and lands in the owner's memory
    store so the caller can count rows without fetching the block.
    """
    block = read_fn()
    if fused is not None:
        block = fused(block, index)
    return block, block_meta(block)


class ExecStats:
    def __init__(self) -> None:
        self.tasks = 0
        self.rows = 0
        self.bytes = 0
        self.wall_s = 0.0

    def summary(self) -> Dict[str, Any]:
        return {"tasks": self.tasks, "rows": self.rows,
                "bytes": self.bytes, "wall_s": round(self.wall_s, 3)}


def execute_streaming(
    read_fns: List[Callable[[], Block]],
    fused: Optional[Callable[[Block], Block]],
    *,
    max_in_flight: int = 8,
    limit_rows: Optional[int] = None,
    stats: Optional[ExecStats] = None,
    ray_remote_args: Optional[Dict[str, Any]] = None,
) -> Iterator[Tuple[ray_tpu_torch.ObjectRef, Dict[str, Any]]]:
    """Yield (block_ref, meta) in plan order with bounded in-flight work.

    ``limit_rows`` stops *submission* once enough rows are known to be in
    flight — the limit pushdown that lets ``ds.limit(5).take()`` touch one
    block of a thousand-block dataset.
    """
    t0 = time.monotonic()
    task = _run_block_task
    if ray_remote_args:
        task = task.options(num_returns=2, **ray_remote_args)
    window: List[Tuple[Any, Any]] = []  # [(block_ref, meta_ref)] in order
    next_read = 0
    produced_rows = 0  # rows confirmed by fetched metas
    in_flight_budget_open = True

    def _submit_until_full() -> None:
        nonlocal next_read, in_flight_budget_open
        while (in_flight_budget_open and len(window) < max_in_flight
               and next_read < len(read_fns)):
            b, m = task.remote(read_fns[next_read], fused, next_read)
            window.append((b, m))
            next_read += 1

    _submit_until_full()
    while window:
        block_ref, meta_ref = window.pop(0)
        meta = ray_tpu_torch.get(meta_ref)
        produced_rows += meta["num_rows"]
        if stats is not None:
            stats.tasks += 1
            stats.rows += meta["num_rows"]
            stats.bytes += meta["size_bytes"]
            stats.wall_s = time.monotonic() - t0
        if limit_rows is not None and produced_rows >= limit_rows:
            in_flight_budget_open = False
        yield block_ref, meta
        if not in_flight_budget_open:
            break
        _submit_until_full()
