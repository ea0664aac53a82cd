"""WorkerGroup: the actor fleet running train_loop_per_worker — the
PyTorch port of ``ray_tpu/train/worker_group.py`` (reference:
python/ray/train/_internal/worker_group.py:102, and train/v2's health
polling).

Workers are actors of the port's runtime, one rank each; with
``ScalingConfig.use_gpu`` each books ``{"GPU": gpus_per_worker}``, so it
runs in a worker process of its own that sees only its cards. Before the
user loop each joins the run's process group (``train/backend.py``), and
it leaves the group when the loop ends.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.session import TrainContext, _set_context


class WorkerGroupError(RuntimeError):
    def __init__(self, rank: int, cause: BaseException):
        super().__init__(f"train worker {rank} failed: {cause!r}")
        self.rank = rank
        self.cause = cause


class _TrainWorker:
    """Actor body. Runs the user loop under a bound TrainContext."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

    def run(self, fn: Callable, storage_path: str,
            train_loop_config: Optional[dict],
            restore_path: Optional[str],
            ckpt_cfg: Optional[dict] = None,
            dataset_shards: Optional[dict] = None,
            torch_dist: Optional[dict] = None,
            mesh_spec=None,
            restore_fallbacks: tuple = ()) -> List[dict]:
        from ray_tpu_torch.train.backend import (setup_torch_worker,
                                                 teardown_torch_worker)
        if torch_dist is not None:
            # the process group BEFORE the user loop (reference:
            # train/torch/config.py:66 process-group setup)
            setup_torch_worker({**torch_dist, "rank": self.rank,
                                "world_size": self.world_size})
        cc = ckpt_cfg or {}
        # every rank gets a manager over the same root: saves are sharded
        # (each host uploads shard-<rank>.npz; rank 0 commits the manifest)
        manager = CheckpointManager(
            storage_path,
            num_to_keep=cc.get("num_to_keep"),
            rank=self.rank, world_size=self.world_size,
            async_save=bool(cc.get("async_save", False)),
            barrier_timeout_s=float(cc.get("barrier_timeout_s", 60.0)))
        ctx = TrainContext(
            rank=self.rank, world_size=self.world_size,
            storage_path=storage_path,
            ckpt_manager=manager,
            restore_from=(Checkpoint(restore_path,
                                     fallbacks=tuple(restore_fallbacks))
                          if restore_path else None),
            train_loop_config=train_loop_config,
            checkpoint_frequency=int(cc.get("checkpoint_frequency", 0)),
            dataset_shards=dataset_shards,
            mesh_spec=mesh_spec)
        if restore_path:
            # Continue the step numbering of the restored run so restart
            # checkpoints never collide with (or sort below) earlier ones.
            ctx.step = CheckpointManager.step_of(restore_path)
        _set_context(ctx)
        try:
            fn(dict(ctx.train_loop_config)) if _wants_arg(fn) else fn()
            # drain the async writer before declaring the loop done —
            # a save still in flight must commit (or surface its error)
            # before the controller reads latest()
            manager.flush()
            return ctx.reported
        finally:
            _set_context(None)
            manager.flush(raise_errors=False)
            if torch_dist is not None:
                teardown_torch_worker()

    @ray_tpu_torch.method(concurrency_group="control")
    def health_check(self) -> bool:
        # served on the "control" lane so it answers while run() occupies
        # the default lane (reference: train/v2 worker-group health polls)
        return True


def _wants_arg(fn: Callable) -> bool:
    import inspect
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: dict,
                 scaling=None):
        self.num_workers = num_workers
        self.resources = resources_per_worker
        self.scaling = scaling
        self.workers: List[Any] = []

    def _dist_base(self) -> Optional[dict]:
        sc = self.scaling
        if sc is None or not sc.wants_distributed():
            return None
        from ray_tpu_torch.core.worker import LOCAL_MODE, global_worker
        if global_worker.mode == LOCAL_MODE and self.num_workers > 1:
            raise ValueError(
                "a process group of several ranks needs a worker process "
                "per rank: start the cluster runtime (init()), not local "
                "mode")
        coordinator = sc.coordinator_address
        if coordinator is None:
            # free port on this host; fine single-host, override via
            # ScalingConfig.coordinator_address when rank 0 lives elsewhere
            from ray_tpu_torch.runtime.cluster_backend import _free_port
            coordinator = f"127.0.0.1:{_free_port()}"
        return {"coordinator": coordinator, "use_gpu": bool(sc.use_gpu)}

    def start(self) -> None:
        cls = ray_tpu_torch.remote(**{
            "num_cpus": self.resources.get("CPU", 1.0),
            "resources": {k: v for k, v in self.resources.items()
                          if k != "CPU"} or None,
            "concurrency_groups": {"control": 1},
        })(_TrainWorker)
        self.workers = [cls.remote(rank, self.num_workers)
                        for rank in range(self.num_workers)]

    def run(self, fn: Callable, storage_path: str,
            train_loop_config: Optional[dict],
            restore: Optional[Checkpoint],
            ckpt_cfg: Optional[dict] = None,
            datasets: Optional[dict] = None) -> List[List[dict]]:
        """Execute the loop on every worker; raise WorkerGroupError on the
        first failure (reference: backend_executor re-raises worker errors)."""
        # Disjoint per-rank dataset shards (reference: train ingest splits
        # the dataset across workers via streaming_split).
        shards_by_rank: List[Optional[dict]] = [None] * self.num_workers
        if datasets:
            def shard(ds):
                # A rank with zero blocks would starve: a train loop with a
                # per-batch collective (psum over the mesh) hangs when some
                # ranks never enter it. Rebalance into one block per worker
                # before the round-robin split; if the dataset is smaller
                # than the worker count even that leaves an empty shard, so
                # fail loudly instead of hanging the gang.
                if ds.num_blocks() < self.num_workers:
                    if ds.count() < self.num_workers:
                        raise ValueError(
                            f"dataset has fewer rows than num_workers="
                            f"{self.num_workers}; some ranks would starve")
                    ds = ds.repartition(self.num_workers)
                return ds.split(self.num_workers)
            per_name = {name: shard(ds) for name, ds in datasets.items()}
            shards_by_rank = [
                {name: shards[rank] for name, shards in per_name.items()}
                for rank in range(self.num_workers)]
        torch_dist = self._dist_base()
        mesh_spec = getattr(self.scaling, "mesh", None) \
            if self.scaling is not None else None
        refs = [w.run.remote(fn, storage_path, train_loop_config,
                             restore.path if restore else None, ckpt_cfg,
                             shards_by_rank[rank], torch_dist, mesh_spec,
                             tuple(restore.fallbacks) if restore else ())
                for rank, w in enumerate(self.workers)]
        # Await completions in ARRIVAL order, not rank order: a crash on
        # rank>0 must surface even while rank 0 blocks in a collective
        # (reference: backend_executor polls all workers, not worker 0).
        rank_of = {ref: rank for rank, ref in enumerate(refs)}
        results: List[Any] = [None] * len(refs)
        pending = list(refs)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in done:
                rank = rank_of[ref]
                try:
                    results[rank] = ray_tpu_torch.get(ref)
                except Exception as e:  # noqa: BLE001 — worker fault boundary
                    raise WorkerGroupError(rank, e) from e
        return results

    def interrupt(self) -> None:
        """Kill the workers so the in-flight run() raises WorkerGroupError
        — the controller's lever for capacity-gain resizes (the restarted
        group resumes from the latest checkpoint)."""
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — best-effort
                pass

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self.workers = []
