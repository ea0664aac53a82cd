"""Job submission: run an entrypoint script under cluster supervision.

Role-equivalent to the reference's job submission stack (reference:
dashboard/modules/job/job_manager.py:59 JobManager spawning a detached
JobSupervisor actor, job_supervisor.py:54 running the entrypoint as a
subprocess): the supervisor actor executes the shell entrypoint with
RTPT_ADDRESS pointing at the cluster, streams status + a bounded log tail
into the head KV, and the client polls KV — so job state survives the
submitting client.

The port of ``ray_tpu/jobs.py``. The entrypoint's environment names the
port's variables, ``RTPT_ADDRESS`` and ``RTPT_JOB_ID`` (the JAX
package's are ``RTPU_*``), so a port job never reaches a JAX cluster's
head. ``init()`` reads no address from the environment: an entrypoint
passes ``os.environ["RTPT_ADDRESS"]`` to ``init(address=...)`` itself.
"""

from __future__ import annotations

import os
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_LOG_TAIL_BYTES = 64 * 1024

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"


class JobSupervisor:
    """Actor body (detached; one per job)."""

    def __init__(self, job_id: str, entrypoint: str,
                 env: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.env = env or {}
        self.working_dir = working_dir

    def _kv_put(self, suffix: str, value: bytes) -> None:
        from ray_tpu_torch.core.worker import global_worker
        global_worker.backend.head.call(
            "kv_put", {"key": f"job:{self.job_id}:{suffix}",
                       "value": value})

    def _set_status(self, status: str, message: str = "") -> None:
        import json
        self._kv_put("status", json.dumps(
            {"status": status, "message": message,
             "ts": time.time()}).encode())

    def run(self) -> str:
        from ray_tpu_torch.core.worker import global_worker
        env = dict(os.environ)
        env.update(self.env)
        env["RTPT_ADDRESS"] = global_worker.backend.head_addr
        env["RTPT_JOB_ID"] = self.job_id
        self._set_status(RUNNING)
        log = b""
        try:
            proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env,
                cwd=self.working_dir or None,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            while True:
                # read1 returns whatever is available (read(4096) would
                # block until 4KB accumulate — logs must stream)
                chunk = proc.stdout.read1(4096)
                if not chunk:
                    break
                log = (log + chunk)[-_LOG_TAIL_BYTES:]
                self._kv_put("logs", log)
            rc = proc.wait()
            self._kv_put("logs", log)
            if rc == 0:
                self._set_status(SUCCEEDED)
                return SUCCEEDED
            self._set_status(FAILED, f"exit code {rc}")
            return FAILED
        except Exception as e:  # noqa: BLE001 — job fault boundary
            self._kv_put("logs", log)
            self._set_status(FAILED, repr(e))
            return FAILED


class JobSubmissionClient:
    """Reference: dashboard job SDK (submit_job/get_job_status/get_job_logs
    over REST); here it speaks the head KV through the connected driver."""

    def __init__(self):
        from ray_tpu_torch.core.worker import require_connected
        self._worker = require_connected()

    def _head(self):
        return self._worker.backend.head

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   env: Optional[Dict[str, str]] = None,
                   working_dir: Optional[str] = None) -> str:
        job_id = submission_id or f"job-{uuid.uuid4().hex[:8]}"
        import json
        self._head().call("kv_put", {
            "key": f"job:{job_id}:status",
            "value": json.dumps({"status": PENDING, "message": "",
                                 "ts": time.time()}).encode()})
        self._head().call("kv_put", {
            "key": f"job:{job_id}:meta",
            "value": json.dumps({"entrypoint": entrypoint,
                                 "submitted_at": time.time()}).encode()})
        sup = ray_tpu_torch.remote(
            name=f"_job_supervisor_{job_id}", namespace="jobs",
            lifetime="detached", max_concurrency=2)(JobSupervisor)
        actor = sup.remote(job_id, entrypoint, env, working_dir)
        actor.run.remote()  # fire; status lands in KV
        return job_id

    def get_job_status(self, job_id: str) -> str:
        import json
        raw = self._head().call("kv_get",
                                {"key": f"job:{job_id}:status"})
        if raw is None:
            raise ValueError(f"unknown job {job_id!r}")
        return json.loads(raw)["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        import json
        raw = self._head().call("kv_get",
                                {"key": f"job:{job_id}:status"})
        meta = self._head().call("kv_get", {"key": f"job:{job_id}:meta"})
        if raw is None:
            raise ValueError(f"unknown job {job_id!r}")
        info = json.loads(raw)
        if meta:
            info.update(json.loads(meta))
        return info

    def get_job_logs(self, job_id: str) -> str:
        raw = self._head().call("kv_get", {"key": f"job:{job_id}:logs"})
        return (raw or b"").decode("utf-8", "replace")

    def list_jobs(self) -> List[Dict[str, Any]]:
        keys = self._head().call("kv_keys", {"prefix": "job:"})
        ids = sorted({k.split(":")[1] for k in keys})
        return [{"job_id": j, **self.get_job_info(j)} for j in ids]

    def wait(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED):
                return status
            time.sleep(0.25)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")
