"""chip_smoke.py's phase 19 (the operations surface) at a small size on
the CPU: a multi-node ``Cluster`` whose node B is told of one card, a job
whose entrypoint serves phase 4's requests from the server placed in a
``{"GPU": 1, "CPU": 1}`` bundle (its streams must equal the same requests
served in this process), the CLI, dashboard and ``/metrics`` against it,
the group's removal ending the worker, then the autoscaler launching the
GPU node type for a pending bundle and draining it, then (19f) the
Compute Engine provider over a fake API whose inserted instance runs its
own startup script as a local process: the stand-in VM's PATH holds an
``nvidia-smi`` that names an H100, so its daemon advertises
``GPU-H100``."""

import os
import sys
from pathlib import Path

import ray_tpu_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MODEL = {"preset": "tiny", "n_layers": 2, "dtype": "float32"}


#: what ``nvidia-smi --query-gpu=name --format=csv,noheader -i 0`` prints
#: on one card of an A3 VM
NVIDIA_SMI = '#!/bin/sh\necho "NVIDIA H100 80GB HBM3"\n'


def test_chip_smoke_operations_phase_on_the_cpu(tmp_path):
    engine = dict(chip_smoke.MAIN_ENGINE, device="cpu")
    here = chip_smoke.MainServer(MODEL, engine)
    try:
        streams = here.answer()
    finally:
        here.srv.shutdown()
    smi = tmp_path / "nvidia-smi"
    smi.write_text(NVIDIA_SMI)
    os.chmod(smi, 0o755)
    out = chip_smoke.phase_operations(MODEL, engine, main_streams=streams,
                                      autoscale_model=MODEL,
                                      stand_in_path=[tmp_path])
    # CPU tensors run the plain version: the engine counted its steps, no
    # kernel was launched
    assert out["job_expected"] > 0 and out["launches"] == 0
    assert set(out["cli_s"]) == {"status", "list nodes", "list actors",
                                 "top", "requests", "trace", "logs"}
    assert out["drain_s"] > 0
    assert out["gce_launches"] == 0
    assert 0 < out["gce_up_s"] < out["gce_s"]
    assert out["gce_drain_s"] > 0
    assert not ray_tpu_torch.is_initialized()
