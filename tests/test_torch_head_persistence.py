"""The port's head KV durability against ray_tpu's: a head started with a
persist path, SIGTERMed, and a new head on the same path serves the
previous KV (actors and leases are process state and do not survive).

The program of ``tests/test_head_persistence.py`` runs against each
package's head (``start_head(..., persist_path=)``, its ``RpcClient``)
and the KV the restarted head serves must be the same in both.
"""

import importlib
import os
import signal
import time

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
KEYS = ("job:j1:status", "cfg", "never")
SERVED = {}


def restarted_kv(pkg, tmp_path):
    """Write, overwrite and delete keys through one head, restart it on the
    same persist path: -> what the new head serves for KEYS."""
    backend = importlib.import_module(f"{pkg}.runtime.cluster_backend")
    protocol = importlib.import_module(f"{pkg}.runtime.protocol")
    persist = str(tmp_path / f"{pkg}-gcs_state.pkl")
    proc, addr = backend.start_head(f"{pkg[-5:]}persistA",
                                    persist_path=persist)
    try:
        c = protocol.RpcClient(addr, name="t")
        c.call("kv_put", {"key": "job:j1:status", "value": b"RUNNING"})
        c.call("kv_put", {"key": "job:j1:status", "value": b"SUCCEEDED"})
        c.call("kv_put", {"key": "cfg", "value": b"v1"})
        c.call("kv_del", {"key": "cfg"})
        # the persist loop runs every 1 s
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not os.path.exists(persist):
            time.sleep(0.2)
        c.close()
    finally:
        os.kill(proc.pid, signal.SIGTERM)
        proc.wait(timeout=10)
    proc2, addr2 = backend.start_head(f"{pkg[-5:]}persistB",
                                      persist_path=persist)
    try:
        c2 = protocol.RpcClient(addr2, name="t2")
        served = {k: c2.call("kv_get", {"key": k}) for k in KEYS}
        c2.close()
    finally:
        os.kill(proc2.pid, signal.SIGTERM)
        proc2.wait(timeout=10)
    return served


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kv_survives_head_restart(pkg, tmp_path):
    SERVED[pkg] = restarted_kv(pkg, tmp_path)
    assert SERVED[pkg] == {"job:j1:status": b"SUCCEEDED", "cfg": None,
                           "never": None}
    if len(SERVED) == len(PACKAGES):
        assert SERVED["ray_tpu"] == SERVED["ray_tpu_torch"]
