"""Tensors across the port's processes, and its own native library.

Every ``torch.Tensor``, at any depth of a value, crosses as host memory
and arrives as a CPU tensor of the same dtype, shape and bytes: through
``put``/``get`` (the driver's store and a worker's read), as task
arguments and as task returns, nested in containers. A large tensor rides
out of band into the shm store. The port's ``_native`` library is built
from its own sources into ``ray_tpu_torch/_build/``; one store is
written by one process and read by another, as
``tests/test_native_store.py`` does for the JAX package's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.worker import global_worker

ROOT = Path(__file__).resolve().parents[1]


def _bytes(t):
    """The tensor's bytes in row-major order, as a numpy uint8 array."""
    t = t.detach().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().copy() if t.numel() else \
        np.zeros(0, np.uint8)


def _same(a, b):
    return (isinstance(b, torch.Tensor) and b.device.type == "cpu"
            and a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
            and np.array_equal(_bytes(a), _bytes(b)))


def _cases():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=g)
    return {
        "fp32": base,
        "bf16": base.to(torch.bfloat16),
        "int8": torch.randint(-128, 127, (5, 7), generator=g,
                              dtype=torch.int8),
        "bool": torch.rand(9, generator=g) > 0.5,
        "strided": base.t()[::2],          # a non-contiguous view
        "scalar": torch.tensor(3.25),      # 0-d
        "empty": torch.zeros(0, 4),
    }


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 256 * 1024 * 1024,
        "worker_pool_max": 4,
    })
    yield rt
    rt.shutdown()


# -------------------------------------------------------- serialization


@pytest.mark.parametrize("name", list(_cases()))
def test_serialize_roundtrip_bytes(name):
    t = _cases()[name]
    so = serialization.serialize({"x": [t]})
    back = serialization.deserialize(bytearray(so.to_bytes()))["x"][0]
    assert _same(t, back)


def test_parameter_and_grad_flag_survive():
    p = torch.nn.Parameter(torch.ones(3))
    leaf = torch.ones(2, requires_grad=True)
    out = serialization.deserialize(bytearray(
        serialization.serialize((p, leaf, leaf * 2)).to_bytes()))
    assert type(out[0]) is torch.nn.Parameter and out[0].requires_grad
    assert out[1].requires_grad and not out[2].requires_grad


def test_tensor_bytes_ride_out_of_band():
    t = torch.arange(1 << 20, dtype=torch.float32)
    so = serialization.serialize({"t": t})
    assert len(so.buffers) == 1 and so.buffers[0].raw().nbytes == t.nbytes
    assert len(so.inband) < 4096


def test_serialization_never_imports_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from ray_tpu_torch.core import serialization as s\n"
         "v = s.deserialize(s.serialize({'a': [1, 2.0, 'x']}).to_bytes())\n"
         "assert v == {'a': [1, 2.0, 'x']}\n"
         "print('torch' in sys.modules)\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------ across processes


def test_put_get_nested_tensors(cluster):
    cases = _cases()
    ref = rt.put({"nested": [cases, (cases["bf16"],)]})
    back = rt.get(ref, timeout=60)
    for k, t in cases.items():
        assert _same(t, back["nested"][0][k]), k
    assert _same(cases["bf16"], back["nested"][1][0])


def test_tensors_as_task_args_and_returns(cluster):
    @rt.remote
    def echo(d):
        import torch as th
        assert all(isinstance(v, th.Tensor) and v.device.type == "cpu"
                   for v in d.values())
        return {"back": d, "pid": os.getpid()}

    cases = _cases()
    out = rt.get(echo.remote(cases), timeout=120)
    assert out["pid"] != os.getpid()
    for k, t in cases.items():
        assert _same(t, out["back"][k]), k


def test_put_ref_read_in_a_worker(cluster):
    @rt.remote
    def digest(refs):
        import hashlib
        t = rt.get(refs[0], timeout=60)
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return str(t.dtype), tuple(t.shape), hashlib.sha256(
            raw.tobytes()).hexdigest()

    import hashlib
    t = _cases()["bf16"]
    ref = rt.put(t)
    dtype, shape, h = rt.get(digest.remote([ref]), timeout=120)
    assert (dtype, shape) == (str(t.dtype), tuple(t.shape))
    assert h == hashlib.sha256(_bytes(t).tobytes()).hexdigest()


def test_large_tensor_through_shm(cluster):
    """A 64 MB tensor: put seals it in the shm store, a worker's return of
    it is sealed there too, and both read back byte for byte."""
    t = torch.randn(16 << 20, generator=torch.Generator().manual_seed(1))
    assert t.nbytes == 64 << 20
    ref = rt.put(t)
    store = global_worker.backend.object_plane.store
    assert store.contains(ref.id().binary())
    assert _same(t, rt.get(ref, timeout=60))

    @rt.remote
    def twice(x):
        return {"y": x * 2}

    out_ref = twice.remote(ref)
    out = rt.get(out_ref, timeout=120)
    assert store.contains(out_ref.id().binary())
    assert _same(t * 2, out["y"])


# ------------------------------------------------------- native library


def test_native_library_is_the_ports_own():
    from ray_tpu_torch._native import build
    path = build.build()
    assert Path(path) == ROOT / "ray_tpu_torch" / "_build" / \
        "libray_tpu_torch_native.so"
    assert Path(build.SRC_DIR) == ROOT / "ray_tpu_torch" / "_native" / "src"
    assert not any(Path(build.SRC_DIR).glob("*.so"))


def test_store_written_by_one_process_read_by_another():
    from ray_tpu_torch.core._native import ShmStore
    name = f"/rtpt_test_{os.getpid()}"
    store = ShmStore.create(name, 8 * 1024 * 1024, slots=1024)
    try:
        store.put(b"a" * 28, b"from-parent" * 100)
        code = (
            "import sys\n"
            "from ray_tpu_torch.core._native import ShmStore\n"
            f"s = ShmStore.attach({name!r})\n"
            "v = s.get(b'a' * 28)\n"
            "assert bytes(v[:11]) == b'from-parent'\n"
            "s.release(b'a' * 28)\n"
            "s.put(b'b' * 28, b'from-child')\n"
            "s.release(b'b' * 28)\n"
            "s.close()\n"
            "print('torch' in sys.modules)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "False"
        view = store.get(b"b" * 28)
        assert bytes(view[:10]) == b"from-child"
        store.release(b"b" * 28)
    finally:
        store.close()
        ShmStore.attach(name).unlink()
