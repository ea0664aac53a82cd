"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, on first use, and loaded with
``ctypes``. Libraries go into ``ray_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. ``build()`` starts one ``nvcc`` per
source, all together. Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: kernel library -> (source file, {C entry point: its argtypes}); each
#: entry point returns a cudaError_t code
KERNELS = {
    "ragged_paged_attention": ("ragged_paged_attention.cu", {
        # q_dtype, kv_dtype, q, k_pages, v_pages, k_scale, v_scale,
        # page_table, q_start, q_len, kv_len, out, work, T, R, Hq, Hkv, ps,
        # D, max_pages, decode_rows, q_blocks, pages_per_split, sm_scale,
        # stream
        "ragged_paged_attention": [_I, _I] + [_P] * 11 + [_I] * 10
        + [_F, _P]}),
    "paged_attention": ("paged_attention.cu", {
        # dtype, q, k_pages, v_pages, page_table, seq_lens, out, work, B,
        # P, Hq, Hkv, ps, D, max_pages, pages_per_split, sm_scale, stream
        "paged_attention": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
        # ring::kSlots of paged_ring.cuh (no arguments)
        "paged_decode_stage_slots": []}),
    "flash_attention_fwd": ("flash_attention_fwd.cu", {
        # dtype, q, k, v, o, lse, BH, Lq, Lk, D, causal, sm_scale, stream
        "flash_attention_fwd": [_I] + [_P] * 5 + [_I] * 5 + [_F, _P]}),
    "flash_attention_bwd": ("flash_attention_bwd.cu", {
        # dtype, q, k, v, do, lse, delta, dq, BH, Lq, Lk, D, causal,
        # sm_scale, stream
        "flash_attention_dq": [_I] + [_P] * 7 + [_I] * 5 + [_F, _P],
        # dtype, q, k, v, do, lse, delta, dk, dv, BH, Lq, Lk, D, causal,
        # sm_scale, stream
        "flash_attention_dkv": [_I] + [_P] * 8 + [_I] * 5 + [_F, _P]}),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels build on first use on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """The library's file, named by a hash of its source, the shared
    headers under ``csrc/`` and the flags."""
    src = (CSRC / KERNELS[name][0]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named kernel library that is missing, one ``nvcc``
    per source, all started together. Returns {name: compiler output}
    for the libraries built now (``-Xptxas -v``: registers, shared
    memory, spills). Raises with the compiler's output on failure."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
        logs[name] = log
    return logs


def build_log(name: str) -> str:
    """The compiler output of the library's current build ("" if it was
    not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def launch(name: str, entry: str, device, *args) -> None:
    """Call entry point ``entry`` of kernel library ``name`` on the
    device's current stream, tensors passed as their data pointers (None
    as a null pointer); raise if the launch failed."""
    lib = load(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.kernel_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with the argtypes of
    its entry points declared (pointers as c_void_p, so none is cut)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for entry, argtypes in KERNELS[name][1].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib
