"""Build the native C++ runtime library (libray_tpu_torch_native.so).

The sources under ``src/`` are the JAX package's, copied: the shared-memory
object store, the resource scheduler and the RPC transport (``transport.cc``
also includes ``<string>``, ``<stdexcept>`` and ``<utility>``, which GCC
13's standard library no longer brings in through the others). The
library goes into ``ray_tpu_torch/_build/`` (git-ignored) beside the CUDA
kernel libraries, never beside the sources. It is built on first use
(``core/_native.py`` and ``runtime/protocol_native.py`` call ``build()``)
under an ``flock``, since several workers may import at once, and rebuilt
when any source is newer than the library. ``python -m
ray_tpu_torch._native.build`` builds it by hand.
"""

from __future__ import annotations

import os
import subprocess
import sys

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_THIS_DIR, "src")
BUILD_DIR = os.path.join(os.path.dirname(_THIS_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libray_tpu_torch_native.so")

SOURCES = [
    "shm_store.cc",
    "scheduler.cc",
    "transport.cc",
]

CXXFLAGS = [
    "-O2",
    "-g",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-Wall",
    "-pthread",
]


def needs_build() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(
        os.path.getmtime(os.path.join(SRC_DIR, s)) > lib_mtime for s in SOURCES
    )


def build(verbose: bool = False) -> str:
    if not needs_build():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    base_cmd = ["g++"] + CXXFLAGS + [os.path.join(SRC_DIR, s) for s in SOURCES]
    if verbose:
        sys.stderr.write(
            " ".join(base_cmd + ["-o", LIB_PATH, "-lrt"]) + "\n")
    # Serialize concurrent builds (several workers may import simultaneously).
    lockfile = LIB_PATH + ".lock"
    import fcntl

    with open(lockfile, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if needs_build():
                tmp = LIB_PATH + f".tmp.{os.getpid()}"
                subprocess.run(base_cmd + ["-o", tmp, "-lrt"], check=True)
                os.replace(tmp, LIB_PATH)
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)
    return LIB_PATH


if __name__ == "__main__":
    build(verbose=True)
    sys.stdout.write(LIB_PATH + "\n")
