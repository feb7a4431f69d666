"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone into
``_build/lib<name>_<hash>.so`` (the hash is of the source, so an edited
source builds anew).  The build runs at first use, never at import, and
only where the CUDA toolkit is installed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path, the seconds spent and nvcc's output (ptxas registers,
    shared memory and spills)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    log = lib + ".log"
    if os.path.exists(lib):
        with open(log) as fh:
            return {"path": lib, "seconds": 0.0, "log": fh.read()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    with open(log, "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(build(name)["path"])
