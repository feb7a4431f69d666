"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone into
``_build/lib<name>_<hash>.so`` (the hash is of the compiler's flags, of
the source and of the ``csrc/`` headers it includes, transitively, so an
edited source, header or flag rebuilds the kernels that use it and no
other).  The build runs at first use, never at import, and only where the
CUDA toolkit is installed.

``build_host`` compiles a ``csrc/<name>.cpp`` with g++ the same way: the
host driver of a kernel's per-env arithmetic, which the CPU tests run.

Each library compiled in this process counts once in the tracing counter
``build.compiles`` (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

from nightmare_rl_tpu_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# a kernel's own flags: the assemble and task kernels round op for op as
# their plain versions' eager ops do, without contracting multiply-adds, so
# that the assemble kernel's selections agree with the plain version's
# wherever two distances differ, and the task kernels' decisions (resets,
# contacts, command cuts) agree with it exactly
KERNEL_FLAGS = {"assemble": ["-fmad=false"], "task": ["-fmad=false"]}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def _includes(path: str) -> list:
    """The ``csrc/`` headers that ``path`` includes, transitively, in the
    order first met."""
    seen, todo = [], [path]
    while todo:
        with open(todo.pop(0)) as fh:
            names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', fh.read(), re.M)
        for name in names:
            dep = os.path.join(CSRC_DIR, name)
            if os.path.exists(dep) and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _digest(src: str, flags=()) -> str:
    """Hash of the compiler's flags, of a source and of the ``csrc/``
    headers it includes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + _includes(src):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path, the seconds spent and nvcc's output (ptxas registers,
    shared memory and spills)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, [])
    lib = os.path.join(BUILD_DIR, f"lib{name}_{_digest(src, flags)}.so")
    log = lib + ".log"
    if os.path.exists(lib):
        with open(log) as fh:
            return {"path": lib, "seconds": 0.0, "log": fh.read()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    trace.count("build.compiles")
    with open(log, "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return {"path": lib, "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(build(name)["path"])


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with g++ unless its library exists;
    returns its path.  Raises RuntimeError where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found (needed to build the host driver)")
    src = os.path.join(CSRC_DIR, name + ".cpp")
    flags = ["-std=c++17", "-O2", "-pthread", "-shared", "-fPIC"]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{_digest(src, flags)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *flags, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}{proc.stderr}")
    trace.count("build.compiles")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The built host library of ``csrc/<name>.cpp``."""
    return ctypes.CDLL(build_host(name))
