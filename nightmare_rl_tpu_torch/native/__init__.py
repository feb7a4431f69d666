"""Native host-side components (C extensions), built at first use.

``_ringlog`` is the mmap trajectory ring buffer behind ``utils/binlog.py``
(the source, ``ringlog.c``, is the port's own copy of the JAX package's).
``get_ringlog()`` compiles it with ``gcc`` into the package's ``_build/``
directory on first use (the file name carries a hash of the source, so an
edited source builds anew) and imports it from there.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")


def build() -> str:
    """Compile ``ringlog.c`` unless its extension exists; returns its path."""
    src = os.path.join(_HERE, "ringlog.c")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"_ringlog_{digest}"
                       + sysconfig.get_config_var("EXT_SUFFIX"))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    include = sysconfig.get_paths()["include"]
    subprocess.check_call(["gcc", "-O2", "-shared", "-fPIC", f"-I{include}",
                           src, "-o", tmp])
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def get_ringlog():
    """The ``_ringlog`` extension module, built first if needed."""
    path = build()
    spec = importlib.util.spec_from_file_location(__name__ + "._ringlog", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
