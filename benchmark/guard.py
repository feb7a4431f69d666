"""The run-time guards of a benchmark run: a card or nothing, no JAX and no
JAX package in the process, writes only inside the checkout, HOME,
XDG_CACHE_HOME and TMPDIR."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import List

# top-level module names that no run may load: JAX and the JAX package
# (``nightmare_rl_tpu_torch`` begins with the latter's name, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "nightmare_rl_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def cards(chips: int):
    """The card's name, the cards there are, and ``nvidia-smi``'s power
    limit; SystemExit (no result) where CUDA is missing or has fewer cards
    than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card only")
    n = torch.cuda.device_count()
    if n < chips:
        raise SystemExit(f"the cell asks for {chips} cards, {n} are here")
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        limit = [f"nvidia-smi not read: {e}"]
    return torch.cuda.get_device_name(0), n, limit


class WriteGuard:
    """An audit hook that notes every file opened for writing outside the
    checkout, HOME, XDG_CACHE_HOME and TMPDIR; the run reports them and
    fails."""

    def __init__(self, checkout: str):
        roots = [checkout, os.environ.get("HOME"),
                 os.environ.get("XDG_CACHE_HOME"), tempfile.gettempdir()]
        self.roots = [os.path.realpath(r) for r in roots if r]
        self.outside: List[str] = []
        sys.addaudithook(self._hook)

    def _allowed(self, path: str) -> bool:
        real = os.path.realpath(path)
        return real == os.devnull or any(
            real == r or real.startswith(r + os.sep) for r in self.roots)

    def _hook(self, event: str, args) -> None:
        if event != "open" or not isinstance(args[0], (str, bytes)):
            return
        path, mode, flags = args
        writes = (mode is not None and any(c in mode for c in "wax+")) or (
            mode is None and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        if writes:
            path = os.fsdecode(path)
            if not self._allowed(path):
                self.outside.append(path)
