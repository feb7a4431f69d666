# A frozen copy of the port's utils/device.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Device resolution for the port's entry points, and the guard that keeps
float32 work out of TF32."""

from __future__ import annotations

import contextlib
import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  The CPU is reached only when asked for by
    name; a missing card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


# set inside ``tf32()``: the low-precision control, whose products run in
# TF32 where the reference keeps full float32
_CONTROL = [False]


@contextlib.contextmanager
def tf32():
    """The control's precision: TF32 in every float32 product and cuDNN
    call inside the block, ``full_float32`` included.  The previous flags
    are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32, _CONTROL[0]
    cudnn.allow_tf32 = matmul.allow_tf32 = _CONTROL[0] = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, _CONTROL[0] = prev


@contextlib.contextmanager
def full_float32():
    """No TF32 inside the block, whatever the process-wide flags: neither in
    matrix products nor in cuDNN (whose LSTM follows
    ``torch.backends.cudnn.allow_tf32``, True by default).  The flags are
    read when a kernel is chosen, in a backward pass too; the previous
    flags are restored on exit.  Inside ``tf32()`` it leaves them on."""
    if _CONTROL[0]:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once per (values, dtype, device).  A
    tensor built from a Python list inside a step is copied to the card on
    every call, a copy that waits for the card and that a CUDA graph cannot
    capture.  Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
