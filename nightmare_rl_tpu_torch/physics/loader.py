"""Read a compiled System archive (npz), the runtime half of
``nightmare_rl_tpu/physics/loader.py`` (``load_system``).

The archive holds a JSON ``__static__`` blob (sizes, topology, options) and
one array per numeric field.  The MJCF compiler that writes it is not part
of the port.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import resolve_device

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")

# fields that the archive stores as arrays but the System keeps as ints
_INT_OPTIONS = ("max_pair_contacts",)


def load_system(path_or_name: str, dtype: torch.dtype = torch.float64,
                device=None) -> S.System:
    """Load a compiled System from npz (by path or bundled asset name) onto
    ``device`` (the card unless ``"cpu"`` is asked for), floats as dtype."""
    dev = resolve_device(device)
    path = path_or_name
    if not os.path.exists(path):
        path = os.path.join(_ASSET_DIR, path_or_name + ".npz")
    with open(path, "rb") as fh:
        data = np.load(io.BytesIO(fh.read()))
    static = json.loads(bytes(data["__static__"]).decode())
    kwargs = {}
    for k, v in static.items():
        kwargs[k] = v if isinstance(v, (int, float)) else tuple(v)
    for k in data.files:
        if k == "__static__":
            continue
        arr = data[k]
        if k in _INT_OPTIONS:
            kwargs[k] = int(arr)
        elif np.issubdtype(arr.dtype, np.floating):
            kwargs[k] = torch.as_tensor(arr, dtype=dtype, device=dev)
        elif arr.dtype == np.bool_:
            kwargs[k] = torch.as_tensor(arr, device=dev)
        else:
            kwargs[k] = torch.as_tensor(arr.astype(np.int64), device=dev)
    return S.System(**kwargs)
