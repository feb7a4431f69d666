"""Raw physics throughput micro-benchmark (port of
``nightmare_rl_tpu/tools/simple_test.py``).

Equivalent of the reference's simple_test.py (threaded mj_step throughput,
simple_test.py:8-47) for the batched pipeline: N lockstep nightmare_v3
envs in float32 with ``max_contacts=16``, zero control, ``-d`` substeps per
call; prints physics substeps/s.  A call of ``-d`` substeps is captured
once as a CUDA graph on the card (``utils/graph.py``) and replayed; one
call warms up, and the timed calls end in ``torch.cuda.synchronize()``.

    python -m nightmare_rl_tpu_torch.tools.simple_test -e 2048 -s 10 -d 4 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.physics import loader, pipeline
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import CapturedStep


def main(argv: Optional[Sequence[str]] = None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--decimation", type=int, default=4)
    p.add_argument("-e", "--env_num", type=int, default=2048)
    p.add_argument("-s", "--num_steps", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    sys_ = S.tree_cast(loader.load_system("nightmare_v3", device=dev),
                       torch.float32)
    sys_ = dataclasses.replace(sys_, max_contacts=16)
    N = args.env_num
    st = pipeline.make_state(sys_, N)
    ctrl = torch.zeros(N, sys_.nu, dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def substeps(st, ctrl):
        return pipeline.step(sys_, st, ctrl, args.decimation)

    step = CapturedStep(substeps, st, ctrl)
    st = step(st, ctrl)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(args.num_steps):
        st = step(st, ctrl)
    sync()
    wall = time.perf_counter() - t0
    rate = N * args.num_steps * args.decimation / wall
    if not torch.isfinite(st.qpos).all():
        raise FloatingPointError("non-finite physics state")
    print(f"{rate} steps per second ({N} envs x {args.num_steps} calls x "
          f"{args.decimation} substeps in {wall:.3f} s on {dev})")
    return rate


if __name__ == "__main__":
    main()
