"""Where the PGS kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_pgs [-e 2048]

On random float32 systems at the hexapod's solver shapes (nefc=112, nv=24,
ns_offset=0) it times the kernel for 0 sweeps (staging and prologue only),
1 and 3 main sweeps, and 3 main sweeps + 4 noslip sweeps, at one wave of
envs (as many as the card holds at once) and at ``-e`` envs.  From the
one-wave times it derives the staging + prologue time and the time of one
main-sweep row step and of one noslip pair step.  The last line is one JSON
object with these numbers and the card's name.  A missing card raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.utils.device import resolve_device

NEFC, NV = 112, 24
RUNS = ((0, 0), (1, 0), (3, 0), (3, 4))     # (sweeps, noslip sweeps)


def _system(N: int, dev: torch.device) -> list:
    g = torch.Generator(device=dev).manual_seed(0)
    J = torch.randn(N, NEFC, NV, device=dev, generator=g)
    G = torch.randn(N, NV, NV, device=dev, generator=g)
    U = J @ (G @ G.transpose(1, 2) + 0.1 * torch.eye(NV, device=dev))
    b = 5 * torch.randn(N, NEFC, device=dev, generator=g)
    R = torch.randn(N, NEFC, device=dev, generator=g).abs() + 0.01
    lo = torch.zeros(N, NEFC, device=dev)
    hi = torch.full((N, NEFC), float("inf"), device=dev)
    return [x.contiguous() for x in (J, U, b, R, lo, hi)]


def _device_us(fn, reps: int = 200) -> float:
    """Device microseconds per call.  A spin kernel holds the stream while
    the calls are queued, so the host's time to issue them (the wrapper's
    Python, about as long as a one-wave launch) is left out."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms, longer than the queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")

    geo = P.launch_geometry(NEFC, NV, 4, 0, 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wave = min(P.envs_per_sm(geo, NV, torch.float32) * sms, args.envs)
    system = _system(args.envs, dev)
    times = {}
    for n in sorted({wave, args.envs}):
        a = [x[:n] for x in system]
        for it, ns in RUNS:
            times[f"N{n}_it{it}_ns{ns}_us"] = _device_us(
                lambda: P.pgs(*a, it, ns, 0))
    t = {run: times[f"N{wave}_it{run[0]}_ns{run[1]}_us"] for run in RUNS}
    npairs = NEFC // 2
    result = {
        "device": torch.cuda.get_device_name(dev), "envs": args.envs,
        "wave_envs": wave, "lanes_per_env": geo.lanes,
        "wave_prologue_us": t[0, 0],
        "row_step_ns": (t[3, 0] - t[1, 0]) * 1e3 / (2 * NEFC),
        "pair_step_ns": (t[3, 4] - t[3, 0]) * 1e3 / (4 * npairs),
        **times,
    }
    print(f"profile_pgs: {result['device']}, float32 nefc={NEFC} nv={NV}: "
          f"{wave} envs per wave; per wave: staging + prologue "
          f"{t[0, 0]:.2f} us, main-sweep row step {result['row_step_ns']:.1f} "
          f"ns, noslip pair step {result['pair_step_ns']:.1f} ns; full solve "
          f"(3 + 4 sweeps) at {args.envs} envs "
          f"{times[f'N{args.envs}_it3_ns4_us']:.2f} us")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
