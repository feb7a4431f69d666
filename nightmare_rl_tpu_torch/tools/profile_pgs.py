"""Where a PGS kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_pgs [-e 2048]
        [--form dense|legs]

On random float32 systems at the hexapod's solver shapes (nefc=112, nv=24:
6 legs of 3 dofs, ns_offset=0) it times the dense kernel (``csrc/pgs.cu``)
or the leg-sparse one (``csrc/pgs_legs.cu``, whose prologue builds the G
panels and whose epilogue gives qacc's change) for 0 sweeps (staging,
prologue and epilogue only), 1 and 3 main sweeps, and 3 main sweeps + 4
noslip sweeps, at one wave of envs (as many as the card
holds at once) and at ``-e`` envs.  From the one-wave times it derives the
staging + prologue time and the time of one main-sweep row step and of one
noslip pair step.  The last line is one JSON object with these numbers, the
form and the card's name.  A missing card raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.physics import arrow, solver
from nightmare_rl_tpu_torch.utils.device import resolve_device

NEFC, NV = 112, 24
B, S, NB = 6, 3, 6                          # the hexapod's block-arrow layout
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


def _legs_system(N: int, dev: torch.device) -> list:
    """(lay, fac, J, legmeta, b, R, lo, hi): a random block-arrow factor
    and random slot ids over the same kind of rows."""
    g = torch.Generator(device=dev).manual_seed(1)
    J, _, b, R, lo, hi = _system(N, dev)

    def tril(*shape):
        L = torch.randn(*shape, device=dev, generator=g).tril()
        d = torch.diagonal(L, dim1=-2, dim2=-1)
        d.copy_(d.abs() + 1.0)
        return L.contiguous()

    W = 0.3 * torch.randn(N, B, S, NB, device=dev, generator=g)
    Ld = tril(N, B, S, S)
    fac = arrow.ArrowFac(Ld, W, tril(N, NB, NB), Ld @ W)
    leg1 = torch.randint(0, B, (N, NEFC), device=dev, generator=g,
                         dtype=torch.int32)
    lm = solver.LegMeta(leg1, (leg1 + 1) % B,
                        torch.rand(N, NEFC, device=dev, generator=g) < 0.85,
                        torch.rand(N, NEFC, device=dev, generator=g) < 0.15)
    return [arrow.ArrowLayout(NV, NB, B, S), fac, J, lm, b, R, lo, hi]


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
    p.add_argument("--form", default="dense", choices=("dense", "legs"))
    args = p.parse_args(argv)
    dev = resolve_device("cuda")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.form == "legs":
        geo = P.legs_geometry(NEFC, B, S, NB, 4, 0, 4)
        lanes, per_sm = P.LEG_LANES, P.legs_envs_per_sm(geo, torch.float32)
        system, kernel = _legs_system(args.envs, dev), P.pgs_legs
    else:
        geo = P.launch_geometry(NEFC, NV, 4, 0, 4)
        lanes, per_sm = geo.lanes, P.envs_per_sm(geo, NV, torch.float32)
        system, kernel = _system(args.envs, dev), P.pgs
    wave = min(per_sm * sms, args.envs)

    def first(x, n):
        """The first n envs of a tensor, a factor or a slot assignment."""
        if isinstance(x, torch.Tensor):
            return x[:n]
        if isinstance(x, (arrow.ArrowFac, solver.LegMeta)):
            return type(x)(*(v[:n] for v in x))
        return x

    times = {}
    for n in sorted({wave, args.envs}):
        a = [first(x, n) for x in system]
        for it, ns in RUNS:
            times[f"N{n}_it{it}_ns{ns}_us"] = _device_us(
                lambda: kernel(*a, it, ns, 0))
    t = {run: times[f"N{wave}_it{run[0]}_ns{run[1]}_us"] for run in RUNS}
    npairs = NEFC // 2
    result = {
        "device": torch.cuda.get_device_name(dev), "form": args.form,
        "envs": args.envs, "wave_envs": wave, "lanes_per_env": lanes,
        "wave_prologue_us": t[0, 0],
        "row_step_ns": (t[3, 0] - t[1, 0]) * 1e3 / (2 * NEFC),
        "pair_step_ns": (t[3, 4] - t[3, 0]) * 1e3 / (4 * npairs),
        **times,
    }
    print(f"profile_pgs: {result['device']}, {args.form} form, float32 "
          f"nefc={NEFC} nv={NV}: "
          f"{wave} envs per wave; per wave: staging + prologue "
          f"{t[0, 0]:.2f} us, main-sweep row step {result['row_step_ns']:.1f} "
          f"ns, noslip pair step {result['pair_step_ns']:.1f} ns; full solve "
          f"(3 + 4 sweeps) at {args.envs} envs "
          f"{times[f'N{args.envs}_it3_ns4_us']:.2f} us")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
