"""Where the solve_out kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_solve_out [-e 2048 4096]
        [--steps 30] [--against OTHER.cu]

On the training path's own inputs in each of the solve's forms (the last
call of ``solve_out.outputs`` after ``--steps`` eager env steps of random
actions at each ``-e`` envs, float32: nightmare_v3 in the legs and the
dense PGS form, anymal_c's Newton) it times ``ops/csrc/solve_out.cu``,
built by nvcc with the repo's flags: alone (each launch behind a spin
kernel and an L2 flush, as ``chip_smoke.py``'s ``_kernel_ms``) and queued
(back to back behind a spin kernel, so the host's issue time is left out),
in µs; ptxas's registers, stack and spills; the launch geometry.

``--against OTHER.cu`` builds another version of the kernel's source (with
this one's C interface and the headers beside it, e.g. an earlier design
kept in a git-ignored directory), times it the same way in turns with this
tree's (this, other, other, this), and gives the largest difference
between the two versions' outputs.  The last line is one JSON object with
these numbers and the card's name.  A missing card raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import solve_out as SO
from nightmare_rl_tpu_torch.tools.profile_pgs import _device_us
from nightmare_rl_tpu_torch.tools.profile_smooth import (
    _nvcc_lib, alone_us, max_diff, ptxas)
from nightmare_rl_tpu_torch.utils.device import full_float32, resolve_device

# (robot, NIGHTMARE_PGS, the form's name): the solve's three forms
CASES = (("nightmare_v3", "legs", "legs"), ("nightmare_v3", "kernel", "dense"),
         ("anymal_c", None, "newton"))


def slice_inputs(robot: str, pgs: Optional[str], N: int, steps: int,
                 dev: torch.device) -> tuple:
    """The arguments of the last ``outputs`` call after ``steps`` env steps
    of random actions from the reset, with NIGHTMARE_PGS set to ``pgs``."""
    prev = os.environ.pop("NIGHTMARE_PGS", None)
    if pgs is not None:
        os.environ["NIGHTMARE_PGS"] = pgs
    last, real = {}, SO.outputs

    def kept(*args):
        last["args"] = args
        return real(*args)

    SO.outputs = kept
    try:
        if robot == "anymal_c":
            env = AnymalCEnv(AnymalCCfg(num_envs=N), device=dev)
        else:
            env = NightmareV3Env(NightmareV3Cfg().replace(
                env=EnvCfg(num_envs=N)), device=dev)
        state, _ = env.reset(0)
        g = torch.Generator(device=dev).manual_seed(21)
        for _ in range(steps):
            state = env.step(state, 0.3 * torch.randn(
                N, env.num_actions, device=dev, generator=g)).state
    finally:
        SO.outputs = real
        os.environ.pop("NIGHTMARE_PGS", None)
        if prev is not None:
            os.environ["NIGHTMARE_PGS"] = prev
    return last["args"]


class Version:
    """A build of a solve_out source with this tree's C interface."""

    def __init__(self, src: str, who: str):
        self.who = who
        self.build = _nvcc_lib(src, ())
        self.fn = self.build["lib"].solve_out_f32
        self.fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def caller(self, args):
        """A call of the kernel on ``args`` into fresh outputs (the
        operands' checks and allocations made once, outside the call)."""
        p, geo, ins, outs, out = SO._operands(*args)
        names = SO._names(False)
        params = (ctypes.c_int * len(names))(*[p[k] for k in names])
        outs = [None if x is None else torch.empty_like(x) for x in outs]
        pin, pout = SO._pointers(ins), SO._pointers(outs)
        N = args[5].shape[0]

        def call():
            err = self.fn(params, len(names), pin, len(ins), pout, len(outs),
                          N, geo.envs_per_block, geo.smem_bytes,
                          torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{self.who} solve_out kernel: "
                                   f"cudaError_t {err}")
            return [x for x in outs if x is not None]

        return call, geo


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, nargs="+", default=[2048, 4096])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--against", type=str, default=None)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    this = Version(os.path.join(build.CSRC_DIR, "solve_out.cu"), "this")
    vers = [this]
    if args.against:
        vers.append(Version(os.path.abspath(args.against), "the other"))
    res = {"device": torch.cuda.get_device_name(dev),
           "ptxas": {v.who: ptxas(v.build["log"]) for v in vers}, "runs": []}
    print("profile_solve_out: ptxas " + "; ".join(
        f"{v.who}: " + ", ".join(
            f"{q['function']} {q.get('registers')} registers, stack "
            f"{q.get('stack')} B, spill {q.get('spill_stores')}/"
            f"{q.get('spill_loads')} B" for q in res["ptxas"][v.who])
        for v in vers))
    for robot, pgs, form in CASES:
        for N in args.envs:
            kept = slice_inputs(robot, pgs, N, args.steps, dev)
            with full_float32():
                calls = {v.who: v.caller(kept) for v in vers}
                geo = calls["this"][1]
                t = {"alone_us": {v.who: [] for v in vers},
                     "queued_us": {v.who: [] for v in vers}}
                order = (["this", "the other", "the other", "this"]
                         if args.against else ["this"])
                for who in order:
                    t["alone_us"][who].append(alone_us(calls[who][0]))
                    t["queued_us"][who].append(_device_us(calls[who][0], 50))
                if args.against:
                    t["max_abs_diff"] = max_diff(calls["this"][0](),
                                                 calls["the other"][0]())
            run = dict(robot=robot, form=form, envs=N,
                       envs_per_block=geo.envs_per_block,
                       smem_bytes=geo.smem_bytes, **t)
            res["runs"].append(run)
            print(f"profile_solve_out: {robot} {form} {N} envs, "
                  f"{geo.envs_per_block} envs a block, {geo.smem_bytes} B "
                  f"shared: " + "; ".join(
                      f"{who} alone " + ", ".join(
                          f"{x:.2f}" for x in t["alone_us"][who])
                      + " us, queued " + ", ".join(
                          f"{x:.2f}" for x in t["queued_us"][who]) + " us"
                      for who in t["alone_us"])
                  + (f"; largest |this - other| {t['max_abs_diff']:.3e}"
                     if args.against else ""))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
