"""Where the assemble kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_assemble [-e 2048]
        [--robot nightmare_v3|anymal_c] [--steps 6] [--timeline]
        [--against DIR]

On the training path's own inputs (the last call of ``assemble.rows`` after
``--steps`` env steps of random actions at ``-e`` envs, float32, the PGS
in the form the dispatch picks) it times ``ops/csrc/assemble.cu``, built
here by nvcc with the repo's flags (``-fmad=false`` included): alone (each
launch behind a spin kernel and an L2 flush, as ``chip_smoke.py``'s
``_kernel_ms``), queued (back to back), in µs; ptxas's registers, stack
and spills; the envs one SM holds.

``--timeline`` builds it with ``-DASSEMBLE_TIMELINE``: lane 0 of each env's
warp stamps the card's global timer at the end of each phase of
``assemble_env.cuh``'s ``assemble_one`` (the inputs and the candidate
points, the condim-3 ranks, the pairs' per-lane lists, their merge, the
contact slots, J, the rows).  It prints each phase's mean
and largest µs over the envs and its µs in the env that took longest.

``--against DIR`` (the root of another tree of the port that has the
kernel, e.g. a ``git archive`` of a later or earlier commit) builds that
tree's kernel with the plan and the outputs of its own ``ops/assemble.py``,
times it the same way and in turns with this tree's (this, other, other,
this), gives its timeline where its sources have the stamps, and the
largest difference between the two versions' outputs.  The last line is
one JSON object with these numbers and the card's name.  A missing card
raises.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.ops import assemble as AS
from nightmare_rl_tpu_torch.physics import solver
from nightmare_rl_tpu_torch.tools.profile_pgs import _device_us
from nightmare_rl_tpu_torch.tools.profile_smooth import (
    REPO, _nvcc_lib, alone_us, max_diff, phases, ptxas)
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import clone, leaves

PHASES = ("inputs and points", "condim-3 ranks", "pair lists", "pair merge",
          "slots", "J", "rows")


def slice_inputs(robot: str, N: int, steps: int, dev: torch.device) -> tuple:
    """The System, the layout and the tensor arguments of the last
    ``assemble.rows`` call after ``steps`` env steps of random actions."""
    if robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=N), device=dev)
    else:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=N)), device=dev)
    state, _ = env.reset(0)
    g = torch.Generator(device=dev).manual_seed(1)
    last, real = [], AS.rows

    def kept(sys_, lay, *args):
        last[:] = [(sys_, lay) + clone(args)]
        return real(sys_, lay, *args)

    AS.rows = kept
    try:
        for _ in range(steps):
            act = 0.5 * torch.randn(N, env.num_actions, generator=g, device=dev)
            state = env.step(state, act).state
    finally:
        AS.rows = real
    return last[0]


class Version:
    """One tree's assemble kernel, with the plan, tables and outputs of
    that tree's ``ops/assemble.py``."""

    def __init__(self, root: str, who: str, defines: Sequence[str] = ()):
        self.who = who
        if os.path.abspath(root) == REPO:
            self.plan = AS
        else:
            spec = importlib.util.spec_from_file_location(
                f"_assemble_plan_{abs(hash(root))}", os.path.join(
                    root, "nightmare_rl_tpu_torch", "ops", "assemble.py"))
            self.plan = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = self.plan  # for its dataclasses
            spec.loader.exec_module(self.plan)
        self.build = _nvcc_lib(os.path.join(
            root, "nightmare_rl_tpu_torch", "ops", "csrc", "assemble.cu"),
            defines)
        self.lib = self.build["lib"]

    def run(self, sys_, lay, *args) -> list:
        """The kernel's outputs (those the call takes), as ``rows`` makes
        them."""
        P = self.plan
        plan = P.model_plan(sys_, lay)
        dt, dev = args[0].dtype, args[0].device
        geo = P.geometry(plan.fields, args[0].element_size())
        legs = solver.legs_form(sys_, lay, dt, dev)
        o = P._outputs(sys_, plan, args[0].shape[0], dt, dev, legs)
        tab = P.tables(sys_, lay, dt, dev)
        ins, outs = P._pointers(args, o)
        names = self.lib.assemble_layout_names
        names.restype = ctypes.c_char_p
        keys = [k for k in names().decode().split(",") if k]
        lt = (ctypes.c_int * len(keys))(*[plan.fields[k] for k in keys])
        fn = getattr(self.lib, "assemble_f32" if dt == torch.float32
                     else "assemble_f64")
        fn.argtypes = P._ARGTYPES + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
                 tab.pcst.data_ptr(), ins, len(args), outs, len(P.OUTS),
                 args[0].shape[0], geo.envs_per_block, geo.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.who} assemble kernel: cudaError_t "
                               f"{err}")
        return [v for v in o.values() if v is not None]

    def envs_per_sm(self, sys_, lay) -> int:
        geo = self.plan.geometry(self.plan.model_plan(sys_, lay).fields, 4)
        fn = self.lib.assemble_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        err = fn(4, geo.envs_per_block, geo.smem_bytes, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query: cudaError_t {err}")
        return blocks.value * geo.envs_per_block

    def timeline(self, nenv: int) -> tuple:
        """The last launch's stamps of its first ``nenv`` envs: µs from the
        launch's first stamp, and the SM's cycle counter, (nenv, stamps)."""
        get = self.lib.assemble_timeline
        get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        get.restype = ctypes.c_int
        nst = self.lib.assemble_timeline_stamps()
        n = min(nenv, 8192)
        out = []
        for cycles in (0, 1):
            buf = (ctypes.c_longlong * (n * nst))()
            err = get(buf, n * nst, cycles)
            if err != 0:
                raise RuntimeError(f"timeline copy failed: cudaError_t {err}")
            out.append(torch.tensor(list(buf),
                                    dtype=torch.float64).view(n, nst))
        t, c = out
        return (t - t[:, 0].min()) / 1e3, c


def measure(ver: Version, kept: tuple) -> dict:
    sys_, lay, *args = kept
    fn = lambda: ver.run(sys_, lay, *args)  # noqa: E731
    r = {"alone_us": alone_us(fn), "queued_us": _device_us(fn, 50),
         "envs_per_sm": ver.envs_per_sm(sys_, lay),
         "ptxas": ptxas(ver.build["log"])}
    print(f"profile_assemble: {ver.who}: {r['alone_us']:.2f} us alone (L2 "
          f"flushed), {r['queued_us']:.2f} us queued; {r['envs_per_sm']} "
          f"envs an SM; ptxas " + "; ".join(
              f"{p['function']}: {p.get('registers')} registers, stack "
              f"{p.get('stack')} B, spill {p.get('spill_stores')}/"
              f"{p.get('spill_loads')} B" for p in r["ptxas"]))
    return r


def timeline(root: str, who: str, kept: tuple) -> Optional[dict]:
    """The stamped build's phases, or None where the tree's sources have no
    stamps."""
    src = os.path.join(root, "nightmare_rl_tpu_torch", "ops", "csrc",
                       "assemble.cu")
    with open(src) as fh:
        if "ASSEMBLE_TIMELINE" not in fh.read():
            return None
    ver = Version(root, who, ("ASSEMBLE_TIMELINE",))
    sys_, lay, *args = kept
    fn = lambda: ver.run(sys_, lay, *args)  # noqa: E731
    stamped = alone_us(fn)
    fn()
    torch.cuda.synchronize()
    tl = phases(*ver.timeline(args[0].shape[0]), PHASES)
    tl["stamped_alone_us"] = stamped
    print(f"profile_assemble: timeline of {who} (the stamped build: "
          f"{stamped:.2f} us alone; us, mean / max over envs / the slowest "
          f"env): " + ", ".join(
              f"{k} {v['mean_us']:.2f}/{v['max_us']:.2f}/"
              f"{v['slowest_env_us']:.2f}" for k, v in tl.items()
              if isinstance(v, dict))
          + f"; span {tl['span_us']:.2f}, last env starts at "
          f"{tl['last_start_us']:.2f}; SM clock {tl['sm_ghz']:.3f} GHz")
    return tl


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--robot", default="nightmare_v3",
                   choices=("nightmare_v3", "anymal_c"))
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--against", type=str, default=None)
    p.add_argument("--timeline", action="store_true",
                   help="the kernel's phases from its own timer stamps")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    kept = slice_inputs(args.robot, args.envs, args.steps, dev)
    res = {"device": torch.cuda.get_device_name(dev), "robot": args.robot,
           "envs": args.envs}
    this = Version(REPO, "this")
    res["this"] = measure(this, kept)
    vers = [this]
    if args.against:
        vers.append(Version(os.path.abspath(args.against), "the other"))
        res["other"] = measure(vers[1], kept)
    if args.timeline:
        res["timeline"] = {"this": timeline(REPO, "this", kept)}
        if args.against:
            res["timeline"]["other"] = timeline(
                os.path.abspath(args.against), "the other", kept)
    if args.against:
        sys_, lay, *xs = kept
        fns = {v.who: (lambda v=v: v.run(sys_, lay, *xs)) for v in vers}
        t = {"alone_us": {"this": [], "the other": []},
             "queued_us": {"this": [], "the other": []}}
        for who in ("this", "the other", "the other", "this"):
            t["alone_us"][who].append(alone_us(fns[who]))
            t["queued_us"][who].append(_device_us(fns[who], 50))
        t["max_abs_diff"] = max_diff(
            [x.double() for x in leaves(fns["this"]())],
            [x.double() for x in leaves(fns["the other"]())])
        print("profile_assemble: in turns (this, other, other, this), alone: "
              + ", ".join(f"{x:.2f}" for x in (t["alone_us"]["this"][0],
                                               *t["alone_us"]["the other"],
                                               t["alone_us"]["this"][1]))
              + " us; queued: " + ", ".join(
                  f"{x:.2f}" for x in (t["queued_us"]["this"][0],
                                       *t["queued_us"]["the other"],
                                       t["queued_us"]["this"][1]))
              + f" us; largest |this - other| {t['max_abs_diff']:.3e}")
        res.update(turns=t, against=args.against)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
