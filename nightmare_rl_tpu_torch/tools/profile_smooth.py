"""Where the smooth and integrate kernels' time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_smooth [-e 2048]
        [--robot nightmare_v3|anymal_c] [--steps 6] [--timeline]
        [--against DIR]

On the training path's own inputs (the last call of ``smooth_forward`` and
of ``integrate_update`` after ``--steps`` env steps of random actions at
``-e`` envs, float32) it times ``ops/csrc/smooth.cu`` and
``ops/csrc/integrate.cu``, each built here by nvcc with the repo's flags:

- alone: each launch behind a spin kernel and a 256 MiB write that flushes
  the L2 cache, timed by its own pair of CUDA events (as ``chip_smoke.py``'s
  ``_kernel_ms``), the mean over the launches, in µs;
- queued: launches back to back behind a spin kernel, µs per launch (the
  input stays in the L2 cache);
- what ptxas reports for each kernel: registers, stack, spill stores and
  loads, and the envs one SM holds with the launch's geometry.

``--timeline`` builds both kernels with ``-DSMOOTH_TIMELINE``: lane 0 of
each env's warp stamps the card's global timer at the end of each phase of
``smooth_env.cuh``'s ``smooth_one`` (the loads, the body frames per step
of the tree walk: a tree level in the first design, a round of chains since,
the inertial frames, the subtree sums, com and its stores, cinert
and cdof, the velocities, the accelerations, the body forces, the
composite inertias, F with the bias and the actuation, M and qfrc, the
arrow factor, the arrow solve, the final stores) and of ``update_one``
(the shifted matrix and right-hand side, the factor, the solve,
integratePos, the reset and the stores).  It prints each phase's mean and
largest µs over the envs and its µs in the env that took longest, and the
span from the first env's start to the last env's end.

``--against DIR`` (the root of another tree of the port, e.g. a ``git
archive`` of an earlier commit) builds that tree's two kernels from
``DIR/nightmare_rl_tpu_torch/ops/csrc/``, with the plan and the launch
geometry of its own ``ops/smooth.py``, times them the same way and in
turns with this tree's (this, other, other, this), gives their timeline
where its sources have the stamps, and the largest difference between the
two versions' outputs.  The last line is one JSON object with these
numbers and the card's name.  A missing card raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import integrate as IN
from nightmare_rl_tpu_torch.ops import smooth as SM
from nightmare_rl_tpu_torch.tools.profile_pgs import _device_us
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import clone, leaves

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
L2_FLUSH_BYTES = 256 * 2**20
SPIN_CYCLES = 4_000_000
LEVEL_STAMPS = 6          # smooth_env.cuh kStampLevels
SMOOTH_PHASES = (["loads"] + [f"frames step {k}" for k in
                              range(1, LEVEL_STAMPS + 1)]
                 + ["inertial frames", "subtree sums", "com and its stores",
                    "cinert and cdof", "velocities", "accelerations",
                    "body forces", "composite inertias",
                    "F, bias and actuation", "M and qfrc", "arrow factor",
                    "arrow solve", "final stores"])
UPDATE_PHASES = ("shifted matrix and rhs", "factor", "solve", "integratePos",
                 "reset and stores")


def slice_inputs(robot: str, N: int, steps: int, dev: torch.device) -> dict:
    """The System, the layout and the tensor arguments of the last smooth
    and update calls after ``steps`` env steps of random actions."""
    if robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=N), device=dev)
    else:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=N)), device=dev)
    state, _ = env.reset(0)
    g = torch.Generator(device=dev).manual_seed(1)
    last, real = {}, {"smooth": SM.smooth_forward,
                      "update": IN.integrate_update}

    def keeper(key):
        def kept(sys_, lay, *args):
            last[key] = (sys_, lay) + clone(args)
            return real[key](sys_, lay, *args)
        return kept

    SM.smooth_forward, IN.integrate_update = keeper("smooth"), keeper("update")
    try:
        for _ in range(steps):
            act = 0.5 * torch.randn(N, env.num_actions, generator=g, device=dev)
            state = env.step(state, act).state
    finally:
        SM.smooth_forward, IN.integrate_update = real["smooth"], real["update"]
    return last


def _nvcc_lib(src: str, defines: Sequence[str]) -> dict:
    """``src`` built by nvcc with the repo's flags (the kernel's own
    included, and ``-D`` defines) into ``_build/``: the loaded library and
    ptxas's output."""
    name = os.path.splitext(os.path.basename(src))[0]
    flags = build.NVCC_FLAGS + build.KERNEL_FLAGS.get(name, [])
    h = hashlib.sha256(" ".join(list(defines) + flags).encode())
    h.update(build._digest(src).encode() if os.path.dirname(src) ==
             build.CSRC_DIR else _tree_digest(src).encode())
    lib = os.path.join(build.BUILD_DIR,
                       f"lib{name}_profile_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([build._nvcc(), *flags,
                               *(f"-D{d}" for d in defines), "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        with open(lib + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    with open(lib + ".log") as fh:
        log = fh.read()
    return {"lib": ctypes.CDLL(lib), "log": log}


def _tree_digest(src: str) -> str:
    """Hash of a source and of every header beside it."""
    h = hashlib.sha256()
    d = os.path.dirname(src)
    for f in [os.path.basename(src)] + sorted(
            x for x in os.listdir(d) if x.endswith((".cuh", ".h"))):
        with open(os.path.join(d, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def ptxas(log: str) -> List[dict]:
    """Per kernel function of a ptxas ``-v`` log: registers, stack bytes,
    spill stores and loads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    return out


class Version:
    """One tree's smooth and integrate kernels, with the plan and the
    geometry of that tree's ``ops/smooth.py``."""

    def __init__(self, root: str, who: str, defines: Sequence[str] = ()):
        self.who = who
        csrc = os.path.join(root, "nightmare_rl_tpu_torch", "ops", "csrc")
        if os.path.abspath(root) == REPO:
            self.plan = SM
        else:
            spec = importlib.util.spec_from_file_location(
                f"_smooth_plan_{abs(hash(root))}", os.path.join(
                    root, "nightmare_rl_tpu_torch", "ops", "smooth.py"))
            self.plan = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = self.plan  # for its dataclasses
            spec.loader.exec_module(self.plan)
        self.builds = {k: _nvcc_lib(os.path.join(csrc, k + ".cu"), defines)
                       for k in ("smooth", "integrate")}
        self.stamped = "SMOOTH_TIMELINE" in defines
        self._layouts: Dict[tuple, ctypes.Array] = {}

    def layout(self, sys_, lay) -> ctypes.Array:
        key = (id(sys_), id(lay))
        if key not in self._layouts:
            names = self.builds["smooth"]["lib"].smooth_layout_names
            names.restype = ctypes.c_char_p
            keys = [k for k in names().decode().split(",") if k]
            fields = self.plan.model_plan(sys_, lay).fields
            self._layouts[key] = (ctypes.c_int * len(keys))(
                *[fields[k] for k in keys])
        return self._layouts[key]

    def geometry(self, sys_, lay, key: str, itemsize: int, what: str):
        fields = self.plan.model_plan(sys_, lay).fields
        if hasattr(self.plan, "kernel_geometry"):
            return self.plan.kernel_geometry(fields, itemsize, what)
        return self.plan.geometry(fields[key], itemsize, what)

    def smooth(self, sys_, lay, qpos, qvel, ctrl):
        """The smooth kernel's outputs (``SmoothOut``'s leaves)."""
        N, dt = qpos.shape[0], qpos.dtype
        tab = self.plan.tables(sys_, lay, dt, qpos.device)
        outs = self.plan._outputs(sys_, lay, N, dt, qpos.device)
        geo = self.geometry(sys_, lay, "w_elems", qpos.element_size(),
                            "smooth")
        fn = getattr(self.builds["smooth"]["lib"],
                     "smooth_f32" if dt == torch.float32 else "smooth_f64")
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
        lt = self.layout(sys_, lay)
        err = fn(lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
                 qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(), ptrs,
                 len(outs), N, geo.envs_per_block, geo.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.who} smooth kernel: cudaError_t {err}")
        return outs

    def update(self, sys_, lay, qpos, qvel, M, fs, fc, qacc):
        """The integrate kernel's qpos, qvel and qacc_warmstart."""
        N, dt = qpos.shape[0], qpos.dtype
        tab = self.plan.tables(sys_, lay, dt, qpos.device)
        outs = (torch.empty_like(qpos), torch.empty_like(qvel),
                torch.empty_like(qvel))
        geo = self.geometry(sys_, lay, "u_elems", qpos.element_size(),
                            "integrate")
        fn = getattr(self.builds["integrate"]["lib"], "integrate_f32"
                     if dt == torch.float32 else "integrate_f64")
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lt = self.layout(sys_, lay)
        err = fn(lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
                 M.data_ptr(), fs.data_ptr(), fc.data_ptr(), qacc.data_ptr(),
                 qpos.data_ptr(), qvel.data_ptr(),
                 *[o.data_ptr() for o in outs], N, geo.envs_per_block,
                 geo.smem_bytes, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.who} integrate kernel: cudaError_t "
                               f"{err}")
        return outs

    def envs_per_sm(self, sys_, lay, key: str, what: str) -> int:
        geo = self.geometry(sys_, lay, key, 4, what)
        fn = getattr(self.builds[what]["lib"], f"{what}_blocks_per_sm")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        err = fn(4, geo.envs_per_block, geo.smem_bytes, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"{what} occupancy query: cudaError_t {err}")
        return blocks.value * geo.envs_per_block

    def timeline(self, what: str, nenv: int) -> tuple:
        """The last launch's stamps of its first ``nenv`` envs, (nenv,
        stamps): µs from the launch's first stamp, and the SM's cycle
        counter."""
        lib = self.builds[what]["lib"]
        get = getattr(lib, f"{what}_timeline")
        get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        get.restype = ctypes.c_int
        nst = getattr(lib, f"{what}_timeline_stamps")()
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


def alone_us(fn, reps: int = 20) -> float:
    """µs per call, each alone behind a spin kernel and an L2 flush, timed
    by its own pair of CUDA events (chip_smoke.py's ``_kernel_ms``)."""
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = []
    torch.cuda.synchronize()
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps * 1e3


def phases(t: torch.Tensor, cyc: torch.Tensor, names: Sequence[str],
           skip=()) -> dict:
    """Per phase (the time between consecutive stamps): mean and largest µs
    over the envs, and µs in the env whose whole run took longest; the
    span from the first start to the last end; the SM clock (GHz) over the
    envs' runs, from the cycle counter's stamps."""
    d = t[:, 1:] - t[:, :-1]
    whole = t[:, -1] - t[:, 0]
    slow = int(torch.argmax(whole))
    out = {}
    for k, name in enumerate(names):
        if name in skip:
            continue
        out[name] = {"mean_us": float(d[:, k].mean()),
                     "max_us": float(d[:, k].max()),
                     "slowest_env_us": float(d[slow, k])}
    out["env"] = {"mean_us": float(whole.mean()), "max_us": float(whole.max()),
                  "slowest_env_us": float(whole[slow])}
    out["span_us"] = float(t[:, -1].max() - t[:, 0].min())
    out["last_start_us"] = float(t[:, 0].max())
    out["sm_ghz"] = float((cyc[:, -1] - cyc[:, 0]).sum() / whole.sum() / 1e3)
    return out


def _print_phases(label: str, tl: dict) -> None:
    print(f"profile_smooth: timeline of {label} (us, mean / max over envs / "
          f"the slowest env): " + ", ".join(
              f"{k} {v['mean_us']:.2f}/{v['max_us']:.2f}/"
              f"{v['slowest_env_us']:.2f}" for k, v in tl.items()
              if isinstance(v, dict))
          + f"; span {tl['span_us']:.2f}, last env starts at "
          f"{tl['last_start_us']:.2f}; SM clock {tl['sm_ghz']:.3f} GHz")


def measure(ver: Version, kept: dict) -> dict:
    """One version's times, occupancy and ptxas lines."""
    sys_, lay, *sargs = kept["smooth"]
    usys, ulay, *uargs = kept["update"]
    runs = {"smooth": lambda: ver.smooth(sys_, lay, *sargs),
            "integrate": lambda: ver.update(usys, ulay, *uargs)}
    res = {}
    for what, fn in runs.items():
        key = "w_elems" if what == "smooth" else "u_elems"
        s, la = (sys_, lay) if what == "smooth" else (usys, ulay)
        res[what] = {"alone_us": alone_us(fn), "queued_us": _device_us(fn, 50),
                     "envs_per_sm": ver.envs_per_sm(s, la, key, what),
                     "ptxas": ptxas(ver.builds[what]["log"])}
        r = res[what]
        print(f"profile_smooth: {ver.who} {what}: {r['alone_us']:.2f} us alone "
              f"(L2 flushed), {r['queued_us']:.2f} us queued; "
              f"{r['envs_per_sm']} envs an SM; ptxas "
              + "; ".join(f"{p['function']}: {p.get('registers')} registers, "
                          f"stack {p.get('stack')} B, spill "
                          f"{p.get('spill_stores')}/{p.get('spill_loads')} B"
                          for p in r["ptxas"]))
    return res


def timelines(root: str, who: str, kept: dict) -> Optional[dict]:
    """The stamped build's phases of both kernels, or None where the tree's
    sources have no stamps."""
    src = os.path.join(root, "nightmare_rl_tpu_torch", "ops", "csrc",
                       "smooth.cu")
    with open(src) as fh:
        if "SMOOTH_TIMELINE" not in fh.read():
            return None
    ver = Version(root, who, ("SMOOTH_TIMELINE",))
    sys_, lay, *sargs = kept["smooth"]
    usys, ulay, *uargs = kept["update"]
    N = sargs[0].shape[0]
    fields = ver.plan.model_plan(sys_, lay).fields
    steps = fields.get("nround", fields["nlevel"] - 1)
    unused = [f"frames step {k}" for k in range(steps + 1, LEVEL_STAMPS + 1)]
    if lay is None:
        unused += ["arrow factor", "arrow solve", "final stores"]
    out = {}
    for what, fn, names, skip in (
            ("smooth", lambda: ver.smooth(sys_, lay, *sargs), SMOOTH_PHASES,
             unused),
            ("integrate", lambda: ver.update(usys, ulay, *uargs),
             UPDATE_PHASES, ())):
        stamped_us = alone_us(fn)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out[what] = phases(*ver.timeline(what, N), names, skip)
        out[what]["stamped_alone_us"] = stamped_us
        _print_phases(f"{who} {what} (the stamped build: {stamped_us:.2f} us "
                      f"alone)", out[what])
    return out


def max_diff(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    """The largest |a - b| over the finite entries; inf where NaN positions
    differ."""
    worst = 0.0
    for x, y in zip(a, b):
        if not torch.equal(torch.isnan(x), torch.isnan(y)):
            return float("inf")
        fin = torch.isfinite(x) & torch.isfinite(y)
        if bool(fin.any()):
            worst = max(worst, float((x[fin] - y[fin]).abs().max()))
    return worst


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--robot", default="nightmare_v3",
                   choices=("nightmare_v3", "anymal_c"))
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--against", type=str, default=None)
    p.add_argument("--timeline", action="store_true",
                   help="the kernels' phases from their own timer stamps")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    kept = slice_inputs(args.robot, args.envs, args.steps, dev)
    name = torch.cuda.get_device_name(dev)
    res = {"device": name, "robot": args.robot, "envs": args.envs}
    this = Version(REPO, "this")
    res["this"] = measure(this, kept)
    other = None
    if args.against:
        other = Version(os.path.abspath(args.against), "the other")
        res["other"] = measure(other, kept)
    if args.timeline:
        res["timeline"] = {"this": timelines(REPO, "this", kept)}
        if args.against:
            res["timeline"]["other"] = timelines(os.path.abspath(args.against),
                                                 "the other", kept)
    if other is not None:
        sys_, lay, *sargs = kept["smooth"]
        usys, ulay, *uargs = kept["update"]
        turns = {}
        for what, fns in (
                ("smooth", {v.who: (lambda v=v: v.smooth(sys_, lay, *sargs))
                            for v in (this, other)}),
                ("integrate", {v.who: (lambda v=v: v.update(usys, ulay,
                                                            *uargs))
                               for v in (this, other)})):
            t = {"alone_us": {"this": [], "the other": []},
                 "queued_us": {"this": [], "the other": []}}
            for who in ("this", "the other", "the other", "this"):
                t["alone_us"][who].append(alone_us(fns[who]))
                t["queued_us"][who].append(_device_us(fns[who], 50))
            t["max_abs_diff"] = max_diff(leaves(fns["this"]()),
                                         leaves(fns["the other"]()))
            turns[what] = t
            print(f"profile_smooth: {what} in turns (this, other, other, this),"
                  f" alone: " + ", ".join(
                      f"{x:.2f}" for x in (t["alone_us"]["this"][0],
                                           *t["alone_us"]["the other"],
                                           t["alone_us"]["this"][1]))
                  + " us; queued: " + ", ".join(
                      f"{x:.2f}" for x in (t["queued_us"]["this"][0],
                                           *t["queued_us"]["the other"],
                                           t["queued_us"]["this"][1]))
                  + f" us; largest |this - other| {t['max_abs_diff']:.3e}")
        res.update(turns=turns, against=args.against)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
