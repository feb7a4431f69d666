"""Where a PGS kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_pgs [-e 2048]
        [--form dense|legs] [--timeline]

On random float32 systems at the hexapod's solver shapes (nefc=112, nv=24:
6 legs of 3 dofs, ns_offset=0) it times the dense kernel (``csrc/pgs.cu``)
or the leg-sparse one (``csrc/pgs_legs.cu``, whose prologue builds the G
panels and whose epilogue gives qacc's change) for 0 sweeps (staging,
prologue and epilogue only), 1 and 3 main sweeps, and 3 main sweeps + 4
noslip sweeps, at one wave of envs (as many as the card
holds at once) and at ``-e`` envs.  Every row of these systems is active
(lo = 0, hi = inf), so the legs kernel visits them all.  From the one-wave
times it derives the staging + prologue time and the time of one
main-sweep row step and of one noslip pair step.

The legs form also times a full solve at ``-e`` envs where only the main
path's share of the contact pairs is active (ACTIVE; the rest pinned, lo =
hi = 0, as inactive contacts are), and prints the rows and pairs its
kernel then sweeps (``list_lengths``).  ``--timeline`` builds the legs
kernel with ``-DPGS_LEGS_TIMELINE``, whose lane 0 of each block stamps the
card's global timer at the ends of its phases (staging rounds 1 and 2, the
factor, the rows and their list, the pairs and theirs, the sweeps, the
epilogue), and reports each phase's mean and largest time over the blocks
for 0 sweeps and for 3 + 4 sweeps on both systems.  The last line is one
JSON object with these numbers, the form and the card's name.  A missing
card raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.physics import arrow, solver
from nightmare_rl_tpu_torch.utils.device import resolve_device

NEFC, NV = 112, 24
B, S, NB = 6, 3, 6                          # the hexapod's block-arrow layout
RUNS = ((0, 0), (1, 0), (3, 0), (3, 4))     # (sweeps, noslip sweeps)
ACTIVE = 0.101      # share of active rows on the main path (PERF.md §6)


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


def pin_pairs(lo: torch.Tensor, hi: torch.Tensor, active: float,
              seed: int = 2) -> tuple:
    """(lo, hi) with all but a share ``active`` of each env's facet pairs
    (rows 2p, 2p+1) pinned, lo = hi = 0, as an inactive contact's rows
    are; the others active (hi = inf where it was 0)."""
    lo, hi = lo.clone(), hi.clone()
    N, nefc = lo.shape
    g = torch.Generator(device=lo.device).manual_seed(seed)
    off = (torch.rand(N, (nefc + 1) // 2, device=lo.device, generator=g)
           >= active).repeat_interleave(2, dim=1)[:, :nefc]
    hi[(hi == 0) & ~off] = float("inf")
    lo[off] = 0.0
    hi[off] = 0.0
    return lo, hi


def list_lengths(lo: torch.Tensor, hi: torch.Tensor, ns_offset: int,
                 noslip: int = 4, envs_per_warp: int = 4) -> dict:
    """The rows and pairs that the legs kernel sweeps on these bounds (finite
    inputs): per env, the rows that are not pinned (lo == hi == 0) and the
    pairs with hi[i] > 0; per warp of ``envs_per_warp`` consecutive envs
    the longest of each, which it walks.  Mean, p50, p99 and max over envs
    and over warps."""
    N, nefc = lo.shape
    rows = (~((lo == 0) & (hi == 0))).sum(1).double()
    npairs = (nefc - ns_offset) // 2 if noslip > 0 else 0
    idx = ns_offset + 2 * torch.arange(npairs, device=hi.device)
    pairs = (hi[:, idx] > 0).sum(1).double()

    def stats(x):
        q = torch.quantile(x, torch.tensor([0.5, 0.99], dtype=x.dtype,
                                            device=x.device))
        return dict(mean=float(x.mean()), p50=float(q[0]), p99=float(q[1]),
                    max=float(x.max()))

    pad = (-N) % envs_per_warp

    def per_warp(x):
        return torch.cat([x, x.new_zeros(pad)]).view(-1, envs_per_warp).amax(1)

    return dict(nefc=nefc, npairs=npairs, env_rows=stats(rows),
                env_pairs=stats(pairs), warp_rows=stats(per_warp(rows)),
                warp_pairs=stats(per_warp(pairs)))


def _build_other(src: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """A legs kernel source built by nvcc with the repo's flags (and
    ``-D`` defines) into ``_build/``, loaded."""
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(defines).encode()).hexdigest()[:16]
    lib = os.path.join(build.BUILD_DIR, f"libother_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                               *(f"-D{d}" for d in defines), "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


def load_other(src: str, defines: Sequence[str] = ()):
    """``pgs_legs_f32`` of another build of the legs kernel (another
    version's source, as ``chip_smoke.py`` times in turns, or this one's
    with ``-D`` defines); it takes the same arguments as this one's."""
    fn = _build_other(src, defines).pgs_legs_f32
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


TIMELINE_PHASES = ("staging 1", "staging 2", "factor", "rows", "pairs",
                   "sweeps", "epilogue")


def timeline(systems: dict, reps: int = 3) -> dict:
    """Per phase of the legs kernel built with -DPGS_LEGS_TIMELINE, the mean
    and largest us over the blocks of the last of ``reps`` launches, for 0
    sweeps and 3 + 4 sweeps on each named system (float32 CUDA tensors)."""
    src = os.path.join(build.CSRC_DIR, "pgs_legs.cu")
    lib = _build_other(src, ("PGS_LEGS_TIMELINE",))
    fn = load_other(src, ("PGS_LEGS_TIMELINE",))
    get = lib.pgs_legs_timeline
    get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    get.restype = ctypes.c_int
    nst = len(TIMELINE_PHASES) + 1
    out = {}
    for name, system in systems.items():
        blocks = -(-system[2].shape[0] // P.legs_geometry(
            NEFC, B, S, NB, 4, 0, 4).envs_per_block)
        for it, ns in ((0, 0), (3, 4)):
            for _ in range(reps):
                call_other(fn, *system, it, ns, 0)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (blocks * nst))()
            err = get(buf, blocks * nst)
            if err != 0:
                raise RuntimeError(f"timeline copy failed: cudaError_t {err}")
            t = torch.tensor(list(buf), dtype=torch.float64).view(blocks, nst)
            d = (t[:, 1:] - t[:, :-1]) / 1e3
            out[f"{name}_it{it}_ns{ns}"] = {
                ph: {"mean_us": float(d[:, k].mean()), "max_us": float(d[:, k].max())}
                for k, ph in enumerate(TIMELINE_PHASES)} | {
                "block_us": {"mean_us": float((t[:, -1] - t[:, 0]).mean() / 1e3),
                             "max_us": float((t[:, -1] - t[:, 0]).max() / 1e3)}}
    return out


def call_other(fn, lay, fac, J, lm, b, R, lo, hi, iterations: int,
               noslip: int, ns_offset: int = 0):
    """(f, dqacc) of another build of the legs kernel (``load_other``) on
    float32 CUDA tensors, launched with this version's geometry (no fewer
    shared bytes than the other asks for at these shapes)."""
    N, nefc, nv = J.shape
    geo = P.legs_geometry(nefc, lay.nbranch, lay.branch_size, lay.nbase,
                          noslip, ns_offset, J.element_size())
    f, dq = torch.empty_like(b), J.new_empty(N, nv)
    err = fn(J.data_ptr(), fac.Ld.data_ptr(), fac.W.data_ptr(),
             fac.Ls.data_ptr(), lm.leg1.data_ptr(), lm.leg2.data_ptr(),
             lm.has1.data_ptr(), lm.has2.data_ptr(), b.data_ptr(),
             R.data_ptr(), lo.data_ptr(), hi.data_ptr(), f.data_ptr(),
             dq.data_ptr(), N, nefc, nv, lay.nbranch, iterations, noslip,
             ns_offset, geo.envs_per_block, geo.env_stride, geo.smem_bytes,
             torch.cuda.current_stream(J.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"other pgs_legs launch failed: cudaError_t {err}")
    return f, dq


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
    p.add_argument("--timeline", action="store_true",
                   help="legs form: the kernel's phases from its own stamps")
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
    if args.form == "legs":
        pinned = system[:6] + list(pin_pairs(system[6], system[7], ACTIVE))
        result["active"] = ACTIVE
        result["active_lists"] = list_lengths(pinned[6], pinned[7], 0)
        result["active_us"] = _device_us(lambda: kernel(*pinned, 3, 4, 0))
        if args.timeline:
            result["timeline"] = timeline({"all_active": system,
                                           "active": pinned})
    print(f"profile_pgs: {result['device']}, {args.form} form, float32 "
          f"nefc={NEFC} nv={NV}: "
          f"{wave} envs per wave; per wave: staging + prologue "
          f"{t[0, 0]:.2f} us, main-sweep row step {result['row_step_ns']:.1f} "
          f"ns, noslip pair step {result['pair_step_ns']:.1f} ns; full solve "
          f"(3 + 4 sweeps) at {args.envs} envs "
          f"{times[f'N{args.envs}_it3_ns4_us']:.2f} us")
    if args.form == "legs":
        ls = result["active_lists"]
        print(f"profile_pgs: legs, {ACTIVE:.1%} of the pairs active at "
              f"{args.envs} envs: {result['active_us']:.2f} us per solve; rows "
              f"swept per env mean {ls['env_rows']['mean']:.1f}, max "
              f"{ls['env_rows']['max']:.0f}; per warp max "
              f"{ls['warp_rows']['max']:.0f} rows, {ls['warp_pairs']['max']:.0f} "
              f"pairs")
        for run, phases in result.get("timeline", {}).items():
            print(f"profile_pgs: timeline {run} (us, mean / max over blocks): "
                  + ", ".join(f"{ph} {v['mean_us']:.2f}/{v['max_us']:.2f}"
                              for ph, v in phases.items()))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
