"""Where the Newton kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_newton [-e 2048]
        [--steps 20] [--against DIR] [--timeline]

On anymal_c's own rows (the inputs of the env's last Newton solve after
``--steps`` env steps of random actions at ``-e`` envs, float32) it times
``ops/csrc/newton.cu`` by CUDA events over queued launches at the model's
budget (8 Newton steps, 8 refinements) and at smaller ones: 8 steps with
no refinement, 1 step, and 0 steps (the staging, the warmstart choice and
the outputs alone), from which the time of a Newton step and of a
refinement follow.  With ``--against DIR`` (a directory that holds another
version's ``newton.cu`` and the headers it includes, exporting
``newton_f32`` with this version's arguments and ``newton_env_elems``) it
builds that version with the repo's nvcc flags into ``_build/``, times it
by budget too, and times the two in turns (this, other, other, this) on
the same inputs, with the total cost of each one's qacc beside the
other's.

``--timeline`` builds the kernel with ``-DNEWTON_TIMELINE``: lane 0 of
each env's warp stamps the card's global timer at the ends of the solve's
phases: the staging, the warmstart choice, per Newton step its
``STEP_PHASES`` (residual, forces and curvature, gradient, Hessian,
Cholesky factor, triangular solves, Jp and pᵀMp, φ'(0), the 12-candidate
grid, the refinements and the update of x), and the outputs.  It prints
each phase's mean and largest µs over the envs at the model's budget and
its µs in the env whose solve took longest (a Newton step's phases
averaged over its steps), with their sums beside the budget differences
above, which follow that env.  With ``--against``, the other version too, where its
source has the stamps.  The last line is one JSON object with these
numbers and the card's name.  A missing card raises.
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

from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import newton as K
from nightmare_rl_tpu_torch.physics import newton, solver
from nightmare_rl_tpu_torch.tools.profile_pgs import _device_us
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import clone

BUDGETS = ((8, 8), (8, 0), (1, 0), (0, 0))
STEP_PHASES = ("residual", "forces", "gradient", "hessian", "cholesky",
               "solves", "jp_pmp", "phi0", "grid", "refinements", "update")
STAMP_STEPS = 8          # Newton steps stamped (newton_env.cuh kStampSteps)


def anymal_rows(N: int, steps: int, dev: torch.device) -> tuple:
    """The arguments of anymal_c's last Newton solve after ``steps`` env
    steps of random actions at N envs, float32."""
    env = AnymalCEnv(AnymalCCfg(num_envs=N), device=dev)
    state, _ = env.reset(0)
    g = torch.Generator(device=dev).manual_seed(1)
    box = {}
    wrapped = solver.newton_solve

    def kept(*args, **kw):
        box["args"] = (clone(args), {k: clone(v) for k, v in kw.items()})
        return wrapped(*args, **kw)

    solver.newton_solve = kept
    try:
        for _ in range(steps):
            act = 0.5 * torch.randn(N, env.num_actions, generator=g, device=dev)
            state = env.step(state, act).state
    finally:
        solver.newton_solve = wrapped
    return box["args"]


def _build_lib(directory: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """``DIR/newton.cu`` built by nvcc with the repo's flags (and ``-D``
    defines) into ``_build/``, loaded."""
    src = os.path.join(directory, "newton.cu")
    h = hashlib.sha256(" ".join(defines).encode())
    for f in sorted(os.listdir(directory)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(directory, f), "rb") as fh:
                h.update(fh.read())
    lib = os.path.join(build.BUILD_DIR, f"libnewton_other_{h.hexdigest()[:16]}.so")
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


def load_other(directory: str, defines: Sequence[str] = ()):
    """``newton_f32`` and ``newton_env_elems`` of another build of
    ``DIR/newton.cu`` (another version's, or this one's with ``-D``
    defines), and the library."""
    so = _build_lib(directory, defines)
    fn = so.newton_f32
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    elems = so.newton_env_elems
    elems.argtypes = [ctypes.c_int] * 4
    elems.restype = ctypes.c_int
    return fn, elems, so


def timeline(directory: str, efc, M, a0, x0, iterations: int,
             ls_refine: int, reps: int = 3) -> Optional[dict]:
    """Per phase of ``DIR/newton.cu`` built with -DNEWTON_TIMELINE, from the
    stamps of every env of the last of ``reps`` launches: the mean and the
    largest µs over the envs, and the µs of the env whose solve took
    longest, which the kernel's time follows (a Newton step's phases are
    averaged over its first STAMP_STEPS steps); with the sums of each.
    None where the source has no stamps."""
    with open(os.path.join(directory, "newton.cu")) as fh:
        if "NEWTON_TIMELINE" not in fh.read():
            return None
    fn, elems, so = load_other(directory, ("NEWTON_TIMELINE",))
    get = so.newton_timeline
    get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    get.restype = ctypes.c_int
    nst = so.newton_timeline_stamps()
    for _ in range(reps):
        call_other(fn, elems, efc, M, a0, x0, iterations, ls_refine)
    torch.cuda.synchronize()
    envs = min(efc.J.shape[0], 8192)
    buf = (ctypes.c_longlong * (envs * nst))()
    err = get(buf, envs * nst)
    if err != 0:
        raise RuntimeError(f"timeline copy failed: cudaError_t {err}")
    t = torch.tensor(list(buf), dtype=torch.float64).view(envs, nst) / 1e3
    steps = min(iterations, STAMP_STEPS)
    ends = t[:, 3:3 + steps * len(STEP_PHASES)].view(envs, steps, -1)
    starts = torch.cat([t[:, 2:3], ends[:, :-1, -1]], dim=1)[:, :, None]
    prev = torch.cat([starts, ends[:, :, :-1]], dim=2)
    last = ends[:, -1, -1] if steps > 0 else t[:, 2]
    phases = {"staging": t[:, 1] - t[:, 0], "warmstart": t[:, 2] - t[:, 1]}
    for k, ph in enumerate(STEP_PHASES):
        phases[ph] = (ends[:, :, k] - prev[:, :, k]).mean(dim=1)
    phases["outputs"] = t[:, -1] - last
    phases["solve"] = t[:, -1] - t[:, 0]
    slow = int(torch.argmax(phases["solve"]))
    out = {ph: {"mean_us": float(d.mean()), "max_us": float(d.max()),
                "slowest_env_us": float(d[slow])} for ph, d in phases.items()}

    def sums(key):
        return {"newton_step_us": sum(out[ph][key] for ph in STEP_PHASES
                                      if ph != "refinements"),
                "refinement_us": out["refinements"][key] / max(ls_refine, 1),
                "staging_warmstart_outputs_us": sum(
                    out[ph][key] for ph in ("staging", "warmstart", "outputs"))}

    out["sums"] = {"mean": sums("mean_us"), "slowest_env": sums("slowest_env_us")}
    return out


def _print_timeline(who: str, tl: dict, res: dict) -> None:
    """The timeline's lines, its sums beside ``res``'s budget differences
    (the same version's)."""
    print(f"profile_newton: timeline of {who} (us, mean / max over envs / "
          f"the slowest env; a Newton step's phases per step): "
          + ", ".join(f"{ph} {v['mean_us']:.2f}/{v['max_us']:.2f}/"
                      f"{v['slowest_env_us']:.2f}"
                      for ph, v in tl.items() if ph != "sums"))
    m, s = tl["sums"]["mean"], tl["sums"]["slowest_env"]
    b = res["budgets"]
    print(f"profile_newton: timeline of {who}, sums (mean env / slowest env; "
          f"budget differences): a Newton step {m['newton_step_us']:.2f} / "
          f"{s['newton_step_us']:.2f} us ({res['newton_step_us']:.2f}), a "
          f"refinement {m['refinement_us']:.3f} / {s['refinement_us']:.3f} us "
          f"({res['refinement_us']:.3f}), staging + warmstart + outputs "
          f"{m['staging_warmstart_outputs_us']:.2f} / "
          f"{s['staging_warmstart_outputs_us']:.2f} us (the 0 x 0 launch "
          f"{b['0x0']:.2f})")


def call_other(fn, elems, efc, M, a0, x0, iterations: int, ls_refine: int):
    """The other version's solve on the wrapper's inputs (4 envs a block,
    its own workspace size)."""
    N, nefc, nv = efc.J.shape
    spans = K._spans(efc)
    desc, nplain, nc, nmus = K._descriptor(nefc, spans, efc.J.device)
    mu, act, mus = K._cones(efc, N, efc.J.dtype, efc.J.device)
    out = newton.NewtonOut(torch.empty_like(efc.aref), torch.empty_like(a0),
                           torch.empty_like(a0))
    e = elems(nefc, nv, nc, nmus)
    err = fn(efc.J.data_ptr(), efc.aref.data_ptr(), efc.R.data_ptr(),
             efc.fl.data_ptr(), efc.quad_active.data_ptr(), mu.data_ptr(),
             act.data_ptr(), mus.data_ptr(), M.data_ptr(), a0.data_ptr(),
             x0.data_ptr(), out.force.data_ptr(),
             out.qfrc_constraint.data_ptr(), out.qacc.data_ptr(),
             desc.data_ptr(), N, nefc, nv, nc, nplain, nmus, iterations,
             ls_refine, 4, e, 4 * e * efc.J.element_size(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other newton kernel failed: cudaError_t {err}")
    return out


def total_cost(efc, M, a0, x) -> torch.Tensor:
    """Per env 0.5 (x - a0)ᵀM(x - a0) + Σ s(Jx - aref), in float64."""
    efc = newton.NewtonEfc(*[t.double() if t.is_floating_point() else t
                             for t in efc[:5]], cones=tuple(
        g._replace(mu=g.mu.double(), mus=g.mus.double()) for g in efc.cones))
    M, a0, x = M.double(), a0.double(), x.double()
    dx = x - a0
    jar = torch.einsum("nkv,nv->nk", efc.J, x) - efc.aref
    return (0.5 * torch.sum(dx * torch.einsum("nij,nj->ni", M, dx), dim=-1)
            + newton.constraint_cost(efc, jar))


def budgets(solve, who: str, name: str, envs: int) -> dict:
    """µs per launch of ``solve(iterations, ls_refine)`` at each of BUDGETS,
    and the Newton step's and the refinement's µs from their differences."""
    res = {"budgets": {}}
    for it, ls in BUDGETS:
        us = _device_us(lambda: solve(it, ls), reps=50)
        res["budgets"][f"{it}x{ls}"] = us
        print(f"profile_newton: {who}, {name}, {envs} envs, {it} Newton steps "
              f"x {ls} refinements: {us:.1f} us per launch")
    b = res["budgets"]
    res["newton_step_us"] = (b["8x0"] - b["0x0"]) / 8
    res["refinement_us"] = (b["8x8"] - b["8x0"]) / 64
    print(f"profile_newton: {who}: staging, warmstart and outputs "
          f"{b['0x0']:.1f} us; a Newton step with its grid "
          f"{res['newton_step_us']:.1f} us; a refinement "
          f"{res['refinement_us']:.2f} us")
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--against", type=str, default=None)
    p.add_argument("--timeline", action="store_true",
                   help="the kernel's phases from its own timer stamps")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    (efc, M, a0, iterations, ls_refine), kw = anymal_rows(args.envs,
                                                          args.steps, dev)
    x0 = kw["x0"]
    name = torch.cuda.get_device_name(dev)
    res = {"device": name, "envs": args.envs, "nefc": efc.J.shape[1],
           "nv": efc.J.shape[2]}
    res.update(budgets(lambda it, ls: K.newton_solve(efc, M, a0, it, ls,
                                                     x0=x0),
                       "this", name, args.envs))
    if args.against:
        fn, elems, _ = load_other(args.against)
        res["other"] = budgets(lambda it, ls: call_other(
            fn, elems, efc, M, a0, x0, it, ls), "the other", name, args.envs)
    if args.timeline:
        res["timeline"] = {"this": timeline(build.CSRC_DIR, efc, M, a0, x0,
                                            iterations, ls_refine)}
        _print_timeline("this", res["timeline"]["this"], res)
        if args.against:
            other = timeline(args.against, efc, M, a0, x0, iterations,
                             ls_refine)
            res["timeline"]["other"] = other
            if other is not None:
                _print_timeline("the other", other, res["other"])
    if args.against:
        runs = {"this": lambda: K.newton_solve(efc, M, a0, iterations,
                                               ls_refine, x0=x0),
                "other": lambda: call_other(fn, elems, efc, M, a0, x0,
                                            iterations, ls_refine)}
        turns = {"this": [], "other": []}
        for who in ("this", "other", "other", "this"):
            turns[who].append(_device_us(runs[who], reps=50))
        c_this = total_cost(efc, M, a0, runs["this"]().qacc)
        c_other = total_cost(efc, M, a0, runs["other"]().qacc)
        excess = float(((c_this - c_other) / c_other.abs()).max())
        res.update(turns=turns, against=args.against,
                   cost_excess_this_over_other=excess)
        print(f"profile_newton: in turns (this, other, other, this) at "
              f"{iterations} x {ls_refine}: {turns['this'][0]:.1f}, "
              f"{turns['other'][0]:.1f}, {turns['other'][1]:.1f}, "
              f"{turns['this'][1]:.1f} us; largest per-env cost excess of "
              f"this over the other {excess:.3e}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
