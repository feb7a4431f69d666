"""Where the Newton kernel's time goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_newton [-e 2048]
        [--steps 20] [--against DIR]

On anymal_c's own rows (the inputs of the env's last Newton solve after
``--steps`` env steps of random actions at ``-e`` envs, float32) it times
``ops/csrc/newton.cu`` by CUDA events over queued launches at the model's
budget (8 Newton steps, 8 refinements) and at smaller ones: 8 steps with
no refinement, 1 step, and 0 steps (the staging, the warmstart choice and
the outputs alone), from which the time of a Newton step and of a
refinement follow.  With ``--against DIR`` (a directory that holds another
version's ``newton.cu`` and the headers it includes, exporting
``newton_f32`` with this version's arguments and ``newton_env_elems``) it
builds that version with the repo's nvcc flags into ``_build/`` and times
the two in turns (this, other, other, this) on the same inputs, with the
total cost of each one's qacc beside the other's.  The last line is one
JSON object with these numbers and the card's name.  A missing card
raises.
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


def load_other(directory: str):
    """``newton_f32`` and ``newton_env_elems`` of another version's
    ``newton.cu``, built with the repo's flags into ``_build/``."""
    src = os.path.join(directory, "newton.cu")
    h = hashlib.sha256()
    for f in sorted(os.listdir(directory)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(directory, f), "rb") as fh:
                h.update(fh.read())
    lib = os.path.join(build.BUILD_DIR, f"libnewton_other_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    so = ctypes.CDLL(lib)
    fn = so.newton_f32
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    elems = so.newton_env_elems
    elems.argtypes = [ctypes.c_int] * 4
    elems.restype = ctypes.c_int
    return fn, elems


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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--against", type=str, default=None)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    (efc, M, a0, iterations, ls_refine), kw = anymal_rows(args.envs,
                                                          args.steps, dev)
    x0 = kw["x0"]
    name = torch.cuda.get_device_name(dev)
    res = {"device": name, "envs": args.envs, "nefc": efc.J.shape[1],
           "nv": efc.J.shape[2], "budgets": {}}
    for it, ls in BUDGETS:
        us = _device_us(lambda: K.newton_solve(efc, M, a0, it, ls, x0=x0),
                        reps=50)
        res["budgets"][f"{it}x{ls}"] = us
        print(f"profile_newton: {name}, {args.envs} envs, {it} Newton steps x "
              f"{ls} refinements: {us:.1f} us per launch")
    b = res["budgets"]
    res["newton_step_us"] = (b["8x0"] - b["0x0"]) / 8
    res["refinement_us"] = (b["8x8"] - b["8x0"]) / 64
    print(f"profile_newton: staging, warmstart and outputs {b['0x0']:.1f} us; "
          f"a Newton step with its grid {res['newton_step_us']:.1f} us; a "
          f"refinement {res['refinement_us']:.2f} us")
    if args.against:
        fn, elems = load_other(args.against)
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
