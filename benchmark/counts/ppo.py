"""The least work of a PPO iteration's layers, as functions of a
configuration's sizes alone: the rollout step (act, the physics substeps'
solve and its output products, store) and the learning half (GAE, the
minibatch gradients, Adam).  Frozen copies of the arithmetic of the port's
smoke script (``chip_smoke.py``: ``_pgs_legs_ops``, ``_pgs_ops``,
``_rollout_bound``, ``_learn_bounds``, ``_adam_bound``,
``_bytes_ops_bound``), so that a later change to the program is held to the
same work.  A layer's bytes are its inputs read once and its outputs written
once; what a kernel keeps between its stages (J, the arrow factor, the
panels) is not a layer's.  The least time is the larger of the operations
over the float32 peak and the bytes over the memory rate."""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3
FLOAT = 4                     # float32 bytes


def least_s(ops: float, nbytes: float) -> float:
    """The least time of ``ops`` float32 operations moving ``nbytes``."""
    return max(ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S)


def mlp(n_in: int, hidden: Sequence[int], n_out: int) -> Tuple[int, int, int]:
    """(multiply-adds, output units, hidden units) of an MLP."""
    widths = [n_in, *hidden, n_out]
    macs = sum(a * b for a, b in zip(widths, widths[1:]))
    return macs, sum(widths[1:]), sum(hidden)


def pgs_legs_ops(N: int, nefc: int, B: int, iterations: int, noslip: int,
                 ns_offset: int) -> float:
    """Floating-point operations of one leg-sparse PGS solve (B legs of 3
    dofs, a 6-dof base: 12 panel values a row) with its qacc epilogue."""
    npairs = max((nefc - ns_offset) // 2, 0) if noslip > 0 else 0
    # two 3x3 solves, two 3x6 products with W, the 6x6 solve, |panel|^2
    prologue_row = 2 * 15 + 2 * 36 + 12 + 42 + 24
    sweep_row = 4 * 12 + 8          # panel·u, the update, g, clip
    pair = 7 * 12 + 20              # (g_i - g_j)·u, two updates, scalars
    epilogue = 42 + B * (36 + 15)   # Ls^-T, then per leg W xb and Ld^-T
    return N * (prologue_row * nefc + 24 * npairs
                + iterations * nefc * sweep_row + noslip * npairs * pair
                + epilogue)


def pgs_ops(N: int, nefc: int, nv: int, iterations: int, noslip: int,
            ns_offset: int) -> float:
    """Floating-point operations of one dense PGS solve."""
    npairs = max((nefc - ns_offset) // 2, 0) if noslip > 0 else 0
    prologue = 2 * nefc * nv + 2 * npairs * nv + 2 * nefc
    sweep_row = 4 * nv + 8          # J·w, rank-1 update, g, clip
    pair = 7 * nv + 20              # (Ji-Jj)·w, two rank-1 updates, scalars
    return N * (prologue + iterations * nefc * sweep_row
                + noslip * npairs * pair)


def newton_ops(N: int, nefc: int, nv: int, iterations: int,
               ls_refine: int) -> float:
    """The floating-point operations that every Newton step needs whatever
    the rows' activity: J·x and J·p over every row, M·x, pᵀMp and gᵀMp,
    the factor of the nv x nv Hessian and two triangular solves, 8
    operations a row for each of the 1 + 12 + ls_refine evaluations of φ'
    and φ''; then Jᵀf.  The Hessian's rows over the active constraints
    depend on the data and are left out, so the count is a lower one."""
    step = (4 * nefc * nv + 6 * nv * nv + nv ** 3 / 3 + 4 * nv * nv
            + (13 + ls_refine) * 8 * nefc)
    return N * (iterations * step + 2 * nefc * nv)


def act_ops(N: int, nobs: int, A: int, actor: Sequence[int],
            critic: Sequence[int]) -> float:
    """act: 2 operations a multiply-add, 1 a bias and 1 an activation, 10 an
    action for the sample and its log-density."""
    am, au, ah = mlp(nobs, actor, A)
    cm, cu, ch = mlp(nobs, critic, 1)
    return N * (2 * (am + cm) + au + cu + ah + ch + 10 * A)


def rollout_step(sizes: dict) -> Tuple[float, float]:
    """(operations, bytes) of one rollout step at ``sizes``: act, per
    substep the solve (the legs or dense PGS at its fixed sweeps, or
    Newton at its fixed budget) and Jᵀf with qacc's update, and store's 3
    operations an env and 1 a reward term; the env state, observations,
    weights and the step's draws read once, the next state, observations,
    the trajectory's row and env 0's record row written once."""
    N, nefc, nv = sizes["num_envs"], sizes["nefc"], sizes["nv"]
    if sizes["form"] == "newton":
        solve = newton_ops(N, nefc, nv, sizes["iterations"],
                           sizes["ls_refine"])
    elif sizes["form"] == "legs":
        solve = pgs_legs_ops(N, nefc, sizes["legs"], sizes["iterations"],
                             sizes["noslip"], sizes["ns_offset"])
    else:
        solve = pgs_ops(N, nefc, nv, sizes["iterations"], sizes["noslip"],
                        sizes["ns_offset"])
    A, nobs = sizes["num_actions"], sizes["num_obs"]
    substep = solve + N * (2 * nefc * nv + nv)
    ops = (act_ops(N, nobs, A, sizes["actor"], sizes["critic"])
           + sizes["decimation"] * substep + N * (3 + sizes["terms"]))
    params = sizes["params"]
    reads = (sizes["state_bytes"] + FLOAT * (N * nobs + params + N * A
                                             + N * sizes["draws"]))
    writes = (sizes["state_bytes"] + FLOAT * N * nobs
              + FLOAT * N * (nobs + 3 * A + 4) + sizes["record_bytes"])
    return ops, reads + writes


def learn_iteration(sizes: dict) -> Tuple[float, float]:
    """(operations, bytes) of an iteration's learning half at ``sizes``:
    GAE (9 operations a step and env), the normalization (4), per minibatch
    the gradients (2 operations a multiply-add of the forward pass, the
    weight gradients and the deltas, 4 a hidden unit, 30 an action and 20
    a sample for the losses) and Adam (16 a parameter); the trajectory and
    the last observations read once, the weights and Adam's moments read
    and written once."""
    T, N = sizes["steps"], sizes["num_envs"]
    A, nobs, P = sizes["num_actions"], sizes["num_obs"], sizes["params"]
    am, _, ah = mlp(nobs, sizes["actor"], A)
    cm, _, ch = mlp(nobs, sizes["critic"], 1)
    dx = am + cm - nobs * (sizes["actor"][0] + sizes["critic"][0])
    mbs = sizes["epochs"] * sizes["minibatches"]
    B = T * N // sizes["minibatches"]
    grads = B * (2 * (2 * (am + cm) + dx) + 4 * (ah + ch) + 30 * A + 20)
    ops = 13 * T * N + mbs * (grads + 16 * P)
    traj = T * N * (nobs + 3 * A + 4)
    nbytes = FLOAT * (traj + N * nobs + 6 * P)
    return ops, nbytes
