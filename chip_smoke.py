#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nightmare_rl_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

1. device  — the card's name and ``nvidia-smi`` name/power limit;
2. build   — nvcc builds ``ops/csrc/pgs.cu``, ``ops/csrc/pgs_legs.cu`` and
             ``ops/csrc/newton.cu`` for sm_90a from the checkout, all at
             once; prints ptxas's registers and spills (the float32 kernels
             must not spill) and each kernel's main-path launch geometry:
             lanes per env, shared memory per block and envs resident per
             SM;
3. kernel  — the PGS kernel against ``pgs_reference`` on the card, float64
             random systems: the main path's shapes with and without dof
             rows, then the design's edge shapes (N not a multiple of the
             envs per block, panels that are not whole 16-byte chunks with
             an odd contact block, nv above 32);
3b. kernel-legs — the leg-sparse kernel (f and qacc's change from its
             epilogue) against ``leg_panels`` + ``pgs_legs_reference`` (+
             ``arrow.solve_lt``) on the card, float64 random block-arrow
             problems at the main path's shape (2048 x 112, 6 legs): with
             pair rows, dof rows, half the rows base-only, same-branch
             pairs, N=2047, N=1 and anymal_c's layout (4 legs); on each, the
             dense kernel on the same system (U = J M⁻¹) too; then the
             cases of its row and pair lists (every row active, none, an
             env with none beside full ones, a NaN in b of a pinned and of
             an active row) in float64 and float32, NaN at the plain
             version's positions;
4. physics — three decimated steps of 16 envs in float64 on the card (kernel)
             against the same steps on the CPU (plain version);
4b. physics-legs — the same with NIGHTMARE_PGS=legs: the legs kernel on
             every substep against the legs form on the CPU;
4c. graph  — the env step captured as a CUDA graph (``utils/graph.py``)
             against the plain env step, 2048 envs, float32, in the legs and
             the dense-kernel form: from one state and generator state, 20
             env steps eager and 20 replays, every StepOut field equal bit
             for bit, the env generator's state equal, no host sync in a
             replay, ``decimation`` launches of the form's kernel per
             replay; then wall ms per env step in turns (eager, graph,
             graph, eager), the capture's time and the graph's pool;
5. slice   — the training CLI's code path: nightmare_v3, 2048 envs, float32,
             reset + 2 PPO iterations; the loss must be finite and the PGS
             kernel must have run on every substep (the rollout replays one
             captured step; its eager warm-up step counts).  The inputs of
             the slice's last PGS call (the last replay's) are kept; after
             recorder/resume, the slice's PPO times its rollout as graph
             replays and as eager calls of the step the graph holds, in
             turns, and prints both env-steps/s;
5b. update-graph — the slice's learning half (``PPO._learn``: last value,
             GAE, permutation, 5×4 update), replayed from the graphs that
             the slice's training captured (its parts split at the
             reductions over the ranks: the prologue's three once, a
             minibatch step's two per minibatch), against the same function
             called eagerly, both from the slice's state restored in place
             (parameters, gradients, Adam's state, the tensor lr, the
             generator): statistics, parameters, gradients, Adam's moments
             and step counts, lr, permutation and generator state equal bit
             for bit, no host sync inside the parts; then seconds per update
             in turns (eager, graph, graph, eager), the parts' capture
             seconds and pools;
6. main-path kernel — the PGS kernel against ``pgs_reference`` on those
             float32 inputs (a minimum share of active rows is asserted),
             with CUDA-event times for both;
7. policy  — ``artifacts/model_3176.pt`` loaded and run on the card against
             the CPU;
7b. slice-legs — the training CLI with NIGHTMARE_PGS=legs, 2048 envs,
             float32, reset + 1 PPO iteration: finite loss, the legs kernel
             on every substep and the dense one never; the legs kernel held
             against its plain version on the inputs of its last call, the
             rows and pairs it sweeps there printed per env and per warp,
             and timed beside the dense form on the same system (M⁻¹, U =
             J M⁻¹, the pgs kernel and M⁻¹Jᵀf), its bound counting of J
             the values the rows need, and in turns with its earlier design
             that swept every row, where a copy of that source was put; then
             the env step timed
             in both forms, in
             turns, from one settled state, and the host syncs of one
             physics substep counted in each;
8. physics-anymal — anymal_c (Newton solver, elliptic cones), 16 envs in
             float64 from the reference pose with perturbed joints and
             velocities, 3 decimated steps (12 substeps) at a converged
             Newton budget, the card's solves the Newton kernel and the
             CPU's the plain version: each step of the card starts from the CPU's
             state before it, so the error is one decimated step's; the
             zones of the cone contacts at the last substep are counted (a
             bottom and a middle one are required);
8b. graph-anymal — anymal_c's env step captured as a CUDA graph against the
             plain env step at 2048 envs, float32: 20 env steps eager and
             20 replays from one state, every StepOut field equal bit for
             bit, the env generator's state equal, no host sync in a
             replay, 4 launches of the Newton kernel per replay; the
             graph's nodes by type; wall ms per env step in turns (eager,
             graph, graph, eager), the warm-up's and the capture's seconds,
             the pool;
9. slice-anymal — the training CLI with ``--robot anymal_c``, 2048 envs,
             float32, reset + 1 PPO iteration, the rollout replaying the
             captured step: every substep's Newton solve is one launch of
             the Newton kernel (4 per env step, the replays' counted by the
             graph) and clones of the last solve's inputs are kept;
10. newton-converged — those inputs in float64, solved by the kernel at
             the slice's budget and by the plain solve at 100 iterations
             with 50 refinements: in at least 90 % of the envs the budget's
             qacc must lie within 2e-4 of the converged one (relative to
             1 + |qacc|; the rest are envs whose line search stalls on its
             round-off floor, PERF.md §6);
10b. eval-anymal — ``tools/eval_anymal.py`` on the committed
             ``anymal_model_122.pt``: 300 steps at vx 0.5, deterministic,
             each a replay of the captured play step; its two lines printed
             beside the JAX script's on the CPU, and held to that outcome:
             no fall or timeout, base height's mean in [0.599, 0.609],
             |v_avg| ≤ 0.02 m/s in x and y, every foot's duty ≥ 0.95; every
             substep a launch of the Newton kernel;
10c. newton-kernel — the Newton kernel against the plain ``newton.solve``
             on the card, on the slice's last solve (2048 envs of anymal_c's
             rows; every cone zone must occur on the solve's path): in
             float64 at 1 iteration with 1 refinement and at 2 iterations
             with none, where the line search's decisions stand above the
             round-off floor of φ' (each env within 1e-9 of the plain solve
             relative to 1 + max|field| of force, qfrc and qacc, unless a
             decision is on the floor; the smallest margin over the floor
             printed), and at N=1, cold, N=37; in float32 at the model's
             budget (8 / 8) by total cost (no more than the plain version's
             plus 1e-5 of it in 99 % of the envs; the plain solve's own
             float32-against-float64 spread printed beside it) and NaN
             pattern, the largest qacc gap printed; at least 90 % of the
             envs held in float64; nightmare_v3_mjx
             (pyramidal, no cone group, then noslip) card against CPU, one
             step at a converged budget (1e-9); then the kernel's and the
             plain version's CUDA-event times and its bound;
11. recorder/resume (right after the slice) — the slice's runner recorded
             env 0: it received 2 × 80 frames with finite qpos; the
             ``model_2.pt`` it saved, loaded into a fresh runner on the card,
             restores every field of the train state exactly;
12. play-grid — ``tools/play.py``'s ``grid_eval`` of
             ``artifacts/model_3176.pt``: 7 commands × 400 steps,
             deterministic, float32; zero falls on every row, achieved vx at
             least 80 % of the command on the ±0.3 m/s straight rows, and the
             PGS kernel on every substep, held against ``pgs_reference`` on
             the inputs of its last call;
13. custom-play — the batched gait engine in float64 on the card against
             the CPU over an idle → get-up → walk journey (≤ 1e-9 in the
             joint angles); then ``tools/custom_play.py`` at 256 envs,
             float32, tripod, 430 control steps, four commands spread over
             the envs (two walks, two turns), its control step replayed as a
             captured graph: every env stands up and walks and turns as the
             JAX tool does under its command, the envs of one command agree,
             and the PGS kernel is held against ``pgs_reference`` on the
             inputs of its last call; control steps/s as replays and of 60
             calls of the plain control step;
14. simple-test — ``tools/simple_test.py -e 2048 -s 5 -d 4``: substeps/s;
             the PGS kernel held against ``pgs_reference`` on the inputs of
             its last call;
15. recurrent-net — ``ActorCriticRecurrent`` at full width (rnn 512,
             [54, 42, 30]), weights from a seed: a 6-step sequence with
             resets, outputs and gradients, on the card against the CPU, in
             float64 and in float32 with cuDNN's TF32 flag on (torch's
             default), which the port's LSTM must not follow;
16. slice-recurrent — the training CLI with the recurrent policy
             (``policy_class_name="ActorCriticRecurrent"``): nightmare_v3,
             2048 envs, float32, one full PPO iteration (80 steps, 5×4
             update); the hidden state must be nonzero, the PGS kernel must
             have run on every substep and is held against
             ``pgs_reference`` on the inputs of its last call; then its
             learning half as update-graph holds the feed-forward one;
17. sharded — the CLI's ``--mesh`` under ``python -m
             torch.distributed.run``: world 1 (nccl) and world 2 (gloo, both
             ranks on cuda:0), 2048 global envs, 4 steps, with a 1×1 update
             (rollout stats, loss and parameters agree) and the default 5×4
             update (rollout stats agree); on each rank of both worlds, one
             full feed-forward iteration (80 steps, 5×4 update) whose
             learning half, as the ranks replayed it (the captured parts,
             the reductions between them), is held against eager from one
             state as update-graph holds it (bit for bit, no host sync
             inside the parts, seconds in turns, capture seconds and
             pools); then world 2 with the recurrent
             policy for one full iteration, its update replayed and then
             held per rank as the learn job's: the hidden
             state is sharded, each rank's captured pool is printed,
             each rank counts its PGS launches and rank 1's last PGS inputs
             hold the kernel against ``pgs_reference``; the world-2
             checkpoint reloaded at world 1 restores every field of the
             global train state; on a machine with two or more cards, world
             1 is also held against one nccl rank per card;
18. external — ``rl/external.py``'s ``ExternalPPO`` stepping the port's env
             through a host callback against the fused ``PPO`` from the same
             seed and weights: 256 envs, 16 steps of 7-step episodes (the
             resets and time-out bootstraps agree), one iteration;
19. dense-hexapod — nightmare_v3 with its block-arrow layout withheld, so
             the dense mass-matrix branch steps it (dense Cholesky, the
             PGS kernel's U from the dense M⁻¹): one decimated step of
             2048 envs in float64 against the arrow path; then, once the
             envs have landed, 10 float32 env steps of random actions as
             replays of the env step captured with either branch, finite,
             without host syncs, and timed beside the arrow path; the
             kernel held on the last dense inputs of both and timed;
20. dense-models — the archives that ``tools/compile_model`` made from the
             port's MJCF assets (two free spheres, condim 3 and 6, PGS with
             100 sweeps; a limited hinge with frictionloss, no contact
             point), 2048 envs: 50 float64 steps on the card against the
             CPU, 10 float32 steps on the card; the kernel held in both
             precisions at their shapes (2048 x 18 x 12, 2048 x 3 x 1) and
             timed;
21. curve — ``tools/compare_reference_curve.py --side tpu`` at 256 envs x 2
             iterations for seeds 1 and 2: rows with the JAX tool's keys,
             and first-iteration losses that differ (``PPO.init`` draws the
             weights from the seed);
22. probe  — NIGHTMARE_PGS unset: the solver-form probe at the main path's
             key, both candidates timed at N=2048; its verdict is printed
             (not asserted) and read back from its cache file.

The phases that hold the dense kernel run with NIGHTMARE_PGS=kernel, as
the mesh ranks do; the legs phases and the probe set the variable
themselves.  The training slices (slice, slice-legs, slice-anymal,
slice-recurrent, sharded, external's fused PPO), play-grid, custom-play,
simple-test and dense-hexapod's float32 steps go through captured CUDA
graphs, as their tools do on the card: each capture runs one eager warm-up
step, whose launches count, and the kernel is held on the inputs of the
last replay (clones that are nodes of the graph).  The training slices,
the sharded ranks' included, also replay their learning half (GAE and the
update) as graphs, the sharded ranks' reductions between them; so does
eval-anymal its play step.  The physics phases,
dense-models and the curve tool (its ``ExternalPPO`` steps the env through
a host callback) run eagerly.  The anymal_c path runs the Newton kernel on
every substep; the tools, the captured update and the recurrent, sharded,
external and dense paths run no kernel of their own.  The kernels' line
lists ``pgs``, whose launches are those of the slice, the dense phases and
the curve phase, ``pgs_legs``, whose launches are slice-legs', and
``newton``, whose launches are graph-anymal's, slice-anymal's and
eval-anymal's, each counted from zero (the launches that hold a kernel
against its plain version are not counted).

The line before the nvidia-smi line is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA card and the repo.  The
sharded phase runs this script again as its ranks (``--mesh-worker``, see
``mesh_worker``); tests/test_torch_sharded.py runs the same ranks on the
CPU.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
F64_TOL = 1e-10              # max |kernel - plain| / max |f|, float64
F32_TOL = 1e-5               # the same in float32 (560 dependent row steps)
MIN_ACTIVE = 0.05            # least share of rows with hi > 0 in the float32 check
PHYS_TOL = 1e-9              # card vs CPU physics state, float64
# card vs CPU, one anymal_c decimated step, relative to each field's scale:
# round-off amplified by the stiff elliptic cones (tests/test_torch_anymal.py)
ANYMAL_STEP_TOL = 2e-8
# Newton budget of the physics-anymal phase: at the env's 8 the perturbed
# reset states are not converged, the line search's last decision sits on
# the round-off floor of φ', and card and CPU need not agree beyond it
ANYMAL_PHYS_ITERATIONS = 30
NEWTON_CONVERGED_TOL = 2e-4  # budget vs converged qacc, /(1 + |qacc|)
NEWTON_CONVERGED_SHARE = 0.9  # least share of envs within it
# the Newton kernel against newton.solve: float64 at budgets whose
# line-search decisions stand above the round-off floor of φ' (one Newton
# step with a refinement; two steps on the grid alone), per env max |Δ| /
# (1 + max |plain|) of force, qfrc and qacc; an env with a decision whose
# |φ'| is under NEWTON_FLOOR round-off scales is not held (an env in free
# flight has a quadratic φ whose root is the grid's α = αmax itself); at
# least NEWTON_HELD_SHARE of the envs held.  Float32 at the model's budget,
# where every env takes decisions on the floor: the total cost no more
# than the plain version's plus NEWTON_COST_TOL of it in at least
# NEWTON_COST_SHARE of the envs (the plain solve's own float32 and float64
# results part by more on a few envs too, printed beside it).
NEWTON_HELD_BUDGETS = ((1, 1), (2, 0))
NEWTON_F64_TOL = 1e-9
NEWTON_FLOOR = 4.0
NEWTON_HELD_SHARE = 0.9
NEWTON_COST_TOL = 1e-5
NEWTON_COST_SHARE = 0.99
MODEL_3176 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "artifacts", "model_3176.pt")
GRID_STEPS = 400
GRID_MIN_VX = 0.8            # least achieved/commanded vx on the straight rows
ENGINE_TOL = 1e-9            # gait engine, card vs CPU, float64 joint angles
CUSTOM_ENVS, CUSTOM_STEPS = 256, 430
# (lin, ang) commands, env i taking the (i mod 4)-th, and what the JAX tool
# gives for each on the CPU (python -m nightmare_rl_tpu.tools.custom_play
# --steps 430 --lin L --ang A --envs 1, float32): the base's horizontal
# displacement from (0, 0, 0.15) in m and its final yaw in rad.  For lin
# 0.08 it ends at x=-0.483496, y=+0.019455, z=0.089835, nearly all of it
# walked after get-up ends near step 280.  Each env must walk within half
# and 1.5 times the JAX tool's distance and, on a turn, turn its way by at
# least half its angle; the envs of one command must end within
# CUSTOM_SPREAD of each other.
CUSTOM_CMDS = ((0.08, 0.0), (0.04, 0.0), (0.08, 0.3), (0.08, -0.3))
CUSTOM_JAX = ((0.4839, -0.0479), (0.3046, -0.0097), (0.2592, +0.9996),
              (0.2577, -1.0180))
CUSTOM_SPREAD = 0.01
CUSTOM_MIN_HEIGHT = 0.07     # base z once up (the engine stands at ~0.09 m)
SETTLE_STEPS = 25            # zero-action env steps before the dense-hexapod steps
RNN_TOL = 1e-10              # recurrent net, card vs CPU, /max|output|, float64
RNN_F32_TOL = 1e-5           # the same in float32 (TF32's 10-bit mantissa fails it)
MESH_ENVS = 2048             # global envs of the sharded phase
MESH_TIMEOUT = 400           # seconds for one torch.distributed.run
LEGS_DENSE_TOL = 1e-9        # legs against dense form, /max|f|, float64
LEGS_F64_TOL = 1e-12         # legs kernel against its plain version, float64
# the earlier design of csrc/pgs_legs.cu, which swept every row, where a
# copy of it was put (not in the repo); slice-legs times it in turns with
# the current one
LEGS_EARLIER_SRC = os.path.join("nightmare_rl_tpu_torch", "_build",
                                "pgs_legs_every_row.cu")
LEGS_STEPS = 10              # float32 env steps timed per form in slice-legs
GRAPH_STEPS = 20             # env steps per form in the graph phase, eager and replayed
GRAPH_WARMUP = 1             # eager steps before a capture (utils/graph.py WARMUP)
ANYMAL_GRAPH_STEPS = 20      # anymal_c env steps eager and replayed in graph-anymal
ANYMAL_TIMED_STEPS = 5       # anymal_c env steps per timed turn
CUSTOM_EAGER_STEPS = 60      # custom_play control steps timed eagerly
EVAL_STEPS = 300             # eval-anymal: steps at vx 0.5, deterministic
EVAL_JAX = (                 # scripts/eval_anymal.py, JAX on the CPU, same run
    "eval: cmd (+0.50,+0.00,+0.00) | displacement v (-0.002,-0.000) m/s | "
    "falls=0 timeouts=0",
    "gait: duty=1.00/1.00/1.00/1.00 | feet_down mean=4.00 | base_z "
    "mean=0.604 min=0.604")
EVAL_BASE_Z = (0.599, 0.609)  # band of the base height's mean after settling
EVAL_MAX_V = 0.02            # |v_avg| in x and in y, m/s
EVAL_MIN_DUTY = 0.95         # every foot's share of steps down


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _random_system(N, nefc, nv, ns_offset, dtype, seed):
    """Random well-posed constraint systems in the solver's (J, M⁻¹) form,
    with box rows before ns_offset and some inactive facet pairs."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float64, generator=g)
    J = torch.randn(N, nefc, nv, **kw)
    G = torch.randn(N, nv, nv, **kw)
    Minv = G @ G.transpose(1, 2) + 0.1 * torch.eye(nv, device="cuda",
                                                   dtype=torch.float64)
    U = J @ Minv
    b = torch.randn(N, nefc, **kw) * 5
    R = torch.abs(torch.randn(N, nefc, **kw)) + 0.01
    lo = torch.zeros(N, nefc, device="cuda", dtype=torch.float64)
    hi = torch.full((N, nefc), math.inf, device="cuda", dtype=torch.float64)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    npairs = (nefc - ns_offset) // 2
    inact = torch.rand(N, npairs, device="cuda", generator=g) < 0.3
    hi[:, ns_offset:ns_offset + 2 * npairs][inact.repeat_interleave(2, 1)] = 0.0
    return [x.to(dtype).contiguous() for x in (J, U, b, R, lo, hi)]


def _random_arrow_batch(rng, N, nefc, B, s, nb, ns_offset=0, npair_rows=0,
                        same_branch_rows=0, base_share=0.15) -> dict:
    """N random constraint systems over block-arrow mass matrices (numpy,
    float64), batched from tests/test_ops.py::_random_arrow_problem: rows
    whose support has the leg-slot structure of the real models.  Dof rows
    (before ns_offset) touch one leg; plane-contact rows one leg and the
    base, a share of them the base only (has1 False); the last npair_rows
    rows are pair rows on two legs without the base, the first
    same_branch_rows of them on one leg (slot 2 masked).  The two rows of a
    noslip pair share their slots.  Returns the factor blocks (Ld, W, Ls, C),
    M⁻¹, J, the slot ids and masks, b, R, lo and hi, with some contact
    pairs inactive."""
    import numpy as np

    nv = nb + B * s
    ii, jj = np.arange(s), np.arange(nb)
    Ld = np.tril(rng.normal(size=(N, B, s, s)))
    Ld[:, :, ii, ii] = np.abs(Ld[:, :, ii, ii]) + 1.0
    W = rng.normal(size=(N, B, s, nb)) * 0.3
    Ls = np.tril(rng.normal(size=(N, nb, nb)))
    Ls[:, jj, jj] = np.abs(Ls[:, jj, jj]) + 1.0
    C = Ld @ W
    M = np.zeros((N, nv, nv))
    M[:, :nb, :nb] = (np.einsum("nbsi,nbsj->nij", W, W)
                      + Ls @ Ls.transpose(0, 2, 1))
    for k in range(B):
        sl = slice(nb + k * s, nb + (k + 1) * s)
        M[:, sl, sl] = Ld[:, k] @ Ld[:, k].transpose(0, 2, 1)
        M[:, sl, :nb] = C[:, k]
        M[:, :nb, sl] = C[:, k].transpose(0, 2, 1)
    rows = np.arange(nefc)
    leg1 = rng.integers(0, B, size=(N, nefc))
    pair_row = rows >= nefc - npair_rows
    same = pair_row & (rows < nefc - npair_rows + same_branch_rows)
    leg2 = np.where(same, leg1, np.where(leg1 + 1 < B, leg1 + 1, 0))
    has2 = np.broadcast_to(pair_row & ~same, (N, nefc)).copy()
    same = np.broadcast_to(same, (N, nefc)).copy()
    lead = np.arange(ns_offset, nefc - 1, 2)
    for x in (leg1, leg2, has2, same):
        x[:, lead + 1] = x[:, lead]
    has1 = np.ones((N, nefc), bool)
    base_only = (rng.random((N, nefc)) < base_share) & ~has2 & ~same
    J = np.zeros((N, nefc, nv))
    J[..., :nb] = rng.normal(size=(N, nefc, nb)) * (
        (rows >= ns_offset) & ~has2 & ~same)[..., None]
    n, r = np.arange(N)[:, None, None], rows[None, :, None]
    J[n, r, nb + s * leg1[..., None] + ii] = rng.normal(size=(N, nefc, s)) * (
        ~base_only)[..., None]
    J[n, r, nb + s * leg2[..., None] + ii] += rng.normal(size=(N, nefc, s)) * (
        has2[..., None])
    lo = np.zeros((N, nefc))
    hi = np.full((N, nefc), np.inf)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    npairs = (nefc - ns_offset) // 2
    contact = slice(ns_offset, ns_offset + 2 * npairs)
    hi[:, contact] = np.where(np.repeat(rng.random((N, npairs)) < 0.3, 2, axis=1),
                              0.0, hi[:, contact])
    return dict(Ld=Ld, W=W, Ls=Ls, C=C, Minv=np.linalg.inv(M), J=J,
                leg1=leg1.astype(np.int32), leg2=leg2.astype(np.int32),
                has1=~base_only, has2=has2,
                b=rng.normal(size=(N, nefc)) * 5,
                R=np.abs(rng.normal(size=(N, nefc))) + 0.01, lo=lo, hi=hi)


def _legs_args(prob: dict, dev, dtype) -> tuple:
    """(lay, fac, J, legmeta, b, R, lo, hi) of a ``_random_arrow_batch``
    problem as tensors on dev, the arguments of ``ops.pgs.pgs_legs`` before
    the sweep counts."""
    import torch

    from nightmare_rl_tpu_torch.physics import arrow, solver

    t = {k: torch.as_tensor(v, device=dev) for k, v in prob.items()}
    f = {k: v.to(dtype).contiguous() for k, v in t.items() if v.is_floating_point()}
    N, B, s, _ = f["Ld"].shape
    nb = f["Ls"].shape[-1]
    return (arrow.ArrowLayout(nb + B * s, nb, B, s),
            arrow.ArrowFac(f["Ld"], f["W"], f["Ls"], f["C"]), f["J"],
            solver.LegMeta(t["leg1"], t["leg2"], t["has1"], t["has2"]),
            f["b"], f["R"], f["lo"], f["hi"])


def _pgs_ops(N, nefc, nv, iterations, noslip, ns_offset) -> float:
    """Floating-point operations of one solve, counted from the algorithm."""
    npairs = max((nefc - ns_offset) // 2, 0) if noslip > 0 else 0
    prologue = 2 * nefc * nv + 2 * npairs * nv + 2 * nefc
    sweep_row = 4 * nv + 8          # J·w, rank-1 update, g, clip
    pair = 7 * nv + 20              # (Ji-Jj)·w, two rank-1 updates, scalars
    return N * (prologue + iterations * nefc * sweep_row
                + noslip * npairs * pair)


def _pgs_legs_ops(N, nefc, B, iterations, noslip, ns_offset) -> float:
    """Floating-point operations of one leg-sparse solve (B legs of 3 dofs, a
    6-dof base: 12 panel values a row) with its qacc epilogue, counted from
    the algorithm."""
    npairs = max((nefc - ns_offset) // 2, 0) if noslip > 0 else 0
    # two 3x3 solves, two 3x6 products with W, the 6x6 solve, |panel|^2
    prologue_row = 2 * 15 + 2 * 36 + 12 + 42 + 24
    sweep_row = 4 * 12 + 8          # panel·u, the update, g, clip
    pair = 7 * 12 + 20              # (g_i - g_j)·u, two updates, scalars
    epilogue = 42 + B * (36 + 15)   # Ls^-T, then per leg W xb and Ld^-T
    return N * (prologue_row * nefc + 24 * npairs + iterations * nefc * sweep_row
                + noslip * npairs * pair + epilogue)


def _legs_plain(args: tuple):
    """``leg_panels`` + ``pgs_legs_reference`` and ``arrow.solve_lt`` of its
    final slot state: the plain version of ``pgs_legs`` (f, dqacc) on any
    device.  args: pgs_legs's, sweep counts included."""
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import arrow, solver

    lay, fac, J, lm, b, R, lo, hi, it, ns, ns_offset = args
    f, u = P.pgs_legs_reference(
        solver.leg_panels(lay, fac, J, lm), lm.leg1, lm.leg2, b, R, lo, hi,
        lay.nbranch, lay.branch_size, lay.nbase, it, ns, ns_offset)
    return f, arrow.solve_lt(lay, fac, u)


def _ptxas(log: str, pattern: str, label) -> list:
    """Registers and spill bytes per kernel instantiation from nvcc's
    ``-Xptxas -v`` output; ``label`` names an instantiation from the match
    of ``pattern`` on its mangled name."""
    kernels, fn = [], None
    for ln in log.splitlines():
        m = re.search(pattern, ln)
        if "Compiling entry function" in ln:
            fn = dict(name=label(m)) if m else None
            if fn is not None:
                kernels.append(fn)
        elif fn is not None and "spill stores" in ln:
            fn["spill"] = [int(x) for x in
                           re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
        elif fn is not None and "registers" in ln:
            fn["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
    return kernels


def phase_build() -> None:
    """Build the kernels (one nvcc each, started together) and report what
    ptxas and the occupancy queries say."""
    import concurrent.futures

    import torch

    from nightmare_rl_tpu_torch.ops import build
    from nightmare_rl_tpu_torch.ops import newton as K
    from nightmare_rl_tpu_torch.ops import pgs as P

    names = ("pgs", "pgs_legs", "newton")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build.build, names)))
    kernels = {
        "pgs": _ptxas(infos["pgs"]["log"],
                      r"pgs_kernelI([fd])Li(\d+)ELi(\d+)ELb([01])E",
                      lambda m: f"pgs_kernel<{'float' if m[1] == 'f' else 'double'}"
                                f", L={m[2]}, K={m[3]}, exact={m[4]}>"),
        "pgs_legs": _ptxas(infos["pgs_legs"]["log"], r"pgs_legs_kernelI([fd])E",
                           lambda m: "pgs_legs_kernel<"
                                     f"{'float' if m[1] == 'f' else 'double'}>"),
        "newton": _ptxas(infos["newton"]["log"], r"newton_kernelI([fd])E",
                         lambda m: "newton_kernel<"
                                   f"{'float' if m[1] == 'f' else 'double'}>"),
    }
    for name, ks in kernels.items():
        ptxas = " | ".join(f"{k['name']}: {k.get('registers')} registers, spill "
                           f"stores/loads {k.get('spill')} B" for k in ks)
        print(f"build: {name}.cu -> {os.path.basename(infos[name]['path'])} in "
              f"{infos[name]['seconds']:.1f} s; {ptxas}")
        f32 = [k for k in ks if "<float" in k["name"]]
        if not f32 or any(k.get("spill") != [0, 0] for k in f32):
            raise AssertionError(f"float32 {name} kernels must not spill: {ks}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nefc, nv, ns, ns_offset = 112, 24, 4, 0
    geo = P.launch_geometry(nefc, nv, ns, ns_offset, 4)
    per_sm = P.envs_per_sm(geo, nv, torch.float32)
    print(f"build: pgs main path (nefc={nefc}, nv={nv}, float32): {geo.lanes} "
          f"lanes per env, {geo.envs_per_block} envs per block, "
          f"{geo.smem_bytes} B shared per block, {per_sm} envs resident per SM "
          f"x {sms} SMs = {per_sm * sms} per wave "
          f"({math.ceil(2048 / (per_sm * sms))} waves at N=2048)")
    lgeo = P.legs_geometry(nefc, 6, 3, 6, ns, ns_offset, 4)
    legs_sm = P.legs_envs_per_sm(lgeo, torch.float32)
    print(f"build: pgs_legs main path (nefc={nefc}, B=6, float32): "
          f"{P.LEG_LANES} lanes per env, {lgeo.envs_per_block} envs per block, "
          f"{lgeo.smem_bytes} B shared per block, {legs_sm} envs resident per "
          f"SM x {sms} SMs = {legs_sm * sms} per wave "
          f"({math.ceil(2048 / (legs_sm * sms))} waves at N=2048)")
    spans = ((36, 3, 8), (60, 6, 4), (84, 3, 4))
    ngeo = K.geometry(96, 18, spans, 4)
    newton_sm = K.envs_per_sm(ngeo, torch.float32)
    print(f"build: newton anymal_c (nefc=96, nv=18, cone groups {spans}, "
          f"float32): one warp per env, {ngeo.envs_per_block} envs per block, "
          f"{ngeo.smem_bytes} B shared per block, {newton_sm} envs resident "
          f"per SM x {sms} SMs = {newton_sm * sms} per wave "
          f"({math.ceil(2048 / (newton_sm * sms))} waves at N=2048)")
    if per_sm < 1 or legs_sm < 1 or newton_sm < 1:
        raise AssertionError("a kernel fits no env on an SM")


def _check_random(N, nefc, nv, ns_offset, seed, it=3, ns=4) -> None:
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P

    args = _random_system(N, nefc, nv, ns_offset, torch.float64, seed)
    f_k = P.pgs(*args, it, ns, ns_offset)
    f_p = P.pgs_reference(*args, it, ns, ns_offset)
    torch.cuda.synchronize()
    err = float((f_k - f_p).abs().max() / f_p.abs().max())
    print(f"kernel: float64 random N={N} nefc={nefc} nv={nv} "
          f"ns_offset={ns_offset}: max|err|/max|f| = {err:.3e} "
          f"(tol {F64_TOL:g})")
    if not err <= F64_TOL:
        raise AssertionError("pgs kernel disagrees with pgs_reference (float64)")


def phase_kernel() -> None:
    for ns_offset in (0, 4):                    # the main path's shapes
        _check_random(2048, 112, 24, ns_offset, 10 + ns_offset)
    _check_random(2047, 112, 24, 4, 20)         # N not a multiple of 4 envs
    _check_random(1, 112, 24, 0, 21)            # one env, three idle groups
    _check_random(64, 21, 11, 2, 22)            # plain-load panels, odd block
    _check_random(64, 40, 45, 2, 23)            # nv above 32: 32 lanes per env


def _check_random_legs(label: str, prob: dict, ns_offset: int, it=3,
                       ns=4) -> None:
    """The legs kernel, f and qacc's change, against ``_legs_plain`` on the
    card (float64, LEGS_F64_TOL), and against the dense kernel and M⁻¹Jᵀf on the
    same problem with U = J M⁻¹ (LEGS_DENSE_TOL: another factorization of
    the same A)."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P

    lay, fac, J, lm, b, R, lo, hi = args = _legs_args(prob, "cuda", torch.float64)
    f_k, dq_k = P.pgs_legs(*args, it, ns, ns_offset)
    f_p, dq_p = _legs_plain(args + (it, ns, ns_offset))
    Minv = torch.as_tensor(prob["Minv"], device="cuda")
    f_d = P.pgs(J, (J @ Minv).contiguous(), b, R, lo, hi, it, ns, ns_offset)
    dq_d = torch.einsum("nij,nj->ni", Minv, torch.einsum("nkv,nk->nv", J, f_d))
    torch.cuda.synchronize()
    scale, dscale = float(f_p.abs().max()), float(dq_p.abs().max())
    err = max(float((f_k - f_p).abs().max()) / scale,
              float((dq_k - dq_p).abs().max()) / dscale)
    dense = max(float((f_k - f_d).abs().max()) / scale,
                float((dq_k - dq_d).abs().max()) / dscale)
    N, nefc, nv = J.shape
    print(f"kernel-legs: float64 {label} N={N} nefc={nefc} (B, s, nb)="
          f"{(lay.nbranch, lay.branch_size, lay.nbase)} ns_offset={ns_offset}: "
          f"{int((~lm.has1).sum())} base-only rows, {int(lm.has2.sum())} "
          f"two-leg rows; max|err|/max|x| over f and dqacc = {err:.3e} "
          f"against the plain version (tol {LEGS_F64_TOL:g}), {dense:.3e} against "
          f"the dense kernel and M⁻¹Jᵀf (tol {LEGS_DENSE_TOL:g})")
    if not err <= LEGS_F64_TOL:
        raise AssertionError(f"pgs_legs kernel disagrees with its plain version ({label})")
    if not dense <= LEGS_DENSE_TOL:
        raise AssertionError(f"pgs_legs kernel disagrees with the dense kernel ({label})")


def _hold_legs_case(label: str, prob: dict, edit, dtype, it=3, ns=4,
                    ns_offset=0) -> None:
    """The legs kernel, f and qacc's change, against ``_legs_plain`` on the
    card on a problem whose bounds or b ``edit`` changes in place (which
    rows it sweeps, NaN): NaN at the same positions, and on the finite
    positions LEGS_F64_TOL (float64) or F32_TOL (float32) of max|f| and of
    max|dqacc|."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools.profile_pgs import list_lengths

    args = _legs_args(prob, "cuda", dtype)
    edit(*args[4:])
    f_k, dq_k = P.pgs_legs(*args, it, ns, ns_offset)
    f_p, dq_p = _legs_plain(args + (it, ns, ns_offset))
    torch.cuda.synchronize()
    tol = LEGS_F64_TOL if dtype == torch.float64 else F32_TOL
    errs, same_nan = [], True
    for k, p in ((f_k, f_p), (dq_k, dq_p)):
        same_nan = same_nan and torch.equal(torch.isnan(k), torch.isnan(p))
        fin = torch.isfinite(p)
        scale = float(p[fin].abs().max()) if bool(fin.any()) else 0.0
        diff = float((k[fin] - p[fin]).abs().max()) if bool(fin.any()) else 0.0
        errs.append(diff / (scale or 1.0))
    lo, hi = args[6], args[7]
    ls = list_lengths(lo, hi, ns_offset, ns)
    print(f"kernel-legs: {str(dtype)[6:]} {label} N={lo.shape[0]} "
          f"nefc={lo.shape[1]}: rows swept per env mean "
          f"{ls['env_rows']['mean']:.1f} (max {ls['env_rows']['max']:.0f}), "
          f"pairs {ls['env_pairs']['mean']:.1f}; NaN in f {int(torch.isnan(f_p).sum())}, "
          f"at the plain version's positions: {same_nan}; max|err|/max|x| over "
          f"the finite f and dqacc = {max(errs):.3e} (tol {tol:g})")
    if not same_nan or not max(errs) <= tol:
        raise AssertionError(f"pgs_legs kernel disagrees with its plain version ({label})")


def _pin(share: float, seed: int):
    """An edit for ``_hold_legs_case``: ``profile_pgs.pin_pairs`` in place
    (all but a share of each env's facet pairs pinned, the rest active)."""
    def edit(b, R, lo, hi):
        from nightmare_rl_tpu_torch.tools.profile_pgs import pin_pairs

        for x, y in zip((lo, hi), pin_pairs(lo, hi, share, seed)):
            x.copy_(y)
    return edit


def _legs_list_cases() -> tuple:
    """(label, edit) cases of the legs kernel's row and pair lists for
    ``_hold_legs_case``: every row active, none, an env with none beside
    full ones (the second of each warp), and a NaN in b of a pinned row
    and of an active row (two envs each, a tenth of the pairs active)."""
    def every_row(b, R, lo, hi):
        _pin(1.0, 0)(b, R, lo, hi)

    def no_row(b, R, lo, hi):
        lo.zero_()
        hi.zero_()

    def one_empty_env(b, R, lo, hi):  # the second env of every warp
        _pin(1.0, 0)(b, R, lo, hi)
        lo[1::4] = 0.0
        hi[1::4] = 0.0

    def nan_in(active: bool):
        def edit(b, R, lo, hi):
            _pin(0.1, 1)(b, R, lo, hi)
            for env in (3, lo.shape[0] - 5):
                pinned = (lo[env] == 0) & (hi[env] == 0)
                r = int(((~pinned) if active else pinned).nonzero()[0])
                b[env, r] = math.nan
        return edit

    return (("every row active", every_row), ("no row active", no_row),
            ("an env with no active row beside full ones", one_empty_env),
            ("NaN in b of a pinned row", nan_in(False)),
            ("NaN in b of an active row", nan_in(True)))


def phase_kernel_legs() -> None:
    """The legs kernel on random block-arrow problems: the main path's
    shape and its variants, the edge counts of envs, anymal_c's layout;
    then, in float64 and float32, the cases of its row and pair lists:
    every row active, none, an env with none beside full ones, and a NaN
    in b of a pinned row and of an active row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(30)
    main = (2048, 112, 6, 3, 6)
    _check_random_legs("contacts + pairs", _random_arrow_batch(
        rng, *main, npair_rows=16), 0)
    _check_random_legs("dof rows", _random_arrow_batch(
        rng, 2048, 115, 6, 3, 6, ns_offset=3, npair_rows=16), 3)
    _check_random_legs("half base-only rows", _random_arrow_batch(
        rng, *main, npair_rows=16, base_share=0.5), 0)
    _check_random_legs("same-branch pairs", _random_arrow_batch(
        rng, *main, npair_rows=16, same_branch_rows=8), 0)
    _check_random_legs("an odd env count", _random_arrow_batch(
        rng, 2047, 115, 6, 3, 6, ns_offset=3, npair_rows=16,
        same_branch_rows=4), 3)
    _check_random_legs("one env", _random_arrow_batch(
        rng, 1, 112, 6, 3, 6, npair_rows=16), 0)
    _check_random_legs("anymal-shaped", _random_arrow_batch(
        rng, 2048, 96, 4, 3, 6, ns_offset=36, npair_rows=8,
        same_branch_rows=4), 36)

    for dtype in (torch.float64, torch.float32):
        for label, edit in _legs_list_cases():
            _hold_legs_case(label, _random_arrow_batch(
                np.random.default_rng(31), *main, npair_rows=16), edit, dtype)


@contextlib.contextmanager
def _pgs_mode(mode):
    """NIGHTMARE_PGS set to mode (None: unset) inside the block."""
    prev = os.environ.pop("NIGHTMARE_PGS", None)
    if mode is not None:
        os.environ["NIGHTMARE_PGS"] = mode
    try:
        yield
    finally:
        os.environ.pop("NIGHTMARE_PGS", None)
        if prev is not None:
            os.environ["NIGHTMARE_PGS"] = prev


@contextlib.contextmanager
def _kept_pgs(name: str = "pgs"):
    """Keeps clones of the positional inputs of the last call of the
    solver's ``name`` (``pgs`` or ``pgs_legs``) in the yielded dict; the
    call goes on to the wrapper.  Inside a captured step the clones are
    nodes of the graph, so they hold the inputs of the last replay (the
    graph's pool reuses the memory of the inputs themselves)."""
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import solver
    from nightmare_rl_tpu_torch.utils.graph import clone

    last = {}
    fn = getattr(P, name)

    def kept(*args, **kw):
        last["args"] = clone(args)
        return fn(*args, **kw)

    setattr(solver, name, kept)
    try:
        yield last
    finally:
        setattr(solver, name, fn)


def _hold_kernel(label: str, args: tuple, shape: tuple) -> float:
    """The kernel against ``pgs_reference`` on the inputs that a path's last
    PGS call received (of (N, nefc, nv) ``shape``), at F32_TOL in float32
    and F64_TOL in float64; asserts a minimum share of active rows.
    Returns max|err|."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P

    J, hi = args[0], args[5]
    N, nefc, nv = J.shape
    assert tuple(J.shape) == shape and J.dtype in (torch.float32, torch.float64), (
        J.shape, J.dtype)
    tol = F32_TOL if J.dtype == torch.float32 else F64_TOL
    f_k = P.pgs(*args)
    f_p = P.pgs_reference(*args)
    torch.cuda.synchronize()
    abs_err = float((f_k - f_p).abs().max())
    rel = abs_err / float(f_p.abs().max())
    active = float((hi > 0).double().mean())
    print(f"kernel: {str(J.dtype)[6:]} {label} N={N} nefc={nefc} nv={nv}: "
          f"{active:.1%} of rows active (min {MIN_ACTIVE:.0%}), max|f| = "
          f"{float(f_p.abs().max()):.4g}, max|err| = {abs_err:.3e}, /max|f| = "
          f"{rel:.3e} (tol {tol:g})")
    if not active >= MIN_ACTIVE:
        raise AssertionError(f"the PGS inputs of {label} have too few active rows")
    if not rel <= tol or not torch.isfinite(f_k).all():
        raise AssertionError(f"pgs kernel disagrees with pgs_reference on {label}")
    return abs_err


def _time_kernel(label: str, args: tuple) -> dict:
    """CUDA-event times of the kernel and of its plain version on one call's
    float32 inputs, and the least time the card could take for it: the
    larger of its bytes (J and U, b, R, lo, hi read once, f written once)
    over the memory rate and its operations over the float32 rate."""
    from nightmare_rl_tpu_torch.ops import pgs as P

    J, U, b, R, lo, hi, it, ns, ns_offset = args
    N, nefc, nv = J.shape
    kern_ms = _cuda_ms(lambda: P.pgs(*args), reps=50)
    plain_ms = _cuda_ms(lambda: P.pgs_reference(*args), reps=3, warmup=1)
    nbytes = (2 * J.numel() + 5 * N * nefc) * J.element_size()
    ops = _pgs_ops(N, nefc, nv, it, ns, ns_offset)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    chain = it * nefc + (ns * ((nefc - ns_offset) // 2) if ns > 0 else 0)
    print(f"kernel: pgs float32 {label} N={N} nefc={nefc} nv={nv} ({it} sweeps, "
          f"{ns} noslip from row {ns_offset}): {kern_ms:.4f} ms/launch, plain "
          f"{plain_ms:.3f} ms; bound {bound * 1e3:.2f} us by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes / 1e6:.2f} "
          f"MB, {ops / 1e9:.4f} GFLOP) = {bound / kern_ms:.1%} of it; serial "
          f"chain {chain} row steps/env -> {kern_ms * 1e6 / chain:.1f} ns per step")
    return dict(ms=kern_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_main_path_kernel(args: tuple, launches: int) -> dict:
    """The kernel against its plain version on the inputs that the slice's
    last PGS call received, and both timed on them."""
    J, U, b, R, lo, hi, it, ns, ns_offset = args
    assert ns_offset == 0, ns_offset
    abs_err = _hold_kernel("main-path inputs (the slice's last call)", args,
                           (2048, 112, 24))
    t = _time_kernel("main path", args)
    return dict(
        name="pgs", route="cuda",
        source="nightmare_rl_tpu_torch/ops/csrc/pgs.cu",
        replaces="nightmare_rl_tpu/ops/pgs.py:345",
        launches=launches, max_abs_err=abs_err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
    )


def phase_physics() -> None:
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.physics import loader, pipeline

    N = 16
    res = {}
    for dev in ("cuda", "cpu"):
        sys_ = dataclasses.replace(
            loader.load_system("nightmare_v3", device=dev), max_contacts=24)
        g = torch.Generator().manual_seed(5)
        st = pipeline.make_state(sys_, N)
        qpos = st.qpos.cpu()
        qpos[:, 7:] += 0.3 * torch.randn(N, 18, generator=g, dtype=torch.float64)
        qpos[:, 2] -= 0.05
        qvel = torch.randn(N, sys_.nv, generator=g, dtype=torch.float64)
        ctrl = torch.randn(N, sys_.nu, generator=g, dtype=torch.float64)
        st = st.replace(qpos=qpos.to(dev), qvel=qvel.to(dev))
        for _ in range(3):
            st = pipeline.step(sys_, st, ctrl.to(dev), 2)
        res[dev] = st
    err = max(float((getattr(res["cuda"], f).cpu() - getattr(res["cpu"], f)).abs().max())
              for f in ("qpos", "qvel", "sensordata"))
    print(f"physics: 3 decimated steps, 16 envs, float64, card vs CPU: "
          f"max|err| = {err:.3e} (tol {PHYS_TOL:g})")
    if not err <= PHYS_TOL:
        raise AssertionError("physics on the card disagrees with the CPU")


def phase_physics_legs() -> None:
    """phase_physics in the leg-sparse form: the legs kernel on the card
    against the plain version on the CPU."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import loader, pipeline

    N = 16
    res = {}
    with _pgs_mode("legs"):
        for dev in ("cuda", "cpu"):
            sys_ = dataclasses.replace(
                loader.load_system("nightmare_v3", device=dev), max_contacts=24)
            g = torch.Generator().manual_seed(5)
            st = pipeline.make_state(sys_, N)
            qpos = st.qpos.cpu()
            qpos[:, 7:] += 0.3 * torch.randn(N, 18, generator=g, dtype=torch.float64)
            qpos[:, 2] -= 0.05
            qvel = torch.randn(N, sys_.nv, generator=g, dtype=torch.float64)
            ctrl = torch.randn(N, sys_.nu, generator=g, dtype=torch.float64)
            st = st.replace(qpos=qpos.to(dev), qvel=qvel.to(dev))
            P.pgs_legs.launches = P.pgs.launches = 0
            for _ in range(3):
                st = pipeline.step(sys_, st, ctrl.to(dev), 2)
            res[dev] = st, P.pgs_legs.launches, P.pgs.launches
    (card, legs, dense), cpu = res["cuda"], res["cpu"][0]
    err = max(float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
              for f in ("qpos", "qvel", "sensordata"))
    print(f"physics-legs: 3 decimated steps, 16 envs, float64, NIGHTMARE_PGS=legs, "
          f"card vs CPU: max|err| = {err:.3e} (tol {PHYS_TOL:g}); pgs_legs "
          f"launches {legs} (expected 6), pgs {dense}")
    if not err <= PHYS_TOL:
        raise AssertionError("legs physics on the card disagrees with the CPU")
    if legs != 6 or dense != 0:
        raise AssertionError("the legs form did not run on every substep")


def phase_slice(device_name: str, smi: str, tmp: str) -> tuple:
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import train

    iters, envs = 2, 2048
    with _kept_pgs() as last:
        P.pgs.launches = 0
        t0 = time.perf_counter()
        runner = train.main(["-e", str(envs), "-n", str(iters), "--log_root",
                             tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = P.pgs.launches
    saved = sorted(f for d, _, fs in os.walk(tmp) for f in fs)
    stats = runner.last_stats
    T = runner.cfg.runner.num_steps_per_env
    dec = runner.env.cfg.control.decimation
    # + the reset's zero-action step and the rollout graph's warm-up step
    expected = iters * T * dec + dec + GRAPH_WARMUP * dec
    iter_s = stats["rollout_s"] + stats["update_s"]
    rate = T * envs / iter_s
    print(f"slice: {iters} PPO iterations x {T} steps x {envs} envs float32: "
          f"loss {stats['loss']:.4f}, kl {stats['kl']:.4f}, pgs launches "
          f"{launches} (expected {expected}); last iteration rollout "
          f"{stats['rollout_s']:.3f} s + update {stats['update_s']:.3f} s = "
          f"{rate:,.0f} env-steps/s (smoke figure, {device_name}, {smi}); "
          f"wall {wall:.1f} s incl. set-up; saved {saved}")
    if not math.isfinite(stats["loss"]):
        raise AssertionError("non-finite PPO loss")
    if launches != expected:
        raise AssertionError(f"pgs kernel ran {launches} times, expected {expected}")
    if not torch.isfinite(runner.ppo.obs).all():
        raise AssertionError("non-finite observations")
    return launches, last["args"], runner


def _leaves_equal(a, b) -> bool:
    """Every tensor of two trees equal bit for bit (NaN where NaN)."""
    import torch

    from nightmare_rl_tpu_torch.utils.graph import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and bool(torch.all(
            (x == y) | (torch.isnan(x) & torch.isnan(y))
            if x.is_floating_point() else x == y))
        for x, y in zip(la, lb))


def phase_graph(device_name: str, smi: str) -> dict:
    """The env step captured as a CUDA graph (utils/graph.py) against the
    plain env step, at 2048 envs in float32, in the leg-sparse and in the
    dense-kernel form: from one state and one generator state,
    GRAPH_STEPS steps eager and as replays; every StepOut field equal bit
    for bit at every step, the env's generator equal after both runs, no
    host sync in a replay, the form's kernel launched ``decimation`` times
    per replay (the other never); then wall ms per env step in turns
    (eager, graph, graph, eager).  Returns, per form, those times, the
    capture's seconds and the graph's pool MiB."""
    import torch

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    if CapturedStep.WARMUP != GRAPH_WARMUP:
        raise AssertionError("GRAPH_WARMUP is not CapturedStep.WARMUP")
    N, res = 2048, {}
    for form, counter, other in (("legs", P.pgs_legs, P.pgs),
                                 ("kernel", P.pgs, P.pgs_legs)):
        t0 = time.perf_counter()
        with _pgs_mode(form):
            env = NightmareV3Env(NightmareV3Cfg().replace(
                env=EnvCfg(num_envs=N)), device="cuda")
            dec = env.cfg.control.decimation
            s0, _ = env.reset(0)
            g = torch.Generator(device="cuda").manual_seed(11)
            acts = [0.3 * torch.randn(N, 18, device="cuda", generator=g)
                    for _ in range(GRAPH_STEPS)]
            gen0 = env.generator.get_state()
            eager, state = [], s0
            for a in acts:
                out = env.step(state, a)
                eager.append(clone(out))
                state = out.state
            gen_eager = env.generator.get_state()
            env.generator.set_state(gen0)

            P.pgs.launches = P.pgs_legs.launches = 0
            t1 = time.perf_counter()
            step = CapturedStep(env.step, s0, acts[0],
                                generators=[env.generator], state_field="state")
            capture_s = time.perf_counter() - t1
            warm = counter.launches
            differ, state = [], s0
            for k, a in enumerate(acts):
                out = step(state, a)
                differ += [(k, f) for f in out._fields
                           if not _leaves_equal(getattr(out, f),
                                                getattr(eager[k], f))]
                state = out.state
            per_replay = (counter.launches - warm) / GRAPH_STEPS
            same_gen = torch.equal(env.generator.get_state(), gen_eager)
            syncs = _host_syncs(lambda: step(state, acts[0]))
            walls = {"eager": [], "graph": []}
            for who in ("eager", "graph", "graph", "eager"):
                walls[who].append(_env_step_ms(
                    env.step if who == "eager" else step, s0, acts))
        pool = step.pool_bytes / 2**20
        print(f"graph: {form} form, {N} envs float32, {GRAPH_STEPS} env steps "
              f"eager and as replays of one captured step from one state: "
              f"StepOut fields equal bit for bit at every step: {not differ} "
              f"(differing {differ[:6]}); env generator state equal "
              f"{same_gen}; host syncs per replay {syncs}; "
              f"{counter.__name__} launches per replay {per_replay:g} "
              f"(expected {dec}), {other.__name__} {other.launches}; warm-up "
              f"{warm}; capture {capture_s:.2f} s (warm-up included), graph "
              f"pool {pool:.1f} MiB; wall ms per env step in turns (eager, "
              f"graph, graph, eager): {walls['eager'][0]:.2f}, "
              f"{walls['graph'][0]:.2f}, {walls['graph'][1]:.2f}, "
              f"{walls['eager'][1]:.2f}; {_smi_line(t0, device_name, smi)}")
        if differ or not same_gen:
            raise AssertionError(f"the replayed {form} step differs from the "
                                 f"eager one: {differ[:6]}, generator equal "
                                 f"{same_gen}")
        if syncs or per_replay != dec or other.launches:
            raise AssertionError(f"a {form} replay synchronized ({syncs}) or "
                                 f"launched {per_replay} {counter.__name__} "
                                 f"and {other.launches} {other.__name__}")
        res[form] = dict(eager_ms=walls["eager"], graph_ms=walls["graph"],
                         capture_s=capture_s, pool_mib=pool)
    return res


def phase_slice_rates(runner, device_name: str, smi: str) -> None:
    """The slice's PPO after the slice: its rollout of T steps at 2048 envs
    as replays of the captured rollout step and as eager calls of the step
    that the graph holds, in turns (eager, graph, graph, eager), each from
    the state the one before left: env-steps/s of the rollout alone, and of
    the iteration with the slice's last update time."""
    import torch

    t0 = time.perf_counter()
    ppo = runner.ppo
    T, N = ppo.cfg.runner.num_steps_per_env, ppo.env.num_envs
    update_s = runner.last_stats["update_s"]

    def eager():
        carry = (ppo.env_state, ppo.obs, ppo.hidden, *ppo._zeros)
        with torch.no_grad():
            for _ in range(T):
                carry = ppo._rollout_step(carry)
        ppo.set_rollout_state(*carry[:3])

    secs = {"eager": [], "graph": []}
    for who in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager() if who == "eager" else ppo.rollout()
        torch.cuda.synchronize()
        secs[who].append(time.perf_counter() - t1)
    if not torch.isfinite(ppo.obs).all():
        raise AssertionError("non-finite observations after the rollouts")
    rate = {k: [T * N / x for x in v] for k, v in secs.items()}
    it = {k: [T * N / (x + update_s) for x in v] for k, v in secs.items()}
    print(f"slice: rollout of {T} steps x {N} envs float32 (recording on), "
          f"in turns (eager, graph, graph, eager): {secs['eager'][0]:.3f}, "
          f"{secs['graph'][0]:.3f}, {secs['graph'][1]:.3f}, "
          f"{secs['eager'][1]:.3f} s = rollout env-steps/s eager "
          f"{rate['eager'][0]:,.0f} / {rate['eager'][1]:,.0f}, graph "
          f"{rate['graph'][0]:,.0f} / {rate['graph'][1]:,.0f}; with the "
          f"slice's update ({update_s:.3f} s) an iteration runs eager "
          f"{it['eager'][0]:,.0f} / {it['eager'][1]:,.0f}, graph "
          f"{it['graph'][0]:,.0f} / {it['graph'][1]:,.0f} env-steps/s; "
          f"{_smi_line(t0, device_name, smi)}")


def phase_graph_anymal(device_name: str, smi: str) -> dict:
    """anymal_c's env step (Newton, elliptic cones, decimation 4) captured
    as a CUDA graph against the plain env step at 2048 envs in float32:
    from one state and one generator state, ANYMAL_GRAPH_STEPS steps eager
    and as replays, every StepOut field equal bit for bit at every step,
    the env's generator equal after both runs, no host sync in a replay,
    ``decimation`` launches of the Newton kernel per replay; then wall ms
    per env step in turns (eager, graph, graph, eager), the warm-up's and
    the capture's seconds, the graph's pool and its nodes by type.  Returns
    the kernel's launches in the phase with the rest."""
    import torch

    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
    from nightmare_rl_tpu_torch.ops.newton import newton_solve
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    N, steps = 2048, ANYMAL_GRAPH_STEPS
    t0 = time.perf_counter()
    newton_solve.launches = 0
    env = AnymalCEnv(AnymalCCfg(num_envs=N), device="cuda")
    if not env.graph_step:
        raise AssertionError("AnymalCEnv.graph_step is off")
    s0, _ = env.reset(0)
    g = torch.Generator(device="cuda").manual_seed(12)
    acts = [0.3 * torch.randn(N, 12, device="cuda", generator=g)
            for _ in range(steps)]
    gen0 = env.generator.get_state()
    eager, state = [], s0
    for a in acts:
        out = env.step(state, a)
        eager.append(clone(out))
        state = out.state
    gen_eager = env.generator.get_state()
    env.generator.set_state(gen0)

    step = CapturedStep(env.step, s0, acts[0], generators=[env.generator],
                        state_field="state", debug=True)
    nodes = step.node_counts()
    differ, state = [], s0
    for k, a in enumerate(acts):
        out = step(state, a)
        differ += [(k, f) for f in out._fields
                   if not _leaves_equal(getattr(out, f), getattr(eager[k], f))]
        state = out.state
    same_gen = torch.equal(env.generator.get_state(), gen_eager)
    per_replay = step.launches.get("newton_solve", 0)
    dones = int(sum(int(o.done.sum()) for o in eager))
    syncs = _host_syncs(lambda: step(state, acts[0]))
    walls = {"eager": [], "graph": []}
    timed = acts[:ANYMAL_TIMED_STEPS]
    for who in ("eager", "graph", "graph", "eager"):
        walls[who].append(_env_step_ms(env.step if who == "eager" else step,
                                       s0, timed))
    pool = step.pool_bytes / 2**20
    print(f"graph-anymal: {N} envs float32, Newton {env.sys.solver_iterations} "
          f"iterations, decimation {env.cfg.decimation}, {steps} env steps "
          f"eager and as replays of one captured step from one state "
          f"({dones} resets): StepOut fields equal bit for bit at every step: "
          f"{not differ} (differing {differ[:6]}); env generator state equal "
          f"{same_gen}; host syncs per replay {syncs}; newton kernel "
          f"launches per replay {per_replay}; the graph holds "
          f"{nodes.get('KERNEL', 0)} kernel nodes ({sum(nodes.values())} "
          f"nodes: {nodes}); warm-up step "
          f"{step.warmup_s:.2f} s, capture and instantiation "
          f"{step.capture_s:.2f} s (recording {step.record_s:.2f} s), graph "
          f"pool {pool:.1f} MiB; wall ms per "
          f"env step in turns (eager, graph, graph, eager; "
          f"{ANYMAL_TIMED_STEPS} steps each): {walls['eager'][0]:.2f}, "
          f"{walls['graph'][0]:.2f}, {walls['graph'][1]:.2f}, "
          f"{walls['eager'][1]:.2f}; {_smi_line(t0, device_name, smi)}")
    if differ or not same_gen:
        raise AssertionError(f"the replayed anymal_c step differs from the "
                             f"eager one: {differ[:6]}, generator equal "
                             f"{same_gen}")
    if syncs:
        raise AssertionError(f"an anymal_c replay synchronized {syncs} times")
    if per_replay != env.cfg.decimation:
        raise AssertionError(f"an anymal_c replay launches the newton kernel "
                             f"{per_replay} times, not {env.cfg.decimation}")
    return dict(eager_ms=walls["eager"], graph_ms=walls["graph"],
                capture_s=step.capture_s, record_s=step.record_s,
                warmup_s=step.warmup_s, pool_mib=pool, nodes=nodes,
                launches=newton_solve.launches)


def _hold_learner(ppo) -> dict:
    """A PPO's learning half (``PPO._learn``: V of the last observations,
    GAE, the permutation, the 5×4 update) as its training replayed it (the
    ``CapturedLearn`` that ``ppo._learner`` keeps: the parts split at the
    reductions over the ranks, the reductions between them) against the
    same function called eagerly, each from the PPO's state (parameters,
    gradients, Adam's state, lr and generator, restored in place before
    each) on its last trajectory; then seconds per call in turns (eager,
    graph, graph, eager), each from that state, which is left as it was.
    Under a mesh every rank calls this in step (both calls reduce).
    Returns both results (host copies of the held tensors by group, the
    statistics, ``PPO.last_perm`` and the generator's state), the seconds,
    the host syncs made inside the parts during one captured call (the
    reductions between them left out; None on the CPU), and each part's
    warm-up, capture and pool."""
    import warnings

    import torch

    from nightmare_rl_tpu_torch.rl.ppo import CapturedLearn, Parts
    from nightmare_rl_tpu_torch.utils.device import full_float32
    from nightmare_rl_tpu_torch.utils.graph import clone

    cuda = ppo.device.type == "cuda"
    held = ppo._held()
    n = len(ppo.params)
    groups = {"params": (0, n), "grads": (n, 2 * n),
              "adam": (2 * n, len(held) - 1), "lr": (len(held) - 1, len(held))}
    start = [h.detach().clone() for h in held]
    gen0 = ppo.generator.get_state()
    inputs = (ppo._traj, ppo.obs, ppo.hidden, clone(ppo.hidden))
    cap = ppo._learner(*inputs)
    if not isinstance(cap, CapturedLearn) or (cuda and cap.graph is None):
        raise AssertionError("the training did not capture its learning half")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def restore():
        with torch.no_grad():
            for h, x in zip(held, start):
                h.copy_(x)
        ppo.generator.set_state(gen0)

    def eager():
        with full_float32():
            return ppo._learn(*inputs)

    def result(stats):
        sync()
        out = {k: [h.detach().cpu().clone() for h in held[a:b]]
               for k, (a, b) in groups.items()}
        out.update(stats=stats.cpu().clone(), perm=ppo.last_perm.cpu().clone(),
                   generator=ppo.generator.get_state())
        return out

    syncs = [] if cuda else None

    def counted(part):
        def call(*args):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return part(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    syncs.append(sum("synchroniz" in str(w.message)
                                     for w in caught))
        return call

    secs = {"eager": [], "graph": []}
    try:
        restore()
        ref = result(eager())
        restore()
        got = result(cap(*inputs))
        if cuda:
            restore()
            sync()
            ppo._learn(*inputs, parts=Parts(*map(counted, cap.parts)))
            sync()
        for who in ("eager", "graph", "graph", "eager"):
            restore()
            sync()
            t1 = time.perf_counter()
            eager() if who == "eager" else cap(*inputs)
            sync()
            secs[who].append(time.perf_counter() - t1)
    finally:
        restore()
    return {"eager": ref, "graph": got, "secs": secs,
            "syncs": None if syncs is None else sum(syncs),
            "parts": {name: {k: getattr(part, k) for k in (
                "warmup_s", "capture_s", "record_s", "pool_bytes")}
                for name, part in zip(Parts._fields, cap.parts)},
            **{k: getattr(cap, k) for k in ("warmup_s", "capture_s",
                                            "record_s", "pool_bytes")}}


def _learner_diffs(held: dict) -> dict:
    """``_hold_learner``'s two results compared: per part of the state,
    (equal bit for bit, max |difference|)."""
    import torch

    ref, got = held["eager"], held["graph"]
    diffs = {}
    for k in ("params", "grads", "adam", "lr", "stats", "perm", "generator"):
        a, b = ref[k], got[k]
        pairs = list(zip(a, b)) if isinstance(a, list) else [(a, b)]
        diffs[k] = (all(torch.equal(x, y) for x, y in pairs), max(
            float((x.double() - y.double()).abs().max()) for x, y in pairs))
    return diffs


def _learner_line(held: dict) -> str:
    """The capture's seconds and pools, per part and in all."""
    parts = ", ".join(f"{k} {v['capture_s']:.3f} s / "
                      f"{v['pool_bytes'] / 2**20:.1f} MiB"
                      for k, v in held["parts"].items())
    return (f"warm-ups {held['warmup_s']:.3f} s, capture and instantiation "
            f"{held['capture_s']:.3f} s (recording {held['record_s']:.3f} s), "
            f"pools {held['pool_bytes'] / 2**20:.1f} MiB (per part: {parts})")


def phase_update_graph(runner, label: str, device_name: str, smi: str) -> dict:
    """A slice's learning half as the slice replayed it against eager
    (``_hold_learner``): the statistics, parameters, gradients, Adam's
    moments and step counts, the lr, the permutation and the generator's
    state equal bit for bit, no host sync inside the parts; seconds per
    update in turns."""
    from nightmare_rl_tpu_torch.rl.ppo import STAT_KEYS

    t0 = time.perf_counter()
    ppo = runner.ppo
    held = _hold_learner(ppo)
    diffs = _learner_diffs(held)
    secs = held["secs"]
    stats = dict(zip(STAT_KEYS, held["graph"]["stats"].tolist()))
    print(f"update-graph ({label}): {ppo.env.num_envs} envs x "
          f"{ppo.cfg.runner.num_steps_per_env} steps, the slice's captured "
          f"update against eager from the slice's state: equal bit for bit "
          f"{ {k: v[0] for k, v in diffs.items()} }, max |difference| "
          f"{ {k: v[1] for k, v in diffs.items()} }; loss "
          f"{stats['loss']:.6f}, kl {stats['kl']:.6f}, lr {stats['lr']:.3e}; "
          f"host syncs inside the parts {held['syncs']}; {_learner_line(held)}; "
          f"seconds per update in turns (eager, graph, graph, eager): "
          f"{secs['eager'][0]:.4f}, {secs['graph'][0]:.4f}, "
          f"{secs['graph'][1]:.4f}, {secs['eager'][1]:.4f}; "
          f"{_smi_line(t0, device_name, smi)}")
    if not all(v[0] for v in diffs.values()):
        raise AssertionError(f"the captured update differs from the eager "
                             f"one: {diffs}")
    if held["syncs"] != 0:
        raise AssertionError(f"the captured parts synced {held['syncs']} times")
    return secs


def _hold_legs(label: str, args: tuple) -> float:
    """The legs kernel, f and qacc's change, against ``_legs_plain`` on the
    inputs of a path's last call, float32 at F32_TOL of max|f| (and of
    max|dqacc|) with at least MIN_ACTIVE of the rows active.  Returns
    max|err| of f."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P

    lay, fac, J, lm, b, R, lo, hi, it, ns, ns_offset = args
    f_k, dq_k = P.pgs_legs(*args)
    f_p, dq_p = _legs_plain(args)
    torch.cuda.synchronize()
    abs_err = float((f_k - f_p).abs().max())
    rel = abs_err / float(f_p.abs().max())
    dq_rel = float((dq_k - dq_p).abs().max()) / float(dq_p.abs().max())
    active = float((hi > 0).double().mean())
    N, nefc, nv = J.shape
    print(f"kernel-legs: {str(J.dtype)[6:]} {label} N={N} nefc={nefc} nv={nv}: "
          f"{active:.1%} of rows active (min {MIN_ACTIVE:.0%}), "
          f"{int((~lm.has1).sum())} base-only rows, max|f| = "
          f"{float(f_p.abs().max()):.4g}, max|err| = {abs_err:.3e}, /max|f| = "
          f"{rel:.3e}; dqacc /max|dqacc| = {dq_rel:.3e} (tol "
          f"{F32_TOL if J.dtype == torch.float32 else F64_TOL:g})")
    tol = F32_TOL if J.dtype == torch.float32 else F64_TOL
    if not active >= MIN_ACTIVE:
        raise AssertionError(f"the legs inputs of {label} have too few active rows")
    if (not rel <= tol or not dq_rel <= tol or not torch.isfinite(f_k).all()
            or not torch.isfinite(dq_k).all()):
        raise AssertionError(f"pgs_legs kernel disagrees with its plain version on {label}")
    return abs_err


def _time_legs(args: tuple) -> dict:
    """CUDA-event times on one legs call's float32 inputs: the legs kernel
    with its qacc epilogue (as the step runs it), its plain version, and
    the dense form on the same system with what the step runs for it (M⁻¹
    from the factor, U = J M⁻¹, the pgs kernel, M⁻¹ Jᵀ f; and the pgs
    kernel alone).  The legs bound: the bytes the function needs over the
    memory rate against its operations over the float32 rate.  Each input
    is read once and each output (f, dqacc) written once; of J only the
    values the rows' masks select count (a row's 6 base columns, and 3 for
    each slot whose mask is set: this run's data, at most 12 of 24)."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import arrow
    from nightmare_rl_tpu_torch.utils.device import full_float32

    lay, fac, J, lm, b, R, lo, hi, it, ns, ns_offset = args
    N, nefc, nv = J.shape
    U = (J @ arrow.inv(lay, fac)).contiguous()

    def dense():
        with full_float32():
            Minv = arrow.inv(lay, fac)
            f = P.pgs(J, J @ Minv, b, R, lo, hi, it, ns, ns_offset)
            return torch.einsum("nij,nj->ni", Minv,
                                torch.einsum("nkv,nk->nv", J, f))

    legs_ms = _cuda_ms(lambda: P.pgs_legs(*args), reps=50)
    dense_ms = _cuda_ms(dense, reps=50)
    pgs_ms = _cuda_ms(lambda: P.pgs(J, U, b, R, lo, hi, it, ns, ns_offset), reps=50)
    plain_ms = _cuda_ms(lambda: _legs_plain(args), reps=3, warmup=1)
    item = J.element_size()
    s, nb = lay.branch_size, lay.nbase
    j_vals = (nb * N * nefc
              + s * int(lm.has1.sum().item() + lm.has2.sum().item()))
    nbytes = ((j_vals + fac.Ld.numel() + fac.W.numel() + fac.Ls.numel()
               + 5 * N * nefc + N * nv) * item
              + 2 * N * nefc * 4 + 2 * N * nefc)
    ops = _pgs_legs_ops(N, nefc, lay.nbranch, it, ns, ns_offset)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    chain = it * nefc + (ns * ((nefc - ns_offset) // 2) if ns > 0 else 0)
    # what device memory moves for those values: the 32-byte sectors of J
    # that hold them, and the other inputs and outputs whole
    cols = torch.cat([torch.arange(nb, device=J.device).expand(N, nefc, nb)]
                     + [torch.where(m[..., None], nb + s * ids.long()[..., None]
                                    + torch.arange(s, device=J.device), 0)
                        for ids, m in ((lm.leg1, lm.has1), (lm.leg2, lm.has2))],
                     dim=-1)
    row0 = torch.arange(N * nefc, device=J.device).view(N, nefc, 1) * nv
    sec = ((row0 + cols) * item // 32).sort(dim=-1).values
    j_sectors = int(N * nefc + (sec[..., 1:] != sec[..., :-1]).sum())
    moved = nbytes + 32 * j_sectors - j_vals * item
    print(f"kernel-legs: float32 main path: J's needed values lie in "
          f"{j_sectors / (N * nefc):.2f} sectors of 32 B a row; with the "
          f"other operands whole, {moved / 1e6:.2f} MB move, "
          f"{moved / H100_BYTES_PER_S * 1e6:.2f} us at the card's memory rate")
    print(f"kernel-legs: float32 main path N={N} nefc={nefc} nv={nv} ({it} "
          f"sweeps, {ns} noslip): {legs_ms:.4f} ms/launch, plain {plain_ms:.3f} "
          f"ms; bound {bound * 1e3:.2f} us by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes / 1e6:.2f} "
          f"MB, {ops / 1e9:.4f} GFLOP) = {bound / legs_ms:.1%} of it; serial "
          f"chain {chain} row steps/env -> {legs_ms * 1e6 / chain:.1f} ns per "
          f"step; J values needed {j_vals / (N * nefc):.2f} per row of {nv}; "
          f"dense form on the same system: arrow.inv + J @ Minv + pgs + "
          f"M⁻¹Jᵀf {dense_ms:.4f} ms, pgs alone {pgs_ms:.4f} ms")
    return dict(ms=legs_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                dense_ms=dense_ms, pgs_ms=pgs_ms)


def _print_lists(args: tuple) -> None:
    """The rows and pairs that the legs kernel sweeps on one call's inputs:
    per env and per warp of 4 envs (which walks its longest lists)."""
    from nightmare_rl_tpu_torch.tools.profile_pgs import list_lengths

    lo, hi, ns_offset = args[6], args[7], args[10]
    ls = list_lengths(lo, hi, ns_offset, args[9])

    def q(d):
        return (f"mean {d['mean']:.2f}, p50 {d['p50']:.0f}, p99 "
                f"{d['p99']:.1f}, max {d['max']:.0f}")

    it, ns = args[8], args[9]
    print(f"kernel-legs: main-path inputs, {ls['nefc']} rows and "
          f"{ls['npairs']} pairs per env: rows swept per env {q(ls['env_rows'])}; "
          f"pairs {q(ls['env_pairs'])}; per warp rows {q(ls['warp_rows'])}; "
          f"pairs {q(ls['warp_pairs'])}; the slowest warp's chain "
          f"{it * ls['warp_rows']['max'] + ns * ls['warp_pairs']['max']:.0f} "
          f"steps of {it * ls['nefc'] + ns * ls['npairs']}")


def _legs_in_turns(args: tuple) -> None:
    """The legs kernel and its earlier design that swept every row (built
    from LEGS_EARLIER_SRC where a copy was put; the repo does not hold it)
    on one call's float32 inputs, device ms per launch in turns
    (``profile_pgs._device_us``: the
    launches queued behind a spin kernel, so the host's pace is left out):
    earlier, current, current, earlier; with every row made active too
    (the worst case)."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import profile_pgs

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       LEGS_EARLIER_SRC)
    if not os.path.exists(src):
        print(f"kernel-legs: no {LEGS_EARLIER_SRC}: the earlier design is not "
              f"timed in turns")
        return
    other = profile_pgs.load_other(src)
    lay, fac, J, lm, b, R, lo, hi, it, ns, ns_offset = args
    hi_all = torch.where((lo == 0) & (hi == 0), torch.full_like(hi, math.inf), hi)
    for label, a in (("main-path inputs", args),
                     ("every row active", (lay, fac, J, lm, b, R, lo, hi_all,
                                           it, ns, ns_offset))):
        f_o, _ = profile_pgs.call_other(other, *a)
        f_n, _ = P.pgs_legs(*a)
        torch.cuda.synchronize()
        diff = float((f_o - f_n).abs().max() / f_n.abs().max())
        ms = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            fn = ((lambda: P.pgs_legs(*a)) if who == "current"
                  else (lambda: profile_pgs.call_other(other, *a)))
            ms[who].append(profile_pgs._device_us(fn, reps=100) / 1e3)
        print(f"kernel-legs: float32 {label}, the design that swept every "
              f"row against this one in turns (earlier, current, current, "
              f"earlier): "
              f"{ms['earlier'][0]:.4f}, {ms['current'][0]:.4f}, "
              f"{ms['current'][1]:.4f}, {ms['earlier'][1]:.4f} ms per launch "
              f"(current / earlier {sum(ms['current']) / sum(ms['earlier']):.3f}); "
              f"f apart by {diff:.3e} of max|f|")


def _env_step_ms(step, state, acts) -> float:
    """Wall ms per env step of ``step`` (``env.step``, or a captured step)
    from ``state`` over the actions."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        state = step(state, a).state
    torch.cuda.synchronize()
    if not torch.isfinite(state.phys.qpos).all():
        raise AssertionError("non-finite env steps")
    return (time.perf_counter() - t0) * 1e3 / len(acts)


def phase_slice_legs(device_name: str, smi: str) -> dict:
    """The training CLI's path in the leg-sparse form (NIGHTMARE_PGS=legs):
    nightmare_v3, 2048 envs, float32, reset + 1 PPO iteration, the legs
    kernel on every substep and no dense one; the kernel held on the inputs
    of its last call and timed beside the dense form; then env steps timed
    in both forms, in turns, from one settled state."""
    import torch

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import pipeline
    from nightmare_rl_tpu_torch.tools import train

    t0 = time.perf_counter()
    envs = 2048
    with tempfile.TemporaryDirectory() as tmp, _pgs_mode("legs"), \
            _kept_pgs("pgs_legs") as last:
        P.pgs_legs.launches = P.pgs.launches = 0
        runner = train.main(["-e", str(envs), "-n", "1", "--log_root", tmp])
        torch.cuda.synchronize()
        launches, dense = P.pgs_legs.launches, P.pgs.launches
    stats = runner.last_stats
    T = runner.cfg.runner.num_steps_per_env
    dec = runner.env.cfg.control.decimation
    # + the reset's zero-action step and the rollout graph's warm-up step
    expected = T * dec + dec + GRAPH_WARMUP * dec
    rate = T * envs / (stats["rollout_s"] + stats["update_s"])
    print(f"slice-legs: 1 PPO iteration x {T} steps x {envs} envs float32, "
          f"NIGHTMARE_PGS=legs: loss {stats['loss']:.4f}, kl {stats['kl']:.4f}, "
          f"pgs_legs launches {launches} (expected {expected}), pgs {dense}; "
          f"rollout {stats['rollout_s']:.3f} s + update {stats['update_s']:.3f} "
          f"s = {rate:,.0f} env-steps/s (smoke figure, recording on); "
          f"{_smi_line(t0, device_name, smi)}")
    if not math.isfinite(stats["loss"]) or not torch.isfinite(runner.ppo.obs).all():
        raise AssertionError("legs PPO: non-finite loss or observations")
    if launches != expected or dense != 0:
        raise AssertionError(f"pgs_legs ran {launches} times (expected "
                             f"{expected}), pgs {dense}")
    del runner
    args = last["args"]
    abs_err = _hold_legs("main-path inputs (slice-legs' last call)", args)
    _print_lists(args)
    t = _time_legs(args)
    _legs_in_turns(args)

    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=envs)),
                         device="cuda")
    settled, _ = env.reset(0)
    n = env.num_envs
    with _pgs_mode("kernel"):
        for _ in range(SETTLE_STEPS):
            settled = env.step(settled, torch.zeros(n, 18, device="cuda")).state
    g = torch.Generator(device="cuda").manual_seed(9)
    acts = 0.3 * torch.randn(LEGS_STEPS, n, 18, device="cuda", generator=g)
    walls, syncs = {"legs": [], "kernel": []}, {}
    for mode in ("legs", "kernel", "kernel", "legs"):
        with _pgs_mode(mode):
            walls[mode].append(_env_step_ms(env.step, settled, acts))
            syncs[mode] = _host_syncs(lambda: pipeline.step(
                env.sys, settled.phys, torch.zeros(n, 18, device="cuda"), 1))
    print(f"slice-legs: env step at {n} envs float32 after {SETTLE_STEPS} "
          f"settling steps, {LEGS_STEPS} steps of random actions per run, in "
          f"turns: legs {', '.join(f'{w:.1f}' for w in walls['legs'])} ms, dense "
          f"(kernel) {', '.join(f'{w:.1f}' for w in walls['kernel'])} ms; host "
          f"syncs in one physics substep: legs {syncs['legs']}, dense "
          f"{syncs['kernel']}; {_smi_line(t0, device_name, smi)}")
    return dict(name="pgs_legs", route="cuda",
                source="nightmare_rl_tpu_torch/ops/csrc/pgs_legs.cu",
                replaces="nightmare_rl_tpu/ops/pgs.py:133",
                launches=launches, max_abs_err=abs_err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


def phase_probe(device_name: str, smi: str, tmp: str) -> None:
    """The unpinned default on the card: the solver-form probe at the main
    path's key, measured afresh into a cache file of its own, then read
    back from that file by a fresh dispatch."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.core.config import NightmareV3Cfg
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import loader, solver
    from nightmare_rl_tpu_torch.physics import system as S

    t0 = time.perf_counter()
    sys_ = dataclasses.replace(
        S.tree_cast(loader.load_system("nightmare_v3", device="cuda"),
                    torch.float32),
        max_contacts=NightmareV3Cfg().solver.max_contacts)
    cache = os.path.join(tmp, "probe.json")
    env = dict(NIGHTMARE_PROBE_CACHE=cache, NIGHTMARE_PROBE="reprobe",
               NIGHTMARE_PROBE_N="2048")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with _pgs_mode(None):
            P._MODE_CACHE.clear()
            verdict = solver.prewarm(sys_, "cuda")
            times = dict(P.last_probe)
            os.environ.pop("NIGHTMARE_PROBE")
            P._MODE_CACHE.clear()
            P.last_probe.clear()
            again = solver.prewarm(sys_, "cuda")
            reprobed = bool(P.last_probe)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    with open(cache) as fh:
        stored = json.load(fh)
    print(f"probe: unpinned default at the main path's key (nefc="
          f"{solver._row_count(sys_)}, float32), N={times.get('N')}: verdict "
          f"'{verdict}'; candidate ms (wall, synchronized, least of 3 after the "
          f"first): {', '.join(f'{k} {v:.4f}' for k, v in times['ms'].items())}; "
          f"read back from the cache file: '{again}' (probed again: {reprobed}); "
          f"{len(stored)} entry in {os.path.basename(cache)}; "
          f"{_smi_line(t0, device_name, smi)}")
    if verdict not in ("legs", "kernel") or set(times["ms"]) != {"legs", "kernel"}:
        raise AssertionError(f"the probe chose {verdict!r} from {times}")
    if again != verdict or reprobed:
        raise AssertionError("the cached verdict was not read back")


def phase_policy(obs) -> None:
    import torch

    from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "model_3176.pt")
    sd = torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]
    outs = {}
    for dev in ("cuda", "cpu"):
        net = ActorCritic(66, 18).to(dev)
        net.load_state_dict(sd)
        with torch.no_grad():
            outs[dev] = net.act_inference(obs.to(dev).float()).cpu()
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    print(f"policy: model_3176.pt on {tuple(obs.shape)} observations, card vs "
          f"CPU max|err| = {err:.3e} (tol 1e-4)")
    if not (torch.isfinite(outs["cuda"]).all() and err <= 1e-4):
        raise AssertionError("policy inference on the card disagrees with the CPU")


def _anymal_system(dev, iterations: int):
    import dataclasses

    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg
    from nightmare_rl_tpu_torch.physics import loader

    return dataclasses.replace(loader.load_system("anymal_c", device=dev),
                               solver_iterations=iterations,
                               max_contacts=AnymalCCfg().max_contacts)


def _rel(ref, x) -> float:
    """max|ref - x| / max(1, max|ref|), on the CPU."""
    ref, x = ref.cpu(), x.cpu()
    return float((ref - x).abs().max() / max(1.0, float(ref.abs().max())))


def phase_physics_anymal() -> None:
    import torch

    from nightmare_rl_tpu_torch.physics import newton, pipeline

    N, dev = 16, "cuda"
    t0 = time.perf_counter()
    sys_ = {d: _anymal_system(d, ANYMAL_PHYS_ITERATIONS) for d in (dev, "cpu")}
    g = torch.Generator().manual_seed(3)
    st = pipeline.make_state(sys_["cpu"], N)
    qpos = st.qpos.clone()
    qpos[:, 7:] += 0.05 * torch.randn(N, 12, generator=g, dtype=torch.float64)
    # velocities from 0 (feet that stick) to 0.3 (feet that slide) over envs
    qvel = (0.3 * torch.linspace(0.0, 1.0, N, dtype=torch.float64)[:, None]
            * torch.randn(N, 18, generator=g, dtype=torch.float64))
    st = st.replace(qpos=qpos, qvel=qvel)
    q0 = sys_["cpu"].qpos0[7:]
    ctrls = [q0 + 0.1 * torch.randn(N, 12, generator=g, dtype=torch.float64)
             for _ in range(3)]
    last = {}
    solve = newton.solve

    def kept(efc, *args, **kw):
        out = solve(efc, *args, **kw)
        last["efc"], last["qacc"] = efc, out.qacc
        return out

    fields = ("qpos", "qvel", "qacc_warmstart", "sensordata")
    errs = {f: 0.0 for f in fields}
    card = st
    newton.solve = kept
    try:
        for ctrl in ctrls:
            on_card = pipeline.step(sys_[dev], _to(st, dev), ctrl.to(dev), 4)
            card = pipeline.step(sys_[dev], _to(card, dev), ctrl.to(dev), 4)
            st = pipeline.step(sys_["cpu"], st, ctrl, 4)
            for f in fields:
                errs[f] = max(errs[f], _rel(getattr(st, f), getattr(on_card, f)))
    finally:
        newton.solve = solve
    efc = last["efc"]
    jar = torch.einsum("nkv,nv->nk", efc.J, last["qacc"]) - efc.aref
    zones = {"bottom": 0, "middle": 0, "top": 0, "inactive": 0}
    for grp in efc.cones:
        c = newton._cone_terms(efc, grp, jar)
        zones["bottom"] += int(c.bottom.sum())
        zones["middle"] += int(c.mid.sum())
        zones["inactive"] += int((~grp.active).sum())
        zones["top"] += int((grp.active & ~c.bottom & ~c.mid).sum())
    free = max(_rel(getattr(st, f), getattr(card, f)) for f in fields)
    err = max(errs.values())
    print(f"physics-anymal: 3 decimated steps, {N} envs, float64, Newton "
          f"budget {ANYMAL_PHYS_ITERATIONS}, card vs CPU one decimated step at "
          f"a time: max rel err {err:.3e} "
          f"({', '.join(f'{k} {v:.1e}' for k, v in errs.items())}; tol "
          f"{ANYMAL_STEP_TOL:g}); free-running over 12 substeps {free:.3e} "
          f"(not held); cone contacts at the last substep (CPU): {zones}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not err <= ANYMAL_STEP_TOL:
        raise AssertionError("anymal_c physics on the card disagrees with the CPU")
    if zones["bottom"] < 1 or zones["middle"] < 1:
        raise AssertionError(f"the cone code was not exercised: {zones}")


def _to(state, dev):
    """A physics State with every field on dev."""
    import dataclasses

    return state.replace(**{f.name: getattr(state, f.name).to(dev)
                            for f in dataclasses.fields(state)})


@contextlib.contextmanager
def _counted_replays():
    """Counts the replays of every captured step and update (by the
    qualified name of the function the graph holds) in the yielded dict."""
    from nightmare_rl_tpu_torch.utils import graph

    counts = {}
    replay = graph._Captured._replay

    def counted(self):
        name = getattr(self.fn, "__qualname__", repr(self.fn))
        counts[name] = counts.get(name, 0) + 1
        return replay(self)

    graph._Captured._replay = counted
    try:
        yield counts
    finally:
        graph._Captured._replay = replay


def phase_slice_anymal(device_name: str, smi: str) -> tuple:
    """The anymal_c training slice, its rollout replaying the captured env
    step.  Every substep's Newton solve must be one launch of the Newton
    kernel (counted from zero by ``newton_solve.launches``, to which each
    replay adds its graph's launches): the reset's step, the capture's
    warm-up step and the rollout's replays.  Clones of the last solve's
    inputs are kept (the wrapper is wrapped where the solver calls it):
    inside the capture they are nodes of the graph, so they hold the last
    replay's.  Returns them and the launches."""
    import torch

    from nightmare_rl_tpu_torch.ops import newton as K
    from nightmare_rl_tpu_torch.physics import solver
    from nightmare_rl_tpu_torch.tools import train
    from nightmare_rl_tpu_torch.utils.graph import clone

    wrapped = solver.newton_solve
    box = {}

    def kept(*args, **kw):
        box["args"] = (clone(args), {k: clone(v) for k, v in kw.items()})
        return wrapped(*args, **kw)

    iters, envs = 1, 2048
    t0 = time.perf_counter()
    K.newton_solve.launches = 0
    solver.newton_solve = kept
    try:
        with tempfile.TemporaryDirectory() as tmp, _counted_replays() as rep:
            runner = train.main(["--robot", "anymal_c", "-e", str(envs), "-n",
                                 str(iters), "--log_root", tmp])
            torch.cuda.synchronize()
            saved = sorted(f for d, _, fs in os.walk(tmp) for f in fs)
    finally:
        solver.newton_solve = wrapped
    launches = K.newton_solve.launches
    wall = time.perf_counter() - t0
    stats = runner.last_stats
    T = runner.cfg.runner.num_steps_per_env
    dec = runner.env.cfg.decimation
    replays = rep.get("PPO._rollout_step", 0)
    # + the reset's zero-action step and the rollout graph's warm-up step
    expected = iters * T * dec + dec + GRAPH_WARMUP * dec
    rate = T * envs / (stats["rollout_s"] + stats["update_s"])
    print(f"slice-anymal: {iters} PPO iteration x {T} steps x {envs} envs "
          f"float32 (the rollout replays the captured step): loss "
          f"{stats['loss']:.4f}, kl {stats['kl']:.4f}; newton kernel "
          f"launches {launches} (expected {expected}: {replays} replays x "
          f"{dec} + the reset's and the warm-up's steps); update replays "
          f"{rep.get('PPO._head', 0)} prologue heads + "
          f"{rep.get('PPO._step', 0)} minibatch steps; rollout "
          f"{stats['rollout_s']:.3f} s + "
          f"update {stats['update_s']:.3f} s = {rate:,.0f} env-steps/s "
          f"(smoke figure, {device_name}, {smi}); dones {stats['dones']}; "
          f"saved {saved}; {wall:.1f} s incl. set-up")
    if not math.isfinite(stats["loss"]):
        raise AssertionError("non-finite PPO loss (anymal_c)")
    if launches != expected or replays != iters * T:
        raise AssertionError(
            f"the newton kernel ran {launches} times over {replays} replays, "
            f"expected {expected}")
    if not torch.isfinite(runner.ppo.obs).all():
        raise AssertionError("non-finite observations (anymal_c)")
    return box["args"], launches


def phase_eval_anymal(device_name: str, smi: str) -> int:
    """``tools/eval_anymal.py`` on the card: the committed
    ``anymal_model_122.pt`` (the JAX package's export of
    ``artifacts/anymal_model_122``), 300 steps at vx 0.5, deterministic,
    every step a replay of the captured play step; held to the JAX
    script's outcome on the CPU (``EVAL_JAX``, the policy stands): no fall
    and no timeout, the base height's mean in ``EVAL_BASE_Z``, |v_avg| at
    most ``EVAL_MAX_V`` in x and in y, every foot down at least
    ``EVAL_MIN_DUTY`` of the steps, every substep a launch of the Newton
    kernel.  Returns the kernel's launches."""
    import numpy as np
    import torch

    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg
    from nightmare_rl_tpu_torch.ops.newton import newton_solve
    from nightmare_rl_tpu_torch.tools import eval_anymal

    path = os.path.join("nightmare_rl_tpu_torch", "assets",
                        "anymal_model_122.pt")
    t0 = time.perf_counter()
    newton_solve.launches = 0
    with _counted_replays() as rep:
        res = eval_anymal.main(["--ckpt", path, "--steps", str(EVAL_STEPS),
                                "--vx", "0.5"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = newton_solve.launches
    s = res["stats"]
    replays = rep.get("player.<locals>.step", 0)
    print(f"eval-anymal: {path}, {EVAL_STEPS} steps at vx 0.5, "
          f"deterministic, {replays} replays of the captured step: the "
          f"port on the card: {res['lines'][0]} / {res['lines'][1]}; the JAX "
          f"script on the CPU: {EVAL_JAX[0]} / {EVAL_JAX[1]}; newton kernel "
          f"launches {launches}; wall {wall:.1f} "
          f"s (capture included; {device_name}, {smi})")
    v = np.abs(s["v_avg"][:2])
    if (s["falls"] or s["timeouts"]
            or not EVAL_BASE_Z[0] <= s["base_z_mean"] <= EVAL_BASE_Z[1]
            or (v > EVAL_MAX_V).any() or (s["duty"] < EVAL_MIN_DUTY).any()
            or replays != EVAL_STEPS
            or launches < EVAL_STEPS * AnymalCCfg().decimation):
        raise AssertionError(f"anymal_model_122 leaves the JAX eval's band: "
                             f"{s}, {replays} replays, {launches} newton "
                             f"kernel launches")
    return launches


def phase_newton_converged(kept: tuple) -> None:
    """The slice's last Newton solve in float64: the kernel at the slice's
    budget against the plain solve at 100 iterations and 50 refinements."""
    import torch

    from nightmare_rl_tpu_torch.ops.newton import newton_solve
    from nightmare_rl_tpu_torch.physics import newton

    t0 = time.perf_counter()
    (efc, M, a0, iterations, ls_refine), kw = kept
    x0 = kw.get("x0")
    efc64 = _newton_f64(efc)
    args64 = (efc64, M.double(), a0.double())
    x64 = None if x0 is None else x0.double()
    budget = newton_solve(*args64, iterations, ls_refine, x0=x64).qacc
    conv = newton.solve(*args64, 100, 50, x0=x64).qacc
    per_env = ((budget - conv).abs() / (1.0 + conv.abs())).amax(dim=1).cpu()
    q32 = newton_solve(efc, M, a0, iterations, ls_refine, x0=x0).qacc
    e32 = float(((q32.double() - budget).abs() / (1.0 + budget.abs())).max())
    share = float((per_env <= NEWTON_CONVERGED_TOL).double().mean())
    q = torch.quantile(per_env, torch.tensor([0.5, 0.9, 0.99], dtype=per_env.dtype))
    print(f"newton-converged: the slice's last solve ({per_env.numel()} envs, "
          f"budget {iterations} iterations / {ls_refine} refinements, the "
          f"kernel) in float64 vs the plain solve at 100 / 50: max "
          f"|dqacc|/(1+|qacc|) per env: median "
          f"{q[0]:.3e}, p90 {q[1]:.3e}, p99 {q[2]:.3e}, max "
          f"{float(per_env.max()):.3e}; {share:.1%} of envs within "
          f"{NEWTON_CONVERGED_TOL:g} (required {NEWTON_CONVERGED_SHARE:.0%}); "
          f"float32 vs float64 at the budget {e32:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not share >= NEWTON_CONVERGED_SHARE:
        raise AssertionError("the slice's Newton budget is not converged")

def _newton_f64(efc):
    """A NewtonEfc with every floating field in float64."""
    from nightmare_rl_tpu_torch.physics import newton

    def f64(x):
        return x.double() if x.is_floating_point() else x

    return newton.NewtonEfc(*[f64(x) for x in efc[:5]], cones=tuple(
        newton.ConeGroup(g.start, g.dim, f64(g.mu), f64(g.mus), g.active)
        for g in efc.cones))


def _newton_cost(efc, M, a0, x):
    """Per env, the total cost 0.5 (x - a0)ᵀM(x - a0) + Σ s(Jx - aref) in
    float64."""
    import torch

    from nightmare_rl_tpu_torch.physics import newton

    efc, M, a0, x = _newton_f64(efc), M.double(), a0.double(), x.double()
    dx = x - a0
    jar = torch.einsum("nkv,nv->nk", efc.J, x) - efc.aref
    return (0.5 * torch.sum(dx * torch.einsum("nij,nj->ni", M, dx), dim=-1)
            + newton.constraint_cost(efc, jar))


def _newton_gap(ref, out):
    """Per env, the largest of force, qfrc and qacc's |out - ref| over
    1 + max|ref| of the field."""
    import torch

    gap = None
    for name in ("force", "qfrc_constraint", "qacc"):
        a, b = getattr(ref, name), getattr(out, name)
        g = (b - a).abs().amax(dim=1) / (1.0 + a.abs().amax(dim=1))
        gap = g if gap is None else torch.maximum(gap, g)
    return gap


def _newton_floor(efc, M, a0, x0, iterations, ls_refine):
    """The plain solve traced (``newton.solve(..., trace=...)``): per env
    the smallest margin over the round-off floor of φ' (|φ'| over its
    round-off scale) among the line-search decisions of the Newton steps
    that can move x by more than NEWTON_F64_TOL; and the plain result."""
    import torch

    from nightmare_rl_tpu_torch.physics import newton

    trace = []
    out = newton.solve(efc, M, a0, iterations, ls_refine, x0=x0, trace=trace)
    big = NEWTON_F64_TOL * (1.0 + out.qacc.abs().amax(dim=1))
    margin = torch.stack([torch.where(t["reach"] > big, t["margin"], torch.inf)
                          for t in trace]).amin(dim=0)
    return margin, out


def _newton_ops(efc, x, iterations: int, ls_refine: int, warm: bool) -> float:
    """Floating-point operations the solve needs on these inputs, over the
    live rows and items only (a row outside the cones with dof friction or
    one-sided activity, an active contact and its rows: the others' force
    is 0 at every x and adds nothing): per Newton step the residual, the
    gradient, H over the rows with curvature (the active rows and two per
    middle-zone contact, counted at the solution x), its Cholesky factor
    and two triangular solves, Jp, pᵀMp and gᵀMp, and 1 + 12 + ls_refine
    evaluations of φ' and φ'' (10 per row outside the cones, 8 per cone
    row and 20 per contact); the warmstart's two costs and the final
    forces and Jᵀf."""
    import torch

    from nightmare_rl_tpu_torch.physics import newton

    N, nefc, nv = efc.J.shape
    jar = torch.einsum("nkv,nv->nk", efc.J, x) - efc.aref
    _, diag = newton.forces(efc, jar)
    rows = float((diag != 0).sum())
    for g in efc.cones:
        rows += 2.0 * float(newton._cone_terms(efc, g, jar).mid.sum())
    in_cone = torch.zeros(nefc, dtype=torch.bool, device=jar.device)
    for g in efc.cones:
        in_cone[g.start:g.start + g.dim * g.mus.shape[-2]] = True
    plain = float(((efc.fl > 0) | efc.quad_active)[:, ~in_cone].sum())
    contacts = sum(float(g.active.sum()) for g in efc.cones)
    cone_rows = sum(float(g.active.sum()) * g.dim for g in efc.cones)
    live = plain + cone_rows                   # over the envs
    phi = 10 * plain + 8 * cone_rows + 20 * contacts
    step = (N * (2 * nv * nv + nv ** 3 / 3 + 2 * nv * nv + 2 * nv * nv
                 + 4 * nv + 2 * nv)
            + 6 * live * nv + rows * nv * (nv + 1)
            + (1 + 12 + ls_refine) * phi)
    warm_ops = 2 * (N * 2 * nv * nv + 2 * live * nv + phi) if warm else 0
    return iterations * step + warm_ops + 4 * live * nv


def _newton_bytes(efc, x0) -> int:
    """Bytes the solve must move: its inputs read once, its outputs
    (force, qfrc, qacc) written once."""
    N, nefc, nv = efc.J.shape
    it = efc.J.element_size()
    nc = sum(g.mus.shape[-2] for g in efc.cones)
    nmus = sum(g.mus.shape[-2] * (g.dim - 1) for g in efc.cones)
    vals = (N * nefc * nv + 3 * N * nefc + N * nc + N * nmus + N * nv * nv
            + N * nv * (2 if x0 is not None else 1) + N * nefc + 2 * N * nv)
    return vals * it + N * nefc + N * nc     # + the boolean masks


def _newton_zones(efc, x) -> dict:
    """Cone contacts per zone at qacc = x, over the envs."""
    import torch

    from nightmare_rl_tpu_torch.physics import newton

    jar = torch.einsum("nkv,nv->nk", efc.J, x) - efc.aref
    zones = {"bottom": 0, "middle": 0, "top": 0, "inactive": 0}
    for g in efc.cones:
        c = newton._cone_terms(efc, g, jar)
        zones["bottom"] += int(c.bottom.sum())
        zones["middle"] += int(c.mid.sum())
        zones["inactive"] += int((~g.active).sum())
        zones["top"] += int((g.active & ~c.bottom & ~c.mid).sum())
    return zones


def _newton_mjx_steps() -> float:
    """nightmare_v3_mjx (pyramidal cones: no cone group, then noslip): one
    step of 2 substeps at 16 envs in float64, the card (the kernel) against
    the CPU (the plain solve) at a converged budget, as
    tests/test_torch_anymal.py holds the JAX package; the largest error
    relative to each field's scale."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.physics import loader, pipeline

    N = 16
    out = {}
    g = torch.Generator().manual_seed(2)
    st0 = None
    for dev in ("cpu", "cuda"):
        sys_ = dataclasses.replace(loader.load_system("nightmare_v3_mjx",
                                                      device=dev),
                                   solver_iterations=30, ls_iterations=50)
        if st0 is None:
            st0 = pipeline.make_state(sys_, N)
            qpos = st0.qpos.clone()
            qpos[:, 7:] += 0.2 * torch.randn(N, 18, generator=g,
                                             dtype=torch.float64)
            qpos[:, 2] -= 0.09
            qvel = 0.3 * torch.randn(N, 24, generator=g, dtype=torch.float64)
            st0 = st0.replace(qpos=qpos, qvel=qvel)
            ctrl = torch.randn(N, 18, generator=g, dtype=torch.float64)
        out[dev] = pipeline.step(sys_, _to(st0, dev), ctrl.to(dev), 2)
    return max(_rel(getattr(out["cpu"], f), getattr(out["cuda"], f))
               for f in ("qpos", "qvel", "qacc_warmstart"))


def phase_newton_kernel(kept: tuple, device_name: str, smi: str) -> dict:
    """The Newton kernel (``ops/csrc/newton.cu``) on the inputs of
    slice-anymal's last solve (2048 envs, anymal_c's rows), held three
    ways against the plain ``newton.solve`` on the card: in float64 at
    NEWTON_HELD_BUDGETS, budgets whose line-search decisions stand above
    the round-off floor of φ' (every env not on the floor within
    NEWTON_F64_TOL, the smallest margin printed); in float32 at the model's
    own budget by cost (no more than the plain version's plus
    NEWTON_COST_TOL of it in NEWTON_COST_SHARE of the envs, the plain
    solve's own float32-against-float64 spread printed as the yardstick)
    and NaN pattern; and timed with CUDA events
    beside its plain version and its bound.  Then the edges: N=1, a cold
    start, N=37 (ghost warps) at the first of those budgets, and
    nightmare_v3_mjx's pyramidal rows (no cone group) through the
    pipeline, card against CPU."""
    import torch

    from nightmare_rl_tpu_torch.ops import newton as K
    from nightmare_rl_tpu_torch.physics import newton

    t0 = time.perf_counter()
    (efc, M, a0, iterations, ls_refine), kw = kept
    x0 = kw.get("x0")
    N = M.shape[0]
    # contacts per zone at qacc_smooth, the warmstart and the cold and warm
    # solutions: the largest count of each over these points
    points = [a0] + ([] if x0 is None else [x0]) + [
        newton.solve(efc, M, a0, iterations, ls_refine, x0=x).qacc
        for x in (None, x0)]
    zones = {}
    for x in points:
        for k, v in _newton_zones(efc, x).items():
            zones[k] = max(zones.get(k, 0), v)

    # float64 above the floor
    e64, M64, a64 = _newton_f64(efc), M.double(), a0.double()
    x64 = None if x0 is None else x0.double()
    held64 = {}
    for budget in NEWTON_HELD_BUDGETS:
        margin, ref = _newton_floor(e64, M64, a64, x64, *budget)
        out = K.newton_solve(e64, M64, a64, *budget, x0=x64)
        held = margin >= NEWTON_FLOOR
        held64[budget] = dict(
            gap=float(_newton_gap(ref, out)[held].max()),
            abs=max(float((getattr(out, f) - getattr(ref, f))[held].abs().max())
                    for f in ("force", "qfrc_constraint", "qacc")),
            floor=int((~held).sum()), margin=float(margin[held].min()))
    abs_err = max(h["abs"] for h in held64.values())
    edges = {}
    it_h, ls_h = NEWTON_HELD_BUDGETS[0]
    for label, sl, warm in (("N=1", slice(0, 1), True),
                            ("cold", slice(0, N), False),
                            ("N=37", slice(5, 42), True)):
        def cut(x):
            return x[sl].contiguous()

        ee = newton.NewtonEfc(*[cut(x) for x in e64[:5]], cones=tuple(
            newton.ConeGroup(g.start, g.dim, cut(g.mu), cut(g.mus),
                             cut(g.active)) for g in e64.cones))
        xe = cut(x64) if warm and x64 is not None else None
        m_e, r_e = _newton_floor(ee, cut(M64), cut(a64), xe, it_h, ls_h)
        o_e = K.newton_solve(ee, cut(M64), cut(a64), it_h, ls_h, x0=xe)
        g_e = _newton_gap(r_e, o_e)
        edges[label] = float(g_e[m_e >= NEWTON_FLOOR].max()) if bool(
            (m_e >= NEWTON_FLOOR).any()) else 0.0
    mjx = _newton_mjx_steps()

    # float32 at the model's budget, by cost and NaN pattern
    k32 = K.newton_solve(efc, M, a0, iterations, ls_refine, x0=x0)
    p32 = newton.solve(efc, M, a0, iterations, ls_refine, x0=x0)
    p64 = newton.solve(e64, M64, a64, iterations, ls_refine, x0=x64)
    nan_k = torch.isnan(k32.qacc).any(dim=1)
    nan_p = torch.isnan(p32.qacc).any(dim=1)
    ck, cp, cp64 = (_newton_cost(efc, M, a0, x) for x in (
        k32.qacc, p32.qacc, p64.qacc))

    def rel(a, b):
        return (a - b) / b.abs().clamp_min(1e-30)

    fin = ~nan_p & ~nan_k
    excess = rel(ck, cp)[fin]
    over = int((excess > NEWTON_COST_TOL).sum())
    # the yardstick: the plain solve against itself in float64, whose line
    # search takes its floor decisions with other round-off
    own = rel(cp, cp64)[fin]
    qgap = float(((k32.qacc - p32.qacc).abs().amax(dim=1)
                  / (1.0 + p32.qacc.abs().amax(dim=1)))[fin].max())

    # times and the bound
    args = (efc, M, a0, iterations, ls_refine)
    kern_ms = _cuda_ms(lambda: K.newton_solve(*args, x0=x0), reps=20)
    plain_ms = _cuda_ms(lambda: newton.solve(*args, x0=x0), reps=2, warmup=1)
    nbytes = _newton_bytes(efc, x0)
    ops = _newton_ops(efc, p32.qacc, iterations, ls_refine, x0 is not None)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    geo = K.geometry(efc.J.shape[1], efc.J.shape[2], K._spans(efc), 4)
    print(f"newton-kernel: slice-anymal's last solve, {N} envs x "
          f"{efc.J.shape[1]} rows x nv {efc.J.shape[2]}, cone groups "
          f"{K._spans(efc)}; contacts per zone (most at qacc_smooth, the "
          f"warmstart, the cold and warm plain solutions) {zones}; float64, "
          f"kernel vs plain (tol {NEWTON_F64_TOL:g}): " + "; ".join(
              f"{b[0]} iteration(s) / {b[1]} refinement(s): max gap "
              f"{h['gap']:.3e} over {N - h['floor']} envs (max abs "
              f"{h['abs']:.3e}), {h['floor']} envs with a decision on the "
              f"line-search floor (margin < {NEWTON_FLOOR:g}), smallest "
              f"margin over the floor among the held {h['margin']:.3g}"
              for b, h in held64.items())
          + f"; edges at {it_h} / {ls_h} {edges}, "
          f"nightmare_v3_mjx card vs CPU {mjx:.3e}; float32 at the model's "
          f"{iterations} / {ls_refine}: NaN envs kernel {int(nan_k.sum())} / "
          f"plain {int(nan_p.sum())}, total cost kernel vs plain: "
          f"{int(fin.sum()) - over} envs within {NEWTON_COST_TOL:g} of the "
          f"plain cost, {over} above it (largest excess "
          f"{float(excess.max()):.3e}), {int((excess < 0).sum())} lower, "
          f"{int((excess > 0).sum())} higher, largest relative qacc gap "
          f"{qgap:.3e}; the plain solve in float32 against float64: "
          f"{int((own.abs() > NEWTON_COST_TOL).sum())} envs apart by more "
          f"than {NEWTON_COST_TOL:g} (largest {float(own.abs().max()):.3e}); "
          f"{kern_ms:.4f} ms/launch ({geo.envs_per_block} envs "
          f"per block, {geo.smem_bytes} B shared), plain {plain_ms:.2f} ms; "
          f"bound {bound * 1e3:.2f} us by {by} ({nbytes / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP) = {bound / kern_ms:.1%} of it; "
          f"{_smi_line(t0, device_name, smi)}")
    if zones["middle"] < 1 or zones["top"] < 1 or zones["inactive"] < 1 \
            or zones["bottom"] < 1:
        raise AssertionError(f"the rows do not reach every cone zone: {zones}")
    if any(not h["gap"] <= NEWTON_F64_TOL for h in held64.values()) or any(
            not v <= NEWTON_F64_TOL for v in edges.values()):
        raise AssertionError(f"the newton kernel disagrees with newton.solve "
                             f"in float64: {held64}, edges {edges}")
    if any(N - h["floor"] < NEWTON_HELD_SHARE * N for h in held64.values()):
        raise AssertionError(f"fewer than {NEWTON_HELD_SHARE:.0%} of the envs "
                             f"stand above the line-search floor: {held64}")
    if not mjx <= PHYS_TOL:
        raise AssertionError(f"nightmare_v3_mjx on the card disagrees with "
                             f"the CPU: {mjx:.3e}")
    if not torch.equal(nan_k, nan_p):
        raise AssertionError("the newton kernel's NaN envs differ from the "
                             "plain version's")
    if int(fin.sum()) - over < NEWTON_COST_SHARE * N:
        raise AssertionError(f"the newton kernel's cost exceeds the plain "
                             f"version's by more than {NEWTON_COST_TOL:g} in "
                             f"{over} envs")
    return dict(max_abs_err=abs_err, ms=kern_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def _smi_line(t0: float, device_name: str, smi: str) -> str:
    return f"{time.perf_counter() - t0:.1f} s; {device_name}, {smi}"


def phase_recorder_resume(runner, tmp: str, device_name: str, smi: str) -> None:
    """The slice's recordings, and its last checkpoint reloaded on the card."""
    import numpy as np
    import torch

    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
    from nightmare_rl_tpu_torch.utils.checkpoint import state_items
    from nightmare_rl_tpu_torch.utils.recorder import load_recording

    t0 = time.perf_counter()
    rec = runner.recorder
    T = runner.cfg.runner.num_steps_per_env
    qpos = runner.last_stats["record"][0]
    files = [load_recording(f) for f in rec.files_written]
    finite = bool(np.isfinite(qpos).all()) and all(
        np.isfinite(q).all() for traj in files for (_, q, _, _) in traj)
    path = get_load_path(tmp)
    fresh = OnPolicyRunner(NightmareV3Env(runner.env.cfg, device="cuda"),
                           runner.cfg)
    restored = fresh.load(path)
    a, b = state_items(runner.ppo), state_items(fresh.ppo)
    differ = [k for k in a if not (
        torch.equal(a[k].cpu(), b[k].cpu()) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k])]
    stats = runner.last_stats
    rate = T * runner.env.num_envs / (stats["rollout_s"] + stats["update_s"])
    print(f"recorder/resume: env 0 frames received {rec.frames} (expected "
          f"{2 * T}), {len(rec.files_written)} episode files, qpos finite "
          f"{finite}; {os.path.basename(path)} reloaded on the card: full "
          f"train state {restored}, {len(a)} fields, differing {differ}; slice "
          f"with recording on {rate:,.0f} env-steps/s (PERF.md §6: "
          f"21,282-29,115 without recording); {_smi_line(t0, device_name, smi)}")
    if rec.frames != 2 * T or not finite:
        raise AssertionError("the slice's recording is incomplete or not finite")
    if not restored or differ or a.keys() != b.keys():
        raise AssertionError(f"the reloaded train state differs: {differ}")


def phase_play_grid(device_name: str, smi: str) -> None:
    """model_3176 over the command envelope, through tools/play.py."""
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import play

    t0 = time.perf_counter()
    with _kept_pgs() as last:
        P.pgs.launches = 0
        res = play.grid_eval(MODEL_3176, GRID_STEPS, device="cuda")
        launches = P.pgs.launches
    # 2 substeps per step + the reset's step and the graph's warm-up step
    expected = GRID_STEPS * 2 + 2 + GRAPH_WARMUP * 2
    rec, s = res["record"], res["settle"]
    for i, row in enumerate(res["rows"]):
        print(f"play-grid: cmd vx {row['cmd_vx']:+.2f} wz {row['cmd_wz']:+.2f} ",
              end="")
        play.print_gait_metrics(rec["feet"][s:, i], rec["qpos"][s:, i, 2],
                                res["dt"])
    straight = [r for r in res["rows"] if r["cmd_wz"] == 0 and r["cmd_vx"] != 0]
    print(f"play-grid: {len(res['rows'])} commands x {GRID_STEPS} steps "
          f"float32: falls {[r['falls'] for r in res['rows']]}, straight-row "
          f"vx% {[round(r['vx_pct'], 1) for r in straight]} (min "
          f"{GRID_MIN_VX:.0%}), pgs launches {launches} (expected {expected}); "
          f"{_smi_line(t0, device_name, smi)}")
    if any(r["falls"] for r in res["rows"]):
        raise AssertionError("model_3176 fell in the grid eval")
    if len(straight) != 2 or any(r["vx_pct"] < 100 * GRID_MIN_VX
                                 for r in straight):
        raise AssertionError("model_3176 does not track the straight commands")
    if launches != expected:
        raise AssertionError(f"pgs kernel ran {launches} times, expected {expected}")
    _hold_kernel("play-grid inputs (its last call)", last["args"],
                 (len(res["rows"]), 112, 24))


def _engine_journey(dev: str):
    """Angles of 4 engines (float64) on dev over idle -> get up -> walk,
    each env with its own walk command."""
    import torch

    from nightmare_rl_tpu_torch.engine import gait as G

    cfg = G.make_cfg(engine_fps=1.0 / 0.016, device=dev)
    es = G.init_state(cfg, 4)
    lin = torch.tensor([0.08, 0.05, -0.06, 1.5], dtype=torch.float64, device=dev)
    ang = torch.tensor([0.0, 0.25, 0.3, 0.0], dtype=torch.float64, device=dev)
    mode = torch.full((4,), G.MODE_WALK, dtype=torch.long, device=dev)
    angles, t = [], 0.0
    for k in range(420):
        t += 0.016
        state = torch.full((4,), G.CMD_IDLE if k < 10 else G.CMD_AWAKE,
                           dtype=torch.long, device=dev)
        es, a = G.update(cfg, es, t, lin, ang, state, mode)
        angles.append(a)
    return torch.stack(angles).cpu(), es.fsm.cpu()


def _custom_eager_rate(lin, ang) -> float:
    """Control steps/s of custom_play's plain ``control_step`` called from
    Python at CUSTOM_ENVS envs (the tool replays it as a graph), from the
    tool's initial state with its commands and clock."""
    import torch

    from nightmare_rl_tpu_torch.tools import custom_play

    sys_, cfg, phys, es, limited = custom_play.make(CUSTOM_ENVS)
    env = torch.arange(CUSTOM_ENVS)
    lin_t, ang_t = (torch.tensor(x, dtype=sys_.dtype)[env % len(x)].cuda()
                    for x in (lin, ang))
    h = float(sys_.timestep) * custom_play.DECIMATION
    clock = torch.arange(1, CUSTOM_EAGER_STEPS + 1, dtype=sys_.dtype,
                         device="cuda") * h
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(CUSTOM_EAGER_STEPS):
        phys, es, limited = custom_play.control_step(
            sys_, cfg, phys, es, limited, clock[k], lin_t, ang_t)
    torch.cuda.synchronize()
    return CUSTOM_EAGER_STEPS / (time.perf_counter() - t0)


def phase_custom_play(device_name: str, smi: str) -> None:
    """The gait engine card vs CPU, then the custom_play tool at 256 envs."""
    import numpy as np

    from nightmare_rl_tpu_torch.engine import gait as G
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import custom_play

    t0 = time.perf_counter()
    card, fsm = _engine_journey("cuda")
    cpu, _ = _engine_journey("cpu")
    err = float((card - cpu).abs().max())
    print(f"custom-play: engine 4 envs x 420 ticks float64, card vs CPU "
          f"max|dangle| = {err:.3e} (tol {ENGINE_TOL:g}); final states "
          f"{fsm.tolist()} (WALK = {G.WALK}); {_smi_line(t0, device_name, smi)}")
    if not err <= ENGINE_TOL or not (fsm == G.WALK).all():
        raise AssertionError("the gait engine on the card disagrees with the CPU")

    t0 = time.perf_counter()
    lin, ang = zip(*CUSTOM_CMDS)
    argv = (["--envs", str(CUSTOM_ENVS), "--lin"] + [str(x) for x in lin]
            + ["--ang"] + [str(x) for x in ang])
    with _kept_pgs() as last:
        P.pgs.launches = 0
        res = custom_play.main(argv + ["--steps", str(CUSTOM_STEPS)])
        launches = P.pgs.launches
    if res["graph"] is None:
        raise AssertionError("custom_play did not replay a captured step")
    eager_rate = _custom_eager_rate(lin, ang)
    q = res["qpos"]
    disp = np.hypot(q[:, 0], q[:, 1])  # qpos0 is (0, 0, 0.15)
    w, x, y, z = q[:, 3:7].T
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    group = np.arange(CUSTOM_ENVS) % len(CUSTOM_CMDS)
    rows, bad = [], []
    for k, ((l, a), (ref_disp, ref_yaw)) in enumerate(zip(CUSTOM_CMDS,
                                                          CUSTOM_JAX)):
        d, h, spread = disp[group == k], yaw[group == k], np.ptp(
            q[group == k, :3], axis=0).max()
        rows.append(f"lin {l} ang {a:+}: displacement {d.min():.4f}-"
                    f"{d.max():.4f} m (JAX {ref_disp}), yaw {h.min():+.4f} to "
                    f"{h.max():+.4f} (JAX {ref_yaw:+}), spread {spread:.2e} m")
        ok = (0.5 * ref_disp <= d.min() and d.max() <= 1.5 * ref_disp
              and spread <= CUSTOM_SPREAD)
        if a:  # a turn: the JAX tool's sign, at least half its angle
            ok &= bool((np.sign(h) == np.sign(ref_yaw)).all()
                       and (np.abs(h) >= 0.5 * abs(ref_yaw)).all())
        if not ok:
            bad.append((l, a))
    print(f"custom-play: {CUSTOM_ENVS} envs x {CUSTOM_STEPS} control steps "
          f"float32 tripod, env i takes command i mod {len(CUSTOM_CMDS)}: "
          f"{'; '.join(rows)}; base z min {q[:, 2].min():.4f} (min "
          f"{CUSTOM_MIN_HEIGHT}); as replays of the captured control step "
          f"{res['ctrl_steps_per_s']:.1f} control steps/s ({res['wall_s']:.1f} "
          f"s; capture {res['capture_s']:.2f} s before it), eager "
          f"{eager_rate:.1f} (the plain control step, {CUSTOM_EAGER_STEPS} "
          f"steps); pgs launches {launches} (expected "
          f"{CUSTOM_STEPS * 2 + GRAPH_WARMUP * 2}, the capture's warm-up "
          f"step included); {_smi_line(t0, device_name, smi)}")
    if not np.isfinite(q).all() or q[:, 2].min() < CUSTOM_MIN_HEIGHT:
        raise AssertionError("the engine-driven hexapods are not standing")
    if bad:
        raise AssertionError(f"the engine-driven hexapods do not walk as the "
                             f"JAX tool does under the commands {bad}")
    if launches != CUSTOM_STEPS * 2 + GRAPH_WARMUP * 2:
        raise AssertionError(f"pgs kernel ran {launches} times")
    _hold_kernel("custom-play inputs (its last call)", last["args"],
                 (CUSTOM_ENVS, 16 * 4 + 16, 24))


def phase_simple_test(device_name: str, smi: str) -> None:
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import simple_test

    t0 = time.perf_counter()
    with _kept_pgs() as last:
        P.pgs.launches = 0
        rate = simple_test.main(["-e", "2048", "-s", "5", "-d", "4"])
        launches = P.pgs.launches
    print(f"simple-test: 2048 envs x 5 calls x 4 substeps float32, "
          f"max_contacts 16: {rate:,.0f} substeps/s, pgs launches {launches} "
          f"(expected {(GRAPH_WARMUP + 1 + 5) * 4}, the graph's warm-up "
          f"step and the warm-up call included); "
          f"{_smi_line(t0, device_name, smi)}")
    if launches != (GRAPH_WARMUP + 1 + 5) * 4:
        raise AssertionError(f"pgs kernel ran {launches} times")
    _hold_kernel("simple-test inputs (its last call)", last["args"],
                 (2048, 16 * 4 + 16, 24))


def _recurrent_seq(net, obs, done, dev: str) -> tuple:
    """``net`` over the sequence ``obs`` with the resets ``done`` on
    ``dev``: the stacked outputs and carries, and the gradient of their sum
    of squares (the backward pass wrapped as rl/ppo.py wraps it)."""
    import copy

    import torch

    from nightmare_rl_tpu_torch.models import actor_critic as ac
    from nightmare_rl_tpu_torch.utils.device import full_float32

    m = copy.deepcopy(net).to(dev)
    h = m.initial_state(obs.shape[1])
    seq = []
    for t in range(obs.shape[0]):
        (mu, _, v), h = m(obs[t].to(dev), h)
        h = ac.reset_hidden(h, done[t].to(dev))
        seq.append(torch.cat([mu, v[:, None], *h[0], *h[1]], 1))
    out = torch.stack(seq)
    with full_float32():
        torch.square(out).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in m.parameters()
                       if p.grad is not None])
    return out.detach().cpu(), grads.cpu()


def _rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_recurrent_net(device_name: str, smi: str) -> None:
    """The recurrent actor-critic at full width, card vs CPU, forward and
    backward: in float64, and in float32 with cuDNN's TF32 flag at torch's
    default (on), which the port must override for its LSTM."""
    import copy

    import torch

    from nightmare_rl_tpu_torch.models import actor_critic as ac

    t0 = time.perf_counter()
    T, N = 6, 64
    torch.manual_seed(11)
    net = ac.ActorCriticRecurrent(66, 18, rnn_hidden=512).double()
    g = torch.Generator().manual_seed(12)
    obs = torch.randn(T, N, 66, generator=g, dtype=torch.float64)
    done = torch.rand(T, N, generator=g) < 0.2
    card, cpu = (_recurrent_seq(net, obs, done, d) for d in ("cuda", "cpu"))
    err, gerr = _rel_err(card[0], cpu[0]), _rel_err(card[1], cpu[1])

    net32, obs32 = copy.deepcopy(net).float(), obs.float()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True   # torch's default
    try:
        card32, cpu32 = (_recurrent_seq(net32, obs32, done, d)
                         for d in ("cuda", "cpu"))
        # the bare nn.LSTM, one step, under the flag: what TF32 would give
        lstm = copy.deepcopy(net32.memory_a.rnn)
        with torch.no_grad():
            bare = _rel_err(lstm.cuda()(obs32[:1].cuda())[0].cpu(),
                            lstm.cpu()(obs32[:1])[0])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    err32, gerr32 = _rel_err(card32[0], cpu32[0]), _rel_err(card32[1], cpu32[1])
    print(f"recurrent-net: rnn 512 [54,42,30], {T} steps x {N} envs with "
          f"{int(done.sum())} resets, card vs CPU max|err|/max|out|: float64 "
          f"outputs {err:.3e}, gradients {gerr:.3e} (tol {RNN_TOL:g}); float32 "
          f"with cudnn.allow_tf32 on: outputs {err32:.3e}, gradients "
          f"{gerr32:.3e} (tol {RNN_F32_TOL:g}; the bare nn.LSTM step under "
          f"TF32: {bare:.3e}); {_smi_line(t0, device_name, smi)}")
    finite = all(torch.isfinite(x).all() for x in (*card, *card32))
    if not (err <= RNN_TOL and gerr <= RNN_TOL and err32 <= RNN_F32_TOL
            and gerr32 <= RNN_F32_TOL and finite):
        raise AssertionError("the recurrent net on the card disagrees with "
                             "the CPU")


def _hidden_nonzero(hidden) -> bool:
    return all(float(x.abs().max()) > 0 for carry in hidden for x in carry)


def phase_slice_recurrent(device_name: str, smi: str):
    import torch

    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import train

    envs = 2048
    pcfg = PPOCfg(runner=RunnerCfg(policy_class_name="ActorCriticRecurrent"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _kept_pgs() as last:
        P.pgs.launches = 0
        runner = train.main(["-e", str(envs), "-n", "1", "--log_root", tmp],
                            pcfg=pcfg)
        torch.cuda.synchronize()
        launches = P.pgs.launches
    stats = runner.last_stats
    T = pcfg.runner.num_steps_per_env
    # 2 substeps per env step + the reset's step and the graph's warm-up
    expected = T * 2 + 2 + GRAPH_WARMUP * 2
    rate = T * envs / (stats["rollout_s"] + stats["update_s"])
    nonzero = _hidden_nonzero(runner.ppo.hidden)
    print(f"slice-recurrent: 1 PPO iteration x {T} steps x {envs} envs "
          f"float32, rnn {pcfg.policy.rnn_hidden_size}: loss "
          f"{stats['loss']:.4f}, kl {stats['kl']:.4f}, hidden state nonzero "
          f"{nonzero}, pgs launches {launches} (expected {expected}); rollout "
          f"{stats['rollout_s']:.3f} s + update {stats['update_s']:.3f} s = "
          f"{rate:,.0f} env-steps/s (smoke figure, recording on); "
          f"{_smi_line(t0, device_name, smi)}")
    if not math.isfinite(stats["loss"]) or not nonzero:
        raise AssertionError("recurrent PPO: non-finite loss or zero state")
    if launches != expected:
        raise AssertionError(f"pgs kernel ran {launches} times, expected {expected}")
    _hold_kernel("slice-recurrent inputs (its last call)", last["args"],
                 (envs, 112, 24))
    return runner


def _mesh_jobs(rnn: int = 512, steps: int = 80) -> dict:
    """The sharded checks' PPO configs: 4 steps with a 1×1 update
    (``single``) and with the default 5×4 update (``default``); ``steps``
    steps with the default update for the feed-forward net (``learn``,
    whose learning half is then held against eager) and the recurrent
    policy (``recurrent``)."""
    from nightmare_rl_tpu_torch.core.config import (
        AlgorithmCfg, PolicyCfg, PPOCfg, RunnerCfg,
    )

    short = RunnerCfg(num_steps_per_env=4)
    return {
        "single": PPOCfg(runner=short, algorithm=AlgorithmCfg(
            num_mini_batches=1, num_learning_epochs=1)),
        "default": PPOCfg(runner=short),
        "learn": PPOCfg(runner=RunnerCfg(num_steps_per_env=steps)),
        "recurrent": PPOCfg(
            runner=RunnerCfg(num_steps_per_env=steps,
                             policy_class_name="ActorCriticRecurrent"),
            policy=PolicyCfg(rnn_hidden_size=rnn)),
    }


def _cpu(x):
    import torch

    return x.cpu() if isinstance(x, torch.Tensor) else x


def _mesh_dump(path: str, runner, **extra) -> None:
    import torch

    from nightmare_rl_tpu_torch.utils.checkpoint import state_items

    ppo = runner.ppo
    cap = ppo._learner_obj
    torch.save({
        "stats": {k: v for k, v in (runner.last_stats or {}).items()
                  if k != "record"},
        "items": {k: _cpu(v) for k, v in state_items(ppo).items()},
        "obs": ppo.obs.cpu(),
        "hidden": [x.cpu() for carry in ppo.hidden for x in carry],
        "world": ppo.shard.world, "num_envs": runner.env.num_envs,
        "device": str(ppo.device), "backend": ppo.mesh.backend,
        "steps": runner.cfg.runner.num_steps_per_env,
        "learner": None if cap is None else {
            "captured": cap.graph is not None, **{k: getattr(cap, k) for k in (
                "warmup_s", "capture_s", "record_s", "pool_bytes")}},
        **extra,
    }, path)


def mesh_worker(argv) -> int:
    """One rank of a run of the sharded CLI (``--mesh-worker OUT JOB...``,
    started by ``_torchrun``): trains each job of ``_mesh_jobs`` for one
    iteration through ``tools/train.py --mesh`` and saves, per rank,
    ``OUT/<job>_rank<r>.pt``: the statistics, the global train state
    (``checkpoint.state_items``), its own rows of the observations and of
    the hidden state (h_a, c_a, h_c, c_c), its PGS launches and wall
    seconds, its captured learning half's warm-up, capture and pool, for
    ``recurrent`` the inputs of its last PGS call, and for ``learn`` and
    ``recurrent`` the learning half replayed against eager from the state
    after the iteration (``_hold_learner``).  With ``--resume ROOT`` it then restores
    the newest recurrent checkpoint under ROOT and saves the state before
    (``loaded``) and after (``continued``) one more iteration.  The sharded
    phase runs it on the card; tests/test_torch_sharded.py runs it with
    ``--device cpu``."""
    import argparse

    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.parallel import mesh
    from nightmare_rl_tpu_torch.tools import train

    p = argparse.ArgumentParser(prog="chip_smoke.py --mesh-worker")
    p.add_argument("out")
    p.add_argument("jobs", nargs="+", choices=("single", "default", "learn",
                                               "recurrent"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    p.add_argument("--envs", type=int, default=MESH_ENVS)
    p.add_argument("--rnn", type=int, default=512)
    p.add_argument("--steps", type=int, default=80,
                   help="rollout steps of the learn and recurrent jobs")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", default=None)
    a = p.parse_args(argv)
    os.environ["NIGHTMARE_PGS"] = "kernel"   # the ranks hold the dense kernel
    cli = ["--mesh", "--device", a.device, "-e", str(a.envs), "--seed",
           str(a.seed)] + (["--backend", a.backend] if a.backend else [])
    jobs = _mesh_jobs(a.rnn, a.steps)

    def dump(job, runner, **extra):
        _mesh_dump(os.path.join(a.out, f"{job}_rank{runner.ppo.shard.rank}.pt"),
                   runner, **extra)

    try:
        for job in a.jobs:
            with _kept_pgs() as last:
                P.pgs.launches = 0
                t0 = time.perf_counter()
                runner = train.main(cli + ["-n", "1", "--log_root",
                                           os.path.join(a.out, job)],
                                    pcfg=jobs[job])
                if runner.ppo.device.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = P.pgs.launches
            dump(job, runner, wall=wall, launches=launches,
                 pgs_args=(tuple(_cpu(x) for x in last["args"])
                           if job == "recurrent" else None),
                 held=(_hold_learner(runner.ppo)
                       if job in ("learn", "recurrent") else None))
        if a.resume:
            runner = train.main(cli + ["-n", "0", "-r", "-p", a.resume,
                                       "--log_root",
                                       os.path.join(a.out, "resumed")],
                                pcfg=jobs["recurrent"])
            dump("loaded", runner)
            runner.learn(1)
            dump("continued", runner)
    finally:
        mesh.close()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(world: int, out: str, *worker_args: str,
              timeout: float = MESH_TIMEOUT) -> float:
    """Run ``mesh_worker`` as ``world`` ranks under ``python -m
    torch.distributed.run`` (one CPU thread each); returns the wall
    seconds.  On a failure or a timeout every process of the run is
    killed and AssertionError raised with the end of its log."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={world}", "--master_addr=127.0.0.1",
           f"--master_port={_free_port()}", os.path.join(here, "chip_smoke.py"),
           "--mesh-worker", out, *worker_args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, cwd=here,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"world {world} did not end in {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"world {world} ({' '.join(worker_args)}) exited "
                             f"{proc.returncode}:\n{log[-6000:]}")
    return time.perf_counter() - t0


def _load_rank(d: str, job: str, rank: int = 0) -> dict:
    import torch

    return torch.load(os.path.join(d, f"{job}_rank{rank}.pt"),
                      weights_only=False)


def _hold_worlds(w1: str, wn: str, world: int) -> None:
    """World 1 against world ``world`` (their ``single`` and ``default``
    jobs): with the 1×1 update the rollout stats, loss and parameters
    agree to the JAX test's tolerances (tests/test_sharded.py:54-91); with
    the 5×4 update the rollout stats agree."""
    import numpy as np

    a, b = _load_rank(w1, "single"), _load_rank(wn, "single")
    sa, sb = a["stats"], b["stats"]
    params = [k for k in a["items"] if k.startswith("net.")]
    perr = max(float((a["items"][k] - b["items"][k]).abs().max())
               for k in params)
    devices = [_load_rank(wn, "single", r)["device"] for r in range(world)]
    print(f"sharded: world 1 ({a['backend']}, {a['device']}) vs world {world} "
          f"({b['backend']}, {' and '.join(devices)}), {a['num_envs']} "
          f"global envs x 4 steps, 1x1 update: mean_reward {sa['mean_reward']:.7f} / "
          f"{sb['mean_reward']:.7f}, dones {sa['dones']} / {sb['dones']}, "
          f"loss {sa['loss']:.7f} / {sb['loss']:.7f}, max|dparam| {perr:.3e}")
    np.testing.assert_allclose(sa["mean_reward"], sb["mean_reward"], rtol=1e-6)
    assert sa["dones"] == sb["dones"], (sa["dones"], sb["dones"])
    np.testing.assert_allclose(sa["loss"], sb["loss"], rtol=1e-6, atol=1e-7)
    for k in params:
        np.testing.assert_allclose(a["items"][k].numpy(), b["items"][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    a, b = _load_rank(w1, "default"), _load_rank(wn, "default")
    sa, sb = a["stats"], b["stats"]
    print(f"sharded: 5x4 update: mean_reward {sa['mean_reward']:.7f} / "
          f"{sb['mean_reward']:.7f}, dones {sa['dones']} / {sb['dones']}, "
          f"loss {sa['loss']:.5f} / {sb['loss']:.5f} (shard-local "
          f"minibatches)")
    np.testing.assert_allclose(sa["mean_reward"], sb["mean_reward"], rtol=1e-6)
    np.testing.assert_allclose(sa["episode_reward_means"],
                               sb["episode_reward_means"], rtol=1e-6,
                               atol=1e-7)
    assert sa["dones"] == sb["dones"], (sa["dones"], sb["dones"])


def _hold_sharded_learners(wdir: str, world: int, job: str = "learn") -> None:
    """Each rank's ``job`` (``learn`` or ``recurrent``): its captured
    learning half (the parts replayed, the reductions between them)
    against eager from one state, bit for bit, no host sync inside the
    parts; seconds in turns, capture seconds and pools."""
    from nightmare_rl_tpu_torch.rl.ppo import STAT_KEYS

    for rank in range(world):
        r = _load_rank(wdir, job, rank)
        held = r["held"]
        diffs = _learner_diffs(held)
        secs = held["secs"]
        stats = dict(zip(STAT_KEYS, held["graph"]["stats"].tolist()))
        print(f"sharded: world {world} ({r['backend']}, {r['device']}) rank "
              f"{rank}, {job}: {r['num_envs']} of {MESH_ENVS} envs x "
              f"{r['steps']} steps, 5x4 "
              f"update, captured against eager: equal bit for "
              f"bit {all(v[0] for v in diffs.values())} "
              f"{ {k: v[0] for k, v in diffs.items()} }; loss "
              f"{stats['loss']:.6f}, kl {stats['kl']:.6f}; host syncs inside "
              f"the parts {held['syncs']}; seconds per update in turns "
              f"(eager, graph, graph, eager): {secs['eager'][0]:.4f}, "
              f"{secs['graph'][0]:.4f}, {secs['graph'][1]:.4f}, "
              f"{secs['eager'][1]:.4f}; the iteration's update "
              f"{r['stats']['update_s']:.4f} s (capture included); "
              f"{_learner_line(held)}")
        if not all(v[0] for v in diffs.values()):
            raise AssertionError(f"world {world} rank {rank}: the captured "
                                 f"learning half differs: {diffs}")
        if held["syncs"] != 0:
            raise AssertionError(f"world {world} rank {rank}: the captured "
                                 f"parts synced {held['syncs']} times")


def _sharded_over_cards(w1: str, tmp: str) -> None:
    """Where the machine has several cards: world 1 (run in ``w1``) against
    one NCCL rank per card."""
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"sharded: {cards} card, the NCCL run over cards is skipped "
              f"(it runs where there are two or more)")
        return
    wn = os.path.join(tmp, f"w{cards}")
    wall = _torchrun(cards, wn, "--backend", "nccl", "single", "default")
    _hold_worlds(w1, wn, cards)
    print(f"sharded: world {cards} over {cards} cards with nccl: "
          f"torch.distributed.run wall {wall:.1f} s (2 jobs, start-up "
          f"included)")


def phase_sharded(device_name: str, smi: str) -> None:
    import torch

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
    from nightmare_rl_tpu_torch.utils.checkpoint import state_items

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        w1, w2 = os.path.join(tmp, "w1"), os.path.join(tmp, "w2")
        wall1 = _torchrun(1, w1, "--backend", "nccl", "single", "default",
                          "learn")
        wall2 = _torchrun(2, w2, "--backend", "gloo", "single", "default",
                          "learn", "recurrent")
        _hold_worlds(w1, w2, 2)
        _hold_sharded_learners(w1, 1)
        _hold_sharded_learners(w2, 2)
        _hold_sharded_learners(w2, 2, "recurrent")

        r0, r1 = _load_rank(w2, "recurrent"), _load_rank(w2, "recurrent", 1)
        T = _mesh_jobs()["recurrent"].runner.num_steps_per_env
        n = MESH_ENVS // 2
        expected = T * 2 + 2 + GRAPH_WARMUP * 2
        st = r0["stats"]
        shapes = [[tuple(x.shape) for x in r["hidden"]] for r in (r0, r1)]
        nonzero = [all(float(x.abs().max()) > 0 for x in r["hidden"])
                   for r in (r0, r1)]
        print(f"sharded: world 2 recurrent, 1 iteration x {T} steps x "
              f"{MESH_ENVS} envs: loss {st['loss']:.4f}, hidden per rank "
              f"{shapes[0][0]} / {shapes[1][0]}, nonzero {nonzero[0]} / "
              f"{nonzero[1]}, pgs launches per rank {r0['launches']} / "
              f"{r1['launches']} (expected {expected}); rollout "
              f"{st['rollout_s']:.3f} s + update {st['update_s']:.3f} s per "
              f"rank (replays); its captured learning half per rank: "
              + "; ".join(f"rank {i} capture {r['learner']['capture_s']:.3f} s,"
                          f" pool {r['learner']['pool_bytes'] / 2**20:.1f} MiB"
                          for i, r in enumerate((r0, r1)))
              + f"; torch.distributed.run wall {wall1:.1f} s (world 1, 3 "
              f"jobs) and {wall2:.1f} s (world 2, 4 jobs) incl. start-up")
        if not math.isfinite(st["loss"]):
            raise AssertionError("sharded recurrent PPO: non-finite loss")
        for r, s, nz in zip((r0, r1), shapes, nonzero):
            if not r["learner"]["captured"]:
                raise AssertionError("a rank did not capture its recurrent "
                                     "learning half")
            if s != [(n, 512)] * 4 or not nz:
                raise AssertionError(f"the hidden state is not sharded: {s}")
            if r["launches"] != expected:
                raise AssertionError(f"a rank ran pgs {r['launches']} times")
        differ = [k for k in r0["items"] if not _same(r0["items"][k],
                                                      r1["items"][k])]
        if differ:
            raise AssertionError(f"the ranks' global states differ: {differ}")
        _hold_kernel("sharded rank 1 inputs (its last call)",
                     tuple(x.cuda() if isinstance(x, torch.Tensor) else x
                           for x in r1["pgs_args"]), (n, 112, 24))

        cfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=MESH_ENVS))
        fresh = OnPolicyRunner(NightmareV3Env(cfg, device="cuda"),
                               _mesh_jobs()["recurrent"])
        path = get_load_path(os.path.join(w2, "recurrent"))
        restored = fresh.load(path)
        got = {k: _cpu(v) for k, v in state_items(fresh.ppo).items()}
        saved = r0["items"]
        differ = [k for k in saved if k not in got or not _same(saved[k],
                                                                got[k])]
        print(f"sharded: {os.path.basename(path)} of world 2 reloaded at "
              f"world 1 on the card: full train state {restored}, "
              f"{len(saved)} fields, differing {differ}")
        if not restored or differ or saved.keys() != got.keys():
            raise AssertionError(f"the world-1 reload differs: {differ}")

        _sharded_over_cards(w1, tmp)
    print(f"sharded: {_smi_line(t_phase, device_name, smi)}")


def _same(a, b) -> bool:
    import torch

    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def phase_external(device_name: str, smi: str) -> None:
    import numpy as np
    import torch

    from nightmare_rl_tpu_torch.core.config import (
        EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
    )
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.rl.external import ExternalPPO
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    t0 = time.perf_counter()
    N, T = 256, 16
    cfg = PPOCfg(runner=RunnerCfg(num_steps_per_env=T))
    # 7-step episodes: the rollout resets and bootstraps time-outs
    ecfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=N,
                                               episode_length_s=0.1))
    fused = PPO(NightmareV3Env(ecfg, device="cuda"), cfg)
    fused.init(0)
    env = NightmareV3Env(ecfg, device="cuda")
    state0, obs0 = env.reset(0)
    ext = ExternalPPO(env.num_obs, env.num_actions, N, cfg)
    ext.init(0, obs0.cpu().numpy())
    ext.ppo.net.load_state_dict(fused.net.state_dict())
    box = {"state": state0}

    def step_fn(actions):
        out = env.step(box["state"], torch.as_tensor(actions, device="cuda"))
        box["state"] = out.state
        return tuple(x.cpu().numpy() for x in (out.obs, out.reward, out.done,
                                               out.time_out))

    P.pgs.launches = 0
    sf = fused.learn_step()
    sf_launches = P.pgs.launches
    P.pgs.launches = 0
    se = ext.learn_iteration(step_fn)
    se_launches = P.pgs.launches
    perr = max(float((a - b).abs().max()) for a, b in zip(
        fused.net.state_dict().values(), ext.ppo.net.state_dict().values()))
    print(f"external: ExternalPPO ({ext.ppo.device}) vs fused PPO, {N} envs x "
          f"{T} steps float32: loss {se['loss']:.7f} / {sf['loss']:.7f}, kl "
          f"{se['kl']:.7f} / {sf['kl']:.7f}, max|dparam| {perr:.3e}, dones "
          f"{se['dones']} / {sf['dones']}, pgs launches {se_launches} / "
          f"{sf_launches} (expected {2 * T} and {2 * T + GRAPH_WARMUP * 2}, "
          f"the fused rollout graph's warm-up step included); "
          f"{_smi_line(t0, device_name, smi)}")
    np.testing.assert_allclose(sf["loss"], se["loss"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sf["kl"], se["kl"], rtol=2e-3, atol=1e-6)
    for a, b in zip(fused.net.state_dict().values(),
                    ext.ppo.net.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-3, atol=1e-4)
    if se_launches != 2 * T or sf_launches != 2 * T + GRAPH_WARMUP * 2:
        raise AssertionError("the external or fused rollout skipped the kernel")
    if not se["dones"] == sf["dones"] > 0:
        raise AssertionError("the external and fused rollouts reset differently")


def _withheld_arrow():
    """The block-arrow layout withheld: every model steps through the dense
    mass-matrix branch inside the block."""
    from unittest import mock

    from nightmare_rl_tpu_torch.physics import arrow

    return mock.patch.object(arrow, "layout", lambda sys: None)


def _rel_state(a, b) -> float:
    """``_rel`` of b against a, the worst over qpos, qvel, qacc_warmstart
    and sensordata (those with elements)."""
    return max(_rel(getattr(a, f), getattr(b, f))
               for f in ("qpos", "qvel", "qacc_warmstart", "sensordata")
               if getattr(a, f).numel())


def _host_syncs(fn) -> int:
    """The device-to-host synchronizations that fn() makes, as counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    from nightmare_rl_tpu_torch.tools.profile_step import host_syncs

    return host_syncs(fn)


def phase_dense_hexapod(device_name: str, smi: str) -> tuple:
    """nightmare_v3 with its arrow layout withheld: in float64 one decimated
    step of 2048 envs, dense against arrow; in float32, once the envs have
    landed, 10 env steps of random actions at 2048 envs as replays of the
    env step captured with each branch, finite, no host sync in an eager
    substep or a replay, with the kernel held on the last replayed dense
    inputs and timed beside the arrow path."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import loader, pipeline
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep

    t0 = time.perf_counter()
    N = 2048
    sys_ = dataclasses.replace(loader.load_system("nightmare_v3", device="cuda"),
                               max_contacts=24)
    g = torch.Generator().manual_seed(6)
    st = pipeline.make_state(sys_, N)
    qpos = st.qpos.cpu()
    qpos[:, 7:] += 0.3 * torch.randn(N, 18, generator=g, dtype=torch.float64)
    qpos[:, 2] -= 0.13                          # the feet reach the floor
    st = st.replace(qpos=qpos.cuda(), qvel=torch.randn(
        N, sys_.nv, generator=g, dtype=torch.float64).cuda())
    ctrl = torch.randn(N, sys_.nu, generator=g, dtype=torch.float64).cuda()
    ref = pipeline.step(sys_, st, ctrl, 2)
    with _withheld_arrow(), _kept_pgs() as last64:
        P.pgs.launches = 0
        dense = pipeline.step(sys_, st, ctrl, 2)
        launches = P.pgs.launches
    err64 = _rel_state(ref, dense)
    contacts = float((dense.sensordata > 0).double().mean())
    print(f"dense-hexapod: float64, {N} envs, one decimated step, dense vs "
          f"arrow: max rel err {err64:.3e} (tol {PHYS_TOL:g}), "
          f"{contacts:.1%} of touch sensors loaded")
    if not err64 <= PHYS_TOL or not contacts > 0:
        raise AssertionError("the dense branch disagrees with the arrow path")
    _hold_kernel("dense-hexapod inputs (float64 step)", last64["args"],
                 (N, 112, 24))

    ecfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=N))
    env = NightmareV3Env(ecfg, device="cuda")
    settled, _ = env.reset(0)
    for _ in range(SETTLE_STEPS):              # land on the floor first
        settled = env.step(settled, torch.zeros(N, 18, device="cuda")).state
    acts = 0.3 * torch.randn(10, N, 18, generator=g).cuda()
    walls, syncs, pools = {}, {}, {}
    for mode in ("arrow", "dense"):
        state = settled
        with (_withheld_arrow() if mode == "dense" else contextlib.nullcontext()), \
                _kept_pgs() as last:
            P.pgs.launches = 0
            # the env step captured with the branch of this mode
            step = CapturedStep(env.step, settled, acts[0],
                                generators=[env.generator], state_field="state")
            pools[mode] = step.pool_bytes / 2**20
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for a in acts:
                out = step(state, a)
                state = out.state
            torch.cuda.synchronize()
            walls[mode] = (time.perf_counter() - t1) / len(acts)
            n = P.pgs.launches
            syncs[mode] = (_host_syncs(lambda: pipeline.step(
                env.sys, state.phys, torch.zeros(N, 18, device="cuda"), 1)),
                _host_syncs(lambda: step(state, acts[0])))
        if not torch.isfinite(out.obs).all() or not torch.isfinite(
                state.phys.qpos).all():
            raise AssertionError(f"non-finite {mode} env steps")
        if mode == "dense":
            launches += n
            args32 = last["args"]
    # + the dense capture's warm-up step
    expected = 2 + (GRAPH_WARMUP + 10) * ecfg.control.decimation
    print(f"dense-hexapod: float32, {N} envs x 10 env steps of random actions "
          f"as replays of the captured env step, after {SETTLE_STEPS} "
          f"settling steps on the arrow path: finite; "
          f"{walls['dense'] * 1e3:.2f} ms per env step dense, "
          f"{walls['arrow'] * 1e3:.2f} ms arrow; graph pool {pools['dense']:.1f} "
          f"/ {pools['arrow']:.1f} MiB; host syncs in one eager physics "
          f"substep and in one replay: dense {syncs['dense']}, arrow "
          f"{syncs['arrow']}; pgs launches {launches} "
          f"(expected {expected}); {_smi_line(t0, device_name, smi)}")
    if any(n for ss in syncs.values() for n in ss):
        raise AssertionError(f"the dense-hexapod steps synchronize: {syncs}")
    if launches != expected:
        raise AssertionError(f"pgs kernel ran {launches} times, expected {expected}")
    _hold_kernel("dense-hexapod inputs (its last call)", args32, (N, 112, 24))
    return launches, _time_kernel("dense-hexapod", args32)


def _model_states(sys_, name: str, N: int, seed: int):
    """Seeded initial (qpos, qvel) of N envs of a dense model: the spheres
    spin, roll and slide into the floor (tests/test_condim6.py), the hinge
    starts on both sides of and beyond its limits."""
    import torch

    g = torch.Generator().manual_seed(seed)
    qpos = sys_.qpos0.cpu().expand(N, -1).clone()
    if name == "spheres_condim6":
        qvel = torch.zeros(N, sys_.nv, dtype=torch.float64)
        qvel[:, 3:6] = torch.tensor([0.0, 4.0, 8.0])
        qvel[:, 9:12] = torch.tensor([0.0, 4.0, 8.0])
        qvel[:, [0, 6]] = 0.5
        qvel += 0.5 * torch.randn(N, sys_.nv, generator=g, dtype=torch.float64)
        qpos[:, [2, 9]] -= 0.004 * torch.rand(N, 2, generator=g,
                                              dtype=torch.float64)
    else:
        qpos[:, 0] = 1.2 * torch.rand(N, generator=g, dtype=torch.float64) - 0.6
        qvel = 3.0 * torch.randn(N, 1, generator=g, dtype=torch.float64)
    return qpos, qvel


def phase_dense_models(device_name: str, smi: str) -> tuple:
    """The two dense models shipped as MJCF with their archives (compiled
    by tools/compile_model), 2048 envs: in float64 50 steps on the card
    against the CPU; in float32 10 steps on the card; the kernel held on the
    last inputs of each, and timed on the float32 ones."""
    import torch

    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.physics import loader, pipeline
    from nightmare_rl_tpu_torch.physics import system as S

    N, steps = 2048, 50
    launches, times = 0, {}
    for name, shape in (("spheres_condim6", (N, 18, 12)),
                        ("hinge_dof_rows", (N, 3, 1))):
        t0 = time.perf_counter()
        res = {}
        for dev in ("cuda", "cpu"):
            sys_ = loader.load_system(name, device=dev)
            qpos, qvel = _model_states(sys_, name, N, 7)
            st = pipeline.make_state(sys_, N).replace(qpos=qpos.to(dev),
                                                      qvel=qvel.to(dev))
            ctrl = torch.zeros(N, sys_.nu, dtype=torch.float64, device=dev)
            with _kept_pgs() as last:
                P.pgs.launches = 0
                for _ in range(steps):
                    st = pipeline.step(sys_, st, ctrl, 1)
                n = P.pgs.launches
            res[dev] = st
            if dev == "cuda":
                launches += n
                args64, n64 = last["args"], n
        err = _rel_state(res["cpu"], res["cuda"])
        print(f"dense-models: {name}, float64, {N} envs x {steps} steps, card "
              f"vs CPU: max rel err {err:.3e} (tol {PHYS_TOL:g}); pgs "
              f"launches {n64} (expected {steps}); "
              f"{_smi_line(t0, device_name, smi)}")
        if not err <= PHYS_TOL:
            raise AssertionError(f"{name}: the card disagrees with the CPU")
        if n64 != steps:
            raise AssertionError(f"{name}: pgs kernel ran {n64} times")
        _hold_kernel(f"{name} inputs (float64 step)", args64, shape)

        sys32 = S.tree_cast(loader.load_system(name, device="cuda"),
                            torch.float32)
        qpos, qvel = _model_states(sys32, name, N, 8)
        st = pipeline.make_state(sys32, N).replace(
            qpos=qpos.float().cuda(), qvel=qvel.float().cuda())
        ctrl = torch.zeros(N, sys32.nu, device="cuda")
        with _kept_pgs() as last:
            P.pgs.launches = 0
            for _ in range(10):
                st = pipeline.step(sys32, st, ctrl, 1)
            n = P.pgs.launches
        launches += n
        if n != 10 or not torch.isfinite(st.qpos).all():
            raise AssertionError(f"{name}: float32 steps ran the kernel {n} "
                                 "times or went non-finite")
        _hold_kernel(f"{name} inputs (float32, its last call)", last["args"],
                     shape)
        times[name] = _time_kernel(name, last["args"])
    return launches, times


def phase_curve(device_name: str, smi: str, tmp: str) -> int:
    """tools/compare_reference_curve --side tpu, 256 envs x 2 iterations,
    seeds 1 and 2: rows with the JAX tool's keys, and seeded networks that
    differ (their first-iteration losses differ)."""
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import compare_reference_curve as crc

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "logs", "curvecmp", "tpu_s1",
                           "metrics.jsonl")) as fh:
        jax_rows = [json.loads(ln) for ln in fh]
    jax_keys = set().union(*(r.keys() for r in jax_rows))
    base = set(jax_rows[1])                     # a row without episode terms
    rows, launches = {}, 0
    for seed in (1, 2):
        P.pgs.launches = 0
        path = crc.main(["--side", "tpu", "--envs", "256", "--iters", "2",
                         "--seed", str(seed), "--out",
                         os.path.join(tmp, f"torch_s{seed}")])
        n = P.pgs.launches
        launches += n
        with open(path) as fh:
            rows[seed] = [json.loads(ln) for ln in fh]
        if n != 2 + 2 * 80 * 2:
            raise AssertionError(f"seed {seed}: pgs kernel ran {n} times")
    for seed, rs in rows.items():
        for r in rs:
            if not base <= set(r) <= jax_keys or not all(
                    math.isfinite(v) for v in r.values()):
                raise AssertionError(f"seed {seed}: row {r} lacks the JAX "
                                     "tool's keys or is not finite")
    l1, l2 = rows[1][0]["loss"], rows[2][0]["loss"]
    print(f"curve: compare_reference_curve --side tpu, 256 envs x 2 iterations: "
          f"first-iteration loss {l1:.6f} (seed 1) vs {l2:.6f} (seed 2), mean "
          f"reward {rows[1][-1]['mean_reward']:+.4f} / "
          f"{rows[2][-1]['mean_reward']:+.4f}; keys as the JAX tool's; pgs "
          f"launches {launches}; {_smi_line(t0, device_name, smi)}")
    if l1 == l2:
        raise AssertionError("seeds 1 and 2 trained the same network")
    return launches


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # the phases that hold the dense kernel pin it; the legs phases and the
    # probe set NIGHTMARE_PGS themselves
    os.environ["NIGHTMARE_PGS"] = "kernel"
    phase_build()
    phase_kernel()
    phase_kernel_legs()
    phase_physics()
    phase_physics_legs()
    graph = phase_graph(name, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches, pgs_args, runner = phase_slice(name, smi, tmp)
        phase_recorder_resume(runner, tmp, name, smi)
    phase_slice_rates(runner, name, smi)
    phase_update_graph(runner, "nightmare_v3 feed-forward", name, smi)
    entry = phase_main_path_kernel(pgs_args, launches)
    phase_policy(runner.ppo.obs)
    del runner
    legs_entry = phase_slice_legs(name, smi)
    phase_physics_anymal()
    graph_anymal = phase_graph_anymal(name, smi)
    newton_args, slice_newton = phase_slice_anymal(name, smi)
    phase_newton_converged(newton_args)
    eval_newton = phase_eval_anymal(name, smi)
    newton_entry = dict(
        name="newton", route="cuda",
        source="nightmare_rl_tpu_torch/ops/csrc/newton.cu",
        replaces="nightmare_rl_tpu/physics/newton.py:214",
        launches=graph_anymal["launches"] + slice_newton + eval_newton,
        **phase_newton_kernel(newton_args, name, smi), library_ms=None)
    print(f"kernel: newton launches {newton_entry['launches']} = "
          f"graph-anymal {graph_anymal['launches']} + slice-anymal "
          f"{slice_newton} + eval-anymal {eval_newton}")
    phase_play_grid(name, smi)
    phase_custom_play(name, smi)
    phase_simple_test(name, smi)
    phase_recurrent_net(name, smi)
    recurrent = phase_slice_recurrent(name, smi)
    phase_update_graph(recurrent, "nightmare_v3 recurrent", name, smi)
    del recurrent
    phase_sharded(name, smi)
    phase_external(name, smi)
    hex_launches, hex_t = phase_dense_hexapod(name, smi)
    model_launches, model_t = phase_dense_models(name, smi)
    with tempfile.TemporaryDirectory() as tmp:
        curve_launches = phase_curve(name, smi, tmp)
        phase_probe(name, smi, tmp)
    shapes = [("dense-hexapod 2048x112x24", hex_t)] + [
        (f"{k} {s}", model_t[k]) for k, s in (
            ("spheres_condim6", "2048x18x12"), ("hinge_dof_rows", "2048x3x1"))]
    print("kernel: pgs per shape (float32): " + "; ".join(
        f"{lbl}: {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
        f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}" for lbl, t in shapes))
    entry["launches"] += hex_launches + model_launches + curve_launches
    print(f"kernel: pgs launches {entry['launches']} = slice {launches} + "
          f"dense-hexapod {hex_launches} + dense-models {model_launches} + "
          f"curve {curve_launches}")
    print("graph: wall ms per env step at 2048 envs, eager / graph in turns: "
          + "; ".join(f"{form} {min(r['eager_ms']):.2f} / "
                      f"{min(r['graph_ms']):.2f} ms (pool {r['pool_mib']:.1f} "
                      f"MiB)" for form, r in graph.items())
          + f"; anymal_c {min(graph_anymal['eager_ms']):.2f} / "
          f"{min(graph_anymal['graph_ms']):.2f} ms (pool "
          f"{graph_anymal['pool_mib']:.1f} MiB)")
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [entry, legs_entry, newton_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
