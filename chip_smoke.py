#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nightmare_rl_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

1. device  — the card's name and ``nvidia-smi`` name/power limit;
2. build   — nvcc builds ``ops/csrc/pgs.cu``, ``ops/csrc/pgs_legs.cu``,
             ``ops/csrc/newton.cu``, ``ops/csrc/smooth.cu``,
             ``ops/csrc/integrate.cu``, ``ops/csrc/assemble.cu``,
             ``ops/csrc/task.cu``, ``ops/csrc/rollout.cu``,
             ``ops/csrc/solve_out.cu`` and ``ops/csrc/learn.cu`` for sm_90a
             from the checkout, all at once; prints ptxas's
             registers and spills (the float32 kernels must not spill) and
             each kernel's main-path launch geometry (the assemble
             kernel's for both robots): lanes per env, shared memory per
             block and envs resident per SM;
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
             replay, and the smooth, integrate, assemble and solve_out
             kernels as many, and one launch each of the task kernels'
             ``pre`` and ``post``; an eager step's kernels and the graph's
             kernel nodes beside those with the solve's output stage as
             plain torch ops (the legs form's at most EAGER_NIGHTMARE and
             NODES_NIGHTMARE); then wall ms per env
             step in turns (eager, graph, graph, eager), the capture's time
             and the graph's pool;
5. slice   — the training CLI's code path: nightmare_v3, 2048 envs, float32,
             reset + 2 PPO iterations; the loss must be finite and the PGS
             kernel must have run on every substep (the rollout replays one
             captured step; its eager warm-up step counts), and so must the
             smooth, the integrate, the assemble and the solve_out kernel,
             and the
             rollout kernels once per rollout step (so too in slice-legs,
             slice-anymal and slice-recurrent), and the learn kernels one
             ``gae`` an iteration and one ``grads`` and one ``adam`` a
             minibatch, with one each for the captured parts' warm-ups (so
             too in slice-legs and slice-anymal; slice-recurrent no
             ``grads``: its LSTM replay stays plain), no plain version of
             them called.  The inputs of
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
             for bit, no host sync inside the parts, the learn kernels on
             every eager and replayed call; then seconds per update in
             turns (eager, graph, graph, eager), the parts' capture seconds
             and pools;
6. main-path kernel — the PGS kernel against ``pgs_reference`` on those
             float32 inputs (a minimum share of active rows is asserted),
             with CUDA-event times for both;
6b. smooth-kernel — the smooth kernel (``ops/csrc/smooth.cu``: kinematics
             to qfrc_smooth, the arrow factor and qacc_smooth) against its
             plain version (``ops/smooth.py::plain``) on the card:
             nightmare_v3, anymal_c and spheres_condim6 (no arrow layout)
             at N = 1, 37, 2047, 2048, 4096 (two waves of 2,112) in
             float64 (SMOOTH_F64_TOL) and float32 (SMOOTH_F32_TOL), per env
             and output field, with envs whose qvel or a joint angle is NaN
             (NaN positions equal); then on the slice's last smooth call,
             timed with its plain version, and timed at that call's envs
             and twice as many (the inputs repeated), each beside the
             first design's time (FIRST_DESIGN_MS) and with its bound's
             share;
6c. integrate-kernel — the integrate kernel (``ops/csrc/integrate.cu``:
             the integrator's solve, integratePos and the reset) against
             ``ops/integrate.py::plain_update`` in each integrator branch
             (implicitfast: nightmare_v3; Euler with implicit damping and
             plain Euler: anymal_c) at the same N and dtypes, with a NaN
             env and one driven past 1e10 (both reset); then on the
             slice's last update, timed at its envs and twice as many
             beside FIRST_DESIGN_MS, with its bound's share;
6d. assemble-kernel — the assemble kernel (``ops/csrc/assemble.cu``:
             collision, the top-K and top-Kp selections, every constraint
             row, b, the leg slots, the Newton flags and cones) against
             ``ops/assemble.py::plain`` on nightmare_v3 (top 24) and
             anymal_c (top 8) at 2048 and 4096 envs, with a NaN env, a NaN
             leg and a tie env: float64 indices equal in every env and
             values within ASSEMBLE_F64_TOL; float32 indices equal in every
             env whose selections are decided by more than ASSEMBLE_GAP
             (the others counted and printed) and values within
             ASSEMBLE_F32_TOL; then on the slice's last call (every env's
             selections held); then both robots timed alone at 2048 and
             4096 envs beside the plain version and the byte bound;
6e. task-kernel — the task kernels (``ops/csrc/task.cu``: ``pre``, the
             actions and the control law; ``post``, the readings, command
             resampling, terminations, resets, reward terms and the
             observation) against ``ops/task.py``'s plain versions on the
             card, float32, nightmare_v3 and anymal_c at 2048 and 4096
             envs, on states after a few env steps with resets, resamples,
             edge envs (a time-out, foot forces at the limit and one ulp
             over, NaN in qvel and in a foot force) and TASK_SWEEP envs ulp
             by ulp across the 60° tilt and across each command cut: 0
             envs whose flags, episode counts or commands differ, values
             within TASK_F32_TOL, ``pre`` bit for bit; then each robot's
             pair of launches timed alone at both sizes beside the plain
             versions and the byte bound;
6f. rollout-kernel — the rollout kernels (``ops/csrc/rollout.cu``:
             ``act``, the actor's and critic's MLPs, the sample and its
             log-probability into row t of the trajectory; ``store``, the
             timeout bootstrap, done, env 0's record row, the finished
             sums and t + 1) against ``ops/rollout.py``'s plain versions
             on the card, float32: nightmare_v3 with fresh weights and
             with model_3176's, anymal_c with fresh weights, at 2048 and
             4096 envs, and the recurrent heads (rnn 512) at 2048; env 7's
             observation NaN, 8 envs at their time-out: every field within
             ROLLOUT_F32_TOL of its scale, NaN at the plain version's
             positions, the obs and sigma rows, done, the record row, t + 1
             and the episode count exact; then the captured rollout step
             at 2048 envs, ROLLOUT_ROWS replays bit for bit against the
             eager calls, and a replay after the weights and std were
             scaled in place reading the new ones; each case's kernels
             timed alone beside the plain versions, the MLPs' cuBLAS
             products and the bounds, with ptxas's registers and spills;
6g. solve-out-kernel — the solve's output stage (``ops/csrc/solve_out.cu``:
             qfrc = Jᵀf, qacc, the normal forces' scatter and the touch
             sensors) against ``ops/solve_out.py::plain`` on the card,
             float32, in each of the solve's forms (nightmare_v3 legs and
             dense, anymal_c Newton) at 2048 and 4096 envs, on the last
             substep of SOLVE_OUT_STEPS eager env steps: every field within
             SOLVE_OUT_F32_TOL of its scale, NaN at the plain version's
             positions, and every selected point whose rows carry no force
             (and no pair's) at exactly 0; each case timed alone beside the
             plain version and the byte bound;
6h. learn-kernel — the learn kernels (``ops/csrc/learn.cu``: ``gae``,
             GAE's recursion and the mean advantage; ``grads``, a
             minibatch's forward pass, losses, backward pass, gradients and
             KL; ``adam``, the mean over the ranks, the adaptive lr, the
             clip and Adam's step) against ``ops/learn.py``'s plain
             versions on the card, float32, after a rollout of each of
             LEARN_CASES (nightmare_v3 at 2048 and 4096 envs, minibatches
             of 40,960 and 81,920 samples; anymal_c's net, 48 -> 12, at
             2048), each kernel on the plain version's inputs: gae within
             GAE_F32_TOL, each gradient tensor within GRADS_F32_TOL of its
             largest magnitude (the largest error printed by tensor), the
             losses and the KL within LOSS_F32_TOL, Adam's parameters
             within ADAM_PARAM_F32_TOL and its moments within ADAM_F32_TOL,
             the step counts and the lr exact, the KL printed beside the
             adaptive rule's band; every kernel's second call equal to its
             first bit for bit; each timed alone beside its plain version
             (adam also beside torch's fused Adam with the clip's ops) and
             its bound, with ptxas's registers and spills, grads' grid,
             shared memory a block and blocks an SM; adam also on the
             recurrent net's 2,434,795 parameters (random gradients and
             Adam state from a seed), held and timed so; grads also on
             nightmare_v3's net with ELU's alpha at -0.5 (2048 envs),
             within the same tolerances;
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
             replay, 4 launches of the Newton, smooth, integrate, assemble
             and solve_out kernels each and one of each task kernel per
             replay; an eager step's kernels and the graph's nodes by type
             beside those with the solve's output stage as plain torch ops
             (at most EAGER_ANYMAL and NODES_ANYMAL kernel nodes); wall ms
             per env step in turns (eager,
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
             step at a converged budget, 1e-9: all 16 envs with the card's
             smooth half, assembly, output stage and update as plain torch
             ops (the step as the card ran it before their kernels), and,
             with every
             kernel,
             the envs whose plain solves decide above the line-search
             floor (those on it printed); then the kernel's device
             time (``_kernel_ms``), the plain version's CUDA-event time and
             its bound;
11. recorder/resume (right after the slice) — the slice's runner recorded
             env 0: it received 2 × 80 frames with finite qpos; the
             ``model_2.pt`` it saved, loaded into a fresh runner on the card,
             restores every field of the train state exactly;
12. play-grid — ``tools/play.py``'s ``grid_eval`` of
             ``artifacts/model_3176.pt``: 7 commands × 400 steps,
             deterministic, float32; zero falls on every row, achieved vx at
             least 80 % of the command on the ±0.3 m/s straight rows, and the
             PGS, smooth, integrate, assemble and solve_out kernels on
             every substep, the PGS
             kernel held against ``pgs_reference`` on the inputs of its
             last call;
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
the curve phase, ``pgs_legs``, whose launches are slice-legs',
``newton``, whose launches are graph-anymal's, slice-anymal's and
eval-anymal's, and ``smooth``, ``integrate``, ``assemble`` and
``solve_out``, whose launches (one each per substep of every path) are the
slice's,
graph-anymal's and play-grid's, each read from its own wrapper's counter, each counted from
zero (the launches that hold a kernel against its plain version are not
counted).  Every kernel's ``ms`` there is ``_kernel_ms``'s: device time
per call, each call alone behind a spin kernel and a write that flushes
the L2 cache.  ``task`` is the task kernels' pair of launches per env step
(its ``ms``, ``plain_ms`` and ``bound_ms`` those of ``pre`` and ``post``
together at nightmare_v3's 2048 envs); its launches are those of every
path that steps an env (graph, graph-anymal, slice, slice-legs,
slice-anymal, eval-anymal and play-grid: one ``pre`` and one ``post`` per
env step, each phase checked, ``TASK_LAUNCHES``); custom-play's control
step drives the physics without an env and launches none.  ``rollout.act``
and ``rollout.store`` are the rollout kernels (their ``ms``, ``plain_ms``,
``bound_ms`` and ``library_ms`` at nightmare_v3's 2048 envs, fresh
weights; ``library_ms`` of ``act`` is the MLPs' cuBLAS products and
activations alone, ``store`` has none); their launches are those of the
training slices (slice, slice-legs, slice-anymal, slice-recurrent: one of
each per rollout step, the capture's warm-up step included, each phase
checked, ``ROLLOUT_LAUNCHES``).  ``solve_out``'s ``ms``, ``plain_ms`` and
``bound_ms`` are the legs form's at nightmare_v3's 2048 envs (the CLI's
form on the card).  ``learn.gae``, ``learn.grads`` and ``learn.adam`` are
the learn kernels (their figures learn-kernel's at 2048 envs;
``library_ms`` of ``adam`` is torch's fused Adam with the clip's ops, the
others have none); their launches are those of the training slices
(``LEARN_LAUNCHES``: slice, slice-anymal, slice-legs, slice-recurrent) and
of update-graph's seven learning halves per net.

The line before the nvidia-smi line is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA card and the repo.  The
sharded phase runs this script again as its ranks (``--mesh-worker``, see
``mesh_worker``); tests/test_torch_sharded.py runs the same ranks on the
CPU.  ``python3 chip_smoke.py --mjx-seeds FIRST LAST`` prints newton-kernel's
nightmare_v3_mjx comparison at each seed of the range (``mjx_seeds``).
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
H100_F64_FLOPS = 34e12       # float64 outside the tensor cores (data sheet)
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
# the smooth and integrate kernels against their plain versions, per env and
# field: max|err| / max|plain|.  float64: round-off of the same arithmetic
# in another order (FMA contraction, einsum sums).  float32: the same
# round-off (eps 6e-8) amplified by the arrow solves' condition (~1e3)
SMOOTH_F64_TOL = 1e-12
SMOOTH_F32_TOL = 1e-4
SMOOTH_NS = (1, 37, 2047, 2048, 4096)
# The first design of the smooth and integrate kernels (commit fcb3049), ms
# per launch alone with the L2 flushed at 2048 and 4096 envs (PERF.md §6:
# this script and tools/profile_smooth.py on an NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's
FIRST_DESIGN_MS = {"smooth": (0.0794, 0.1467), "integrate": (0.0367, 0.0543)}
# kernel nodes of one captured env step at most (6,269 and 10,625 when the
# smooth half and the update ran as plain torch ops, 771 and 2,293 when the
# collision and row assembly did, 181 and 197 when the env's task half did,
# 34 and 64 when the solve's output stage did), and kernels of one eager
# env step at most (nightmare_v3 in the legs form)
NODES_NIGHTMARE, NODES_ANYMAL = 20, 40
EAGER_NIGHTMARE, EAGER_ANYMAL = 20, 40
# an eager env step's kernels and the captured step's kernel nodes with the
# solve's output stage as plain torch ops (this script on the commit before
# ops/csrc/solve_out.cu, NVIDIA H100 80GB HBM3, 700 W), printed beside this
# run's
STAGE_PLAIN_KERNELS = {"legs": (40, 34), "kernel": (196, 190),
                       "anymal_c": (80, 64)}
# the assemble kernel against its plain version, per env and output field:
# max|err| / max|plain|.  float64: round-off of the row products' sums in
# another order; float32: the same at float32's eps, amplified where J·qvel
# cancels.  float32's selections are held where the K-th and (K+1)-th
# distances differ by more than ASSEMBLE_GAP (relative)
ASSEMBLE_F64_TOL = 1e-9
ASSEMBLE_F32_TOL = 1e-4
ASSEMBLE_GAP = 1e-5
ASSEMBLE_NS = (2048, 4096)
# the task kernels against their plain versions, float32, per output field:
# max|err| / max(1, max|plain|) (the kernels round op for op as the plain
# version; only the sums' order differs); flags, episode counts and
# commands must be equal in every env
TASK_F32_TOL = 1e-5
TASK_NS = (2048, 4096)
TASK_SWEEP = 64              # envs of a sweep across a cut, ulp by ulp
# the rollout kernels against their plain versions, float32, per field:
# max|err| / max|plain| (the MLPs' products sum in another order than
# cuBLAS's; the finished sums in another than torch.nansum's); the obs and
# sigma rows, done, the record row, t + 1 and the episode count exact
ROLLOUT_F32_TOL = 1e-5
ROLLOUT_NS = (2048, 4096)
ROLLOUT_ROWS = 4             # rows of rollout-kernel's trajectory buffers
# the solve_out kernel against its plain version, float32, per output field:
# max|err| / max|plain| (Jᵀf, M⁻¹qfrc and the sensors sum in another order
# than cuBLAS's; the facet sums in another than torch.sum's; the scatter's
# sets and adds in the plain version's order)
SOLVE_OUT_F32_TOL = 1e-5
SOLVE_OUT_NS = (2048, 4096)
SOLVE_OUT_STEPS = 30         # eager env steps (landed) whose last substep is held
# (robot, PGS form, the form's name): the solve's three forms
SOLVE_OUT_CASES = (("nightmare_v3", "legs", "legs"),
                   ("nightmare_v3", "kernel", "dense"),
                   ("anymal_c", None, "newton"))
# the learn kernels against their plain versions on the same inputs, float32:
# gae's advantages and returns over max|advantage| (80 dependent steps, each
# product and sum rounded as the plain version's ops round them; the mean's
# sum of T·N terms in another order than torch.mean's); each gradient tensor
# over its largest magnitude (40,960 or 81,920 samples summed in tiles of
# 32, then by block, group and grid, in another order than cuBLAS's and
# autograd's); the losses and the KL over 1 + |value| (the same sums);
# Adam's moments, the clipped gradients and the statistics over their
# largest magnitude, the parameters over theirs (a few ulps: a step of ~1e-3
# rounds into parameters of ~1; the global norm's 15,043 squares summed in
# another order); the step counts and the lr exact
# (robot, envs): nightmare_v3's net (66 -> [54, 42, 30] -> 18 and 1) at the
# main path's 2048 envs and at 4096, anymal_c's (48 -> 12) at 2048
LEARN_CASES = (("nightmare_v3", 2048), ("nightmare_v3", 4096),
               ("anymal_c", 2048))
GRADS_THREADS = 256          # learn.cu kGradsThreads
GAE_F32_TOL = 1e-6
GRADS_F32_TOL = 1e-4
LOSS_F32_TOL = 1e-5
ADAM_F32_TOL = 1e-5
ADAM_PARAM_F32_TOL = 1e-6
BUILD_PTXAS = {}             # phase_build's ptxas lines, by kernel source


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


L2_FLUSH_BYTES = 256 * 2**20   # _kernel_ms: over 5x the H100's L2 cache
SPIN_CYCLES = 4_000_000        # _kernel_ms: ~2 ms, longer than a call's host time


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


def _kernel_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of a kernel's wrapper, the one yardstick
    of the kernels' line: each call timed alone by a pair of CUDA events,
    queued behind a spin kernel (so the host's time per call is left out)
    and a write of L2_FLUSH_BYTES (so the call finds neither its inputs nor
    the last call's outputs in the 50 MB L2 cache, and the bound's bytes
    at the HBM rate compare with it); the mean over ``reps`` calls."""
    import torch

    fn()  # lazy set-up
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
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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
            stack = re.search(r"(\d+) bytes stack frame", ln)
            if stack:
                fn["stack"] = int(stack[1])
        elif fn is not None and "registers" in ln:
            fn["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
    return kernels


def phase_build() -> None:
    """Build the kernels (one nvcc each, started together) and report what
    ptxas and the occupancy queries say."""
    import concurrent.futures

    import torch

    from nightmare_rl_tpu_torch.ops import assemble as AS
    from nightmare_rl_tpu_torch.ops import build
    from nightmare_rl_tpu_torch.ops import newton as K
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.ops import smooth as SM
    from nightmare_rl_tpu_torch.physics import arrow, loader

    names = ("pgs", "pgs_legs", "newton", "smooth", "integrate", "assemble",
             "task", "rollout", "solve_out", "learn")
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
    for name in ("smooth", "integrate", "assemble", "solve_out"):
        kernels[name] = _ptxas(
            infos[name]["log"], name + r"_kernelI([fd])E",
            lambda m, name=name: f"{name}_kernel<"
                                 f"{'float' if m[1] == 'f' else 'double'}>")
    robots = ("nightmare_v3", "anymal_c")
    kernels["task"] = _ptxas(
        infos["task"]["log"], r"task_(pre|post)_kernelI([fd])Li(\d)E",
        lambda m: f"task_{m[1]}_kernel<"
                  f"{'float' if m[2] == 'f' else 'double'}, {robots[int(m[3])]}>")
    kernels["rollout"] = _ptxas(
        infos["rollout"]["log"], r"rollout_(act|store)_kernelI([fd])E",
        lambda m: f"rollout_{m[1]}_kernel<"
                  f"{'float' if m[2] == 'f' else 'double'}>")
    kernels["learn"] = _ptxas(
        infos["learn"]["log"],
        r"learn_(gae|grads|adam_sums|adam_step)_kernelI([fd])E",
        lambda m: f"learn_{m[1]}_kernel<"
                  f"{'float' if m[2] == 'f' else 'double'}>")
    BUILD_PTXAS.update(kernels)
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
    hexapod = loader.load_system("nightmare_v3", dtype=torch.float32,
                                 device="cuda")
    plan = SM.model_plan(hexapod, arrow.layout(hexapod))
    fits = []
    for name in ("smooth", "integrate"):
        geo = SM.kernel_geometry(plan.fields, 4, name)
        fits.append(SM.envs_per_sm(geo, torch.float32, name))
        print(f"build: {name} nightmare_v3 (nbody=20, nv=24, float32): one "
              f"warp per env, {geo.envs_per_block} envs per block, "
              f"{geo.smem_bytes} B shared per block, {fits[-1]} envs resident "
              f"per SM x {sms} SMs = {fits[-1] * sms} per wave "
              f"({math.ceil(2048 / (fits[-1] * sms))} waves at N=2048)")
    for name, K in ASSEMBLE_MODELS:
        sys_, lay = _assemble_system(name, K, torch.float32)
        f = AS.model_plan(sys_, lay).fields
        geo = AS.geometry(f, 4)
        fits.append(AS.envs_per_sm(geo, torch.float32))
        print(f"build: assemble {name} (ncp={f['ncp']}, top {f['K']}, "
              f"{f['npair']} pairs, top {f['Kp']}, nefc={f['nefc']}, "
              f"nv={f['nv']}, float32): one warp per env, "
              f"{geo.envs_per_block} envs per block, {geo.smem_bytes} B "
              f"shared per block ({geo.tables} of tables), {fits[-1]} envs "
              f"resident per SM x {sms} SMs = {fits[-1] * sms} per wave "
              f"({math.ceil(2048 / (fits[-1] * sms))} waves at N=2048)")
    if per_sm < 1 or legs_sm < 1 or newton_sm < 1 or min(fits) < 1:
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
    kern_ms = _kernel_ms(lambda: P.pgs(*args))
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
    with _kept_pgs() as last, _kept_smooth() as kept, \
            _plain_learn_calls() as plain:
        P.pgs.launches = 0
        _zero_smooth()
        _zero_task()
        _zero_rollout()
        _zero_learn()
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
    smooth = dict(kept=kept, launches=_check_smooth("slice", expected))
    _check_task("slice", expected // dec)
    _check_rollout("slice", iters * T + GRAPH_WARMUP)
    _check_learn("slice", _learn_expected(runner.cfg, iters))
    _no_plain_learn("slice", plain)
    return launches, last["args"], runner, smooth


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
        _zero_task()
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
                                generators=[env.generator], state_field="state",
                                debug=True)
            capture_s = time.perf_counter() - t1
            nodes = step.node_counts().get("KERNEL", 0)
            smooth_per = [step.launches.get(fn.__name__, 0)
                          for fn in _smooth_fns()]
            task_per = [step.launches.get(k, 0) for k in TASK_WRAPPERS]
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
            eager_k = _eager_kernels("nightmare_v3")
        pool = step.pool_bytes / 2**20
        print(f"graph: {form} form, {N} envs float32, {GRAPH_STEPS} env steps "
              f"eager and as replays of one captured step from one state: "
              f"StepOut fields equal bit for bit at every step: {not differ} "
              f"(differing {differ[:6]}); env generator state equal "
              f"{same_gen}; host syncs per replay {syncs}; "
              f"{counter.__name__} launches per replay {per_replay:g} "
              f"(expected {dec}), {other.__name__} {other.launches}; smooth, "
              f"integrate, assemble and solve_out launches per replay "
              f"{smooth_per} (expected {dec} each); task pre and post "
              f"launches per replay {task_per} (expected 1 each); an eager "
              f"env step launches {eager_k:.0f} kernels, the graph holds "
              f"{nodes} kernel nodes (with the solve's output stage as plain "
              f"torch ops: {STAGE_PLAIN_KERNELS[form][0]} and "
              f"{STAGE_PLAIN_KERNELS[form][1]}); "
              f"warm-up "
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
        if smooth_per != [dec] * len(STEP_KERNELS):
            raise AssertionError(f"a {form} replay launches the smooth, "
                                 f"integrate, assemble and solve_out kernels "
                                 f"{smooth_per} times")
        if task_per != [1] * len(TASK_WRAPPERS):
            raise AssertionError(f"a {form} replay launches the task kernels "
                                 f"{task_per} times")
        _check_task(f"graph {form}")
        if form == "legs" and (nodes > NODES_NIGHTMARE
                               or eager_k > EAGER_NIGHTMARE):
            raise AssertionError(f"the legs-form step launches {eager_k:.0f} "
                                 f"kernels eagerly (at most "
                                 f"{EAGER_NIGHTMARE}), its graph holds "
                                 f"{nodes} kernel nodes (at most "
                                 f"{NODES_NIGHTMARE})")
        res[form] = dict(eager_ms=walls["eager"], graph_ms=walls["graph"],
                         capture_s=capture_s, pool_mib=pool, nodes=nodes,
                         eager_kernels=eager_k)
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
    the Newton kernel's launches in the phase, and the smooth and the
    integrate kernel's (``smooth_launches``), with the rest."""
    import torch

    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
    from nightmare_rl_tpu_torch.ops.newton import newton_solve
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    N, steps = 2048, ANYMAL_GRAPH_STEPS
    t0 = time.perf_counter()
    newton_solve.launches = 0
    _zero_smooth()
    _zero_task()
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
    smooth_per = [step.launches.get(fn.__name__, 0) for fn in _smooth_fns()]
    task_per = [step.launches.get(k, 0) for k in TASK_WRAPPERS]
    dones = int(sum(int(o.done.sum()) for o in eager))
    syncs = _host_syncs(lambda: step(state, acts[0]))
    walls = {"eager": [], "graph": []}
    timed = acts[:ANYMAL_TIMED_STEPS]
    for who in ("eager", "graph", "graph", "eager"):
        walls[who].append(_env_step_ms(env.step if who == "eager" else step,
                                       s0, timed))
    eager_k = _eager_kernels("anymal_c")
    pool = step.pool_bytes / 2**20
    print(f"graph-anymal: {N} envs float32, Newton {env.sys.solver_iterations} "
          f"iterations, decimation {env.cfg.decimation}, {steps} env steps "
          f"eager and as replays of one captured step from one state "
          f"({dones} resets): StepOut fields equal bit for bit at every step: "
          f"{not differ} (differing {differ[:6]}); env generator state equal "
          f"{same_gen}; host syncs per replay {syncs}; newton kernel "
          f"launches per replay {per_replay}, smooth, integrate, assemble "
          f"and solve_out {smooth_per}, task pre and post {task_per}; an "
          f"eager env step launches {eager_k:.0f} kernels, the graph holds "
          f"{nodes.get('KERNEL', 0)} kernel nodes ({sum(nodes.values())} "
          f"nodes: {nodes}; with the solve's output stage as plain torch "
          f"ops: {STAGE_PLAIN_KERNELS['anymal_c'][0]} and "
          f"{STAGE_PLAIN_KERNELS['anymal_c'][1]}); warm-up step "
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
    if (per_replay != env.cfg.decimation
            or smooth_per != [per_replay] * len(STEP_KERNELS)):
        raise AssertionError(f"an anymal_c replay launches the newton, smooth, "
                             f"integrate, assemble and solve_out kernels "
                             f"{per_replay}, {smooth_per} times, not "
                             f"{env.cfg.decimation}")
    if task_per != [1] * len(TASK_WRAPPERS):
        raise AssertionError(f"an anymal_c replay launches the task kernels "
                             f"{task_per} times")
    _check_task("graph-anymal")
    if nodes.get("KERNEL", 0) > NODES_ANYMAL or eager_k > EAGER_ANYMAL:
        raise AssertionError(f"the anymal_c step launches {eager_k:.0f} "
                             f"kernels eagerly (at most {EAGER_ANYMAL}), its "
                             f"graph holds {nodes.get('KERNEL', 0)} kernel "
                             f"nodes (at most {NODES_ANYMAL})")
    counts = _smooth_counts()
    print("graph-anymal: " + ", ".join(f"{k} launches {v}"
                                       for k, v in counts.items())
          + " (one each per substep of every eager step, warm-up and replay)")
    if len(set(counts.values())) != 1 or counts["smooth"] < 1:
        raise AssertionError(f"graph-anymal: the smooth, integrate, assemble "
                             f"and solve_out kernels ran {counts} times")
    return dict(eager_ms=walls["eager"], graph_ms=walls["graph"],
                capture_s=step.capture_s, record_s=step.record_s,
                warmup_s=step.warmup_s, pool_mib=pool, nodes=nodes,
                eager_kernels=eager_k, launches=newton_solve.launches,
                smooth_launches=counts)


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
    _zero_learn()
    with _plain_learn_calls() as plain:
        held = _hold_learner(ppo)
    # seven learning halves: eager and replayed once each, replayed once
    # more with the parts' syncs counted, then eager, graph, graph, eager
    _check_learn(f"update-graph ({label})", _learn_expected(
        ppo.cfg, 7, recurrent=ppo.recurrent, warmup=0))
    _no_plain_learn(f"update-graph ({label})", plain)
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

    legs_ms = _kernel_ms(lambda: P.pgs_legs(*args))
    dense_ms = _kernel_ms(dense)
    pgs_ms = _kernel_ms(lambda: P.pgs(J, U, b, R, lo, hi, it, ns, ns_offset))
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
            _kept_pgs("pgs_legs") as last, _plain_learn_calls() as plain:
        P.pgs_legs.launches = P.pgs.launches = 0
        _zero_task()
        _zero_rollout()
        _zero_learn()
        runner = train.main(["-e", str(envs), "-n", "1", "--log_root", tmp])
        torch.cuda.synchronize()
        launches, dense = P.pgs_legs.launches, P.pgs.launches
    stats = runner.last_stats
    T = runner.cfg.runner.num_steps_per_env
    dec = runner.env.cfg.control.decimation
    # + the reset's zero-action step and the rollout graph's warm-up step
    expected = T * dec + dec + GRAPH_WARMUP * dec
    _check_task("slice-legs", expected // dec)
    _check_rollout("slice-legs", T + GRAPH_WARMUP)
    _check_learn("slice-legs", _learn_expected(runner.cfg, 1))
    _no_plain_learn("slice-legs", plain)
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
    _zero_task()
    _zero_rollout()
    _zero_learn()
    solver.newton_solve = kept
    try:
        with tempfile.TemporaryDirectory() as tmp, _counted_replays() as rep, \
                _plain_learn_calls() as plain:
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
    _check_task("slice-anymal", expected // dec)
    _check_rollout("slice-anymal", iters * T + GRAPH_WARMUP)
    _check_learn("slice-anymal", _learn_expected(runner.cfg, iters))
    _no_plain_learn("slice-anymal", plain)
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
    _zero_task()
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
    if _check_task("eval-anymal")["pre"] < EVAL_STEPS:
        raise AssertionError("eval-anymal: fewer task kernel launches than "
                             "steps")
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


def _newton_mjx_steps(seed: int = 2) -> dict:
    """nightmare_v3_mjx (pyramidal cones: no cone group, then noslip): one
    step of 2 substeps at 16 envs in float64, the card against the CPU (the
    plain versions) at a converged budget, as tests/test_torch_anymal.py
    holds the JAX package.  Returns per env the largest error relative to
    each field's scale for three card steps: ``kernels``, the main path,
    every kernel; ``before``, the card's smooth half, collision and row
    assembly, the solve's output stage and update as plain torch ops and
    the Newton kernel solving, the step as the card ran it before the
    smooth, integrate, assemble and solve_out kernels; ``plain``, every
    part as plain torch ops.  And ``held``: the envs whose plain solves decide above the
    line-search floor (margin at least NEWTON_FLOOR in both substeps, from
    the CPU's solves traced), as newton-kernel's float64 cases hold the
    kernel.  Past the floor a step parts from the CPU's by up to ~2e-8
    under round-off alone, the plain version's on the card too, and which
    floor envs part depends on the last ulp of the inputs (``--mjx-seeds``;
    PERF.md §6; tests/test_torch_smooth_kernel.py::
    test_mjx_step_above_the_floor_is_stable_under_round_off)."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.ops import assemble as AS
    from nightmare_rl_tpu_torch.ops import integrate as IN
    from nightmare_rl_tpu_torch.ops import smooth as SM
    from nightmare_rl_tpu_torch.ops import solve_out as SO
    from nightmare_rl_tpu_torch.physics import loader, newton, pipeline, solver

    N = 16
    systems = {dev: dataclasses.replace(
        loader.load_system("nightmare_v3_mjx", device=dev),
        solver_iterations=30, ls_iterations=50) for dev in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(seed)
    st0 = pipeline.make_state(systems["cpu"], N)
    qpos = st0.qpos.clone()
    qpos[:, 7:] += 0.2 * torch.randn(N, 18, generator=g, dtype=torch.float64)
    qpos[:, 2] -= 0.09
    qvel = 0.3 * torch.randn(N, 24, generator=g, dtype=torch.float64)
    st0 = st0.replace(qpos=qpos, qvel=qvel)
    ctrl = torch.randn(N, 18, generator=g, dtype=torch.float64)
    margins = []
    main = (SM.smooth_forward, IN.integrate_update, AS.rows, SO.outputs,
            solver.newton_solve)

    def traced(efc, M, a0, iterations, ls_refine, x0=None):
        margins.append(_newton_floor(efc, M, a0, x0, iterations, ls_refine)[0])
        return main[4](efc, M, a0, iterations, ls_refine, x0=x0)

    def plain_solve(efc, M, a0, iterations, ls_refine, x0=None):
        return newton.solve(efc, M, a0, iterations, ls_refine, x0=x0)

    def plain_rows(sys_, lay, *args):
        return AS.plain(sys_, lay, *args, legs=solver.legs_form(
            sys_, lay, args[0].dtype, args[0].device))

    def run(dev, parts):
        (SM.smooth_forward, IN.integrate_update, AS.rows, SO.outputs,
         solver.newton_solve) = parts
        try:
            return pipeline.step(systems[dev], _to(st0, dev), ctrl.to(dev), 2)
        finally:
            (SM.smooth_forward, IN.integrate_update, AS.rows, SO.outputs,
             solver.newton_solve) = main

    cpu = run("cpu", main[:4] + (traced,))
    plain = (SM.plain, IN.plain_update, plain_rows, SO.plain)
    card = {"kernels": run("cuda", main),
            "before": run("cuda", plain + main[4:]),
            "plain": run("cuda", plain + (plain_solve,))}
    err = {}
    for k, out in card.items():
        err[k] = torch.zeros(N, dtype=torch.float64)
        for f in ("qpos", "qvel", "qacc_warmstart"):
            ref, x = getattr(cpu, f), getattr(out, f).cpu()
            err[k] = torch.maximum(err[k], (ref - x).abs().amax(dim=1)
                                   / max(1.0, float(ref.abs().max())))
    return dict(err, held=torch.stack(margins).amin(dim=0) >= NEWTON_FLOOR)


def mjx_seeds(argv) -> int:
    """``--mjx-seeds FIRST LAST``: ``_newton_mjx_steps`` at each seed, the
    envs on the line-search floor and, per card step, the envs past
    PHYS_TOL with their errors; asserts nothing."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    for seed in range(int(argv[0]), int(argv[1]) + 1):
        r = _newton_mjx_steps(seed)
        held = r.pop("held")
        parts = []
        for k, e in r.items():
            past = [f"{i}: {float(e[i]):.2e}" for i in range(len(e))
                    if e[i] > PHYS_TOL]
            parts.append(f"{k} max {float(e.max()):.3e}, past {PHYS_TOL:g} "
                         f"{{{', '.join(past)}}}")
        print(f"mjx seed {seed}: envs on the floor "
              f"{torch.nonzero(~held).flatten().tolist()}; "
              + "; ".join(parts), flush=True)
    return 0


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
    held_mjx = mjx["held"]

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
    kern_ms = _kernel_ms(lambda: K.newton_solve(*args, x0=x0))
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
          f"nightmare_v3_mjx card vs CPU: the card's smooth half, assembly, "
          f"output stage and update plain "
          f"{float(mjx['before'].max()):.3e} over all 16 envs, every "
          f"kernel {float(mjx['kernels'][held_mjx].max()):.3e} over the "
          f"{int(held_mjx.sum())} envs above the floor (on it "
          f"{float(mjx['kernels'].max()):.3e}, not held), every part plain "
          f"{float(mjx['plain'].max()):.3e}; "
          f"float32 at the model's "
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
    if not (float(mjx["before"].max()) <= PHYS_TOL and bool(held_mjx.any())
            and float(mjx["kernels"][held_mjx].max()) <= PHYS_TOL):
        raise AssertionError(f"nightmare_v3_mjx on the card disagrees with "
                             f"the CPU: {mjx}")
    if not torch.equal(nan_k, nan_p):
        raise AssertionError("the newton kernel's NaN envs differ from the "
                             "plain version's")
    if int(fin.sum()) - over < NEWTON_COST_SHARE * N:
        raise AssertionError(f"the newton kernel's cost exceeds the plain "
                             f"version's by more than {NEWTON_COST_TOL:g} in "
                             f"{over} envs")
    return dict(max_abs_err=abs_err, ms=kern_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def _smooth_fns():
    """The smooth, integrate, assemble and solve_out kernels' wrappers whose
    launch counters the captured steps add to (``utils/graph.py``), also
    while a phase puts another function over a module's name
    (``_kept_smooth``, ``_kept_solve_out``)."""
    from nightmare_rl_tpu_torch.utils import graph

    fns = {fn.__name__: fn for fn in graph._COUNTED}
    return (fns["smooth_forward"], fns["integrate_update"], fns["rows"],
            fns["outputs"])


def _zero_smooth() -> None:
    for fn in _smooth_fns():
        fn.launches = 0


STEP_KERNELS = ("smooth", "integrate", "assemble", "solve_out")


def _smooth_counts() -> dict:
    """The smooth, the integrate, the assemble and the solve_out kernel's
    launch counters, each read from its own wrapper."""
    return dict(zip(STEP_KERNELS, (fn.launches for fn in _smooth_fns())))


def _check_smooth(label: str, expected: int) -> dict:
    """Asserts that the smooth, the integrate, the assemble and the
    solve_out kernel each launched ``expected`` times since
    ``_zero_smooth``; returns the counts (``_smooth_counts``)."""
    counts = _smooth_counts()
    print(f"{label}: " + ", ".join(f"{k} launches {v}"
                                   for k, v in counts.items())
          + f" (expected {expected} each: one per physics substep)")
    if any(v != expected for v in counts.values()):
        raise AssertionError(f"{label}: the smooth, integrate, assemble and "
                             f"solve_out kernels ran {counts} times, not "
                             f"{expected}")
    return counts


@contextlib.contextmanager
def _kept_smooth():
    """Keeps clones of the tensor inputs of the last calls of the smooth,
    the integrate and the assemble kernel's wrappers (``smooth``,
    ``integrate``, ``assemble``: the System, the layout and the tensors) in
    the yielded dict; the calls go on to the wrappers.  Inside a captured
    step the clones are nodes of the graph."""
    from nightmare_rl_tpu_torch.ops import assemble as AS
    from nightmare_rl_tpu_torch.ops import integrate as IN
    from nightmare_rl_tpu_torch.ops import smooth as SM
    from nightmare_rl_tpu_torch.utils.graph import clone

    last = {}
    fns = {"smooth": (SM, "smooth_forward"),
           "integrate": (IN, "integrate_update"),
           "assemble": (AS, "rows")}
    real = {k: getattr(mod, name) for k, (mod, name) in fns.items()}

    def keeper(key):
        def kept(sys_, lay, *args):
            last[key] = (sys_, lay) + clone(args)
            return real[key](sys_, lay, *args)
        return kept

    for k, (mod, name) in fns.items():
        setattr(mod, name, keeper(k))
    try:
        yield last
    finally:
        for k, (mod, name) in fns.items():
            setattr(mod, name, real[k])


def _smooth_inputs(sys_, N: int, seed: int, dtype):
    """Seeded random states of N envs around the reference pose on the
    card (joints, base pose and velocities perturbed, controls of a few
    units), with diverged envs: NaN in one env's qvel and, from N = 3, in
    the last env's last qpos."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    qpos = np.tile(sys_.qpos0.cpu().numpy(), (N, 1))
    qpos += rng.normal(size=qpos.shape) * 0.2
    if any(t == 0 for t in sys_.jnt_type):   # free joints: unit quaternions
        for j, t in enumerate(sys_.jnt_type):
            if t == 0:
                a = sys_.jnt_qposadr[j] + 3
                qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                                   keepdims=True)
    qvel = rng.normal(size=(N, sys_.nv))
    ctrl = rng.normal(size=(N, sys_.nu)) * 5.0
    qvel[N // 2, min(3, sys_.nv - 1)] = np.nan
    if N >= 3:
        qpos[N - 1, -1] = np.nan
    return [torch.from_numpy(x).to("cuda", dtype) for x in (qpos, qvel, ctrl)]


def _field_errs(ref, got) -> list:
    """Per leaf (N, ...): (max|err| over the finite entries, the largest
    over the envs of an env's max|err| / its max|ref|, NaN at the same
    positions)."""
    import torch

    from nightmare_rl_tpu_torch.utils.graph import leaves

    out = []
    for r, g in zip(leaves(ref), leaves(got)):
        r = r.expand_as(g)
        same_nan = bool(torch.equal(torch.isnan(r), torch.isnan(g)))
        r2, g2 = r.reshape(r.shape[0], -1), g.reshape(g.shape[0], -1)
        if r2.numel() == 0:
            continue
        fin = torch.isfinite(r2) & torch.isfinite(g2)
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        d = torch.where(fin, (r2 - g2).abs(), zero).amax(dim=1)
        s = torch.where(fin, r2.abs(), zero).amax(dim=1).clamp_min(1e-30)
        out.append((float(d.max()), float((d / s).max()), same_nan))
    return out


def _plain_ops(fn) -> int:
    """The arithmetic operations of ``fn()`` (CPU tensors): one per output
    element of each pointwise op and per input element of each reduction,
    2·m·n·k per matrix product."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    products = (aten.mm.default, aten.bmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in products:
                self.n += 2 * out.numel() * args[0].shape[-1]
            elif (torch.Tag.pointwise in func.tags
                  and isinstance(out, torch.Tensor)):
                self.n += out.numel()
            elif torch.Tag.reduction in func.tags:
                self.n += args[0].numel()
            return out

    with Count() as c:
        fn()
    return c.n


def _smooth_cases(dtype):
    """(label, System, layout): both robots and a dense-branch model."""
    from nightmare_rl_tpu_torch.physics import arrow, loader

    out = []
    for name in ("nightmare_v3", "anymal_c", "spheres_condim6"):
        sys_ = loader.load_system(name, dtype=dtype, device="cuda")
        out.append((name, sys_, arrow.layout(sys_)))
    if out[2][2] is not None or any(c[2] is None for c in out[:2]):
        raise AssertionError("the smooth cases lost their layouts")
    return out


def _cpu_system(sys_):
    """The System's tensors on the CPU (the op count's copy)."""
    import dataclasses

    import torch

    return dataclasses.replace(sys_, **{
        f.name: getattr(sys_, f.name).cpu() for f in dataclasses.fields(sys_)
        if isinstance(getattr(sys_, f.name), torch.Tensor)})


def _smooth_bound(outs, ins, tables, ops: int, dtype) -> tuple:
    """The least time (ms) the card could take: bytes (inputs and tables
    read once, outputs written once) over the memory rate against the
    operations over float32's (float64's) rate; and which one bounds."""
    import torch

    nbytes = sum(x.numel() * x.element_size() for x in list(outs) + list(ins)
                 + list(tables))
    return _bytes_ops_bound(nbytes, ops, dtype)


def _bytes_ops_bound(nbytes: int, ops: int, dtype) -> tuple:
    """The larger of nbytes over the memory rate and ops over float32's
    (float64's) rate, in ms; which one bounds; nbytes."""
    import torch

    rate = H100_F32_FLOPS if dtype == torch.float32 else H100_F64_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes


def phase_smooth_kernel(kept: dict, device_name: str, smi: str) -> dict:
    """The smooth kernel (``ops/csrc/smooth.cu``) against its plain version
    (``ops/smooth.py::plain``) on the card: nightmare_v3, anymal_c and
    spheres_condim6 (no block-arrow layout) at N = 1, 37, 2047 and 2048,
    float64 and float32, seeded random states with diverged envs (a NaN
    qvel, a NaN joint angle); then on the slice's last smooth call.  Every
    output field within SMOOTH_F64_TOL (float64) or SMOOTH_F32_TOL
    (float32) of the plain version's, scaled by the field's largest |value|,
    NaN at the same positions.  Then device ms per launch (``_kernel_ms``)
    and the plain version's at the slice's inputs, and the bound."""
    import torch

    from nightmare_rl_tpu_torch.ops import smooth as SM
    from nightmare_rl_tpu_torch.utils.graph import leaves

    t0 = time.perf_counter()
    worst = {}
    for dtype, tol in ((torch.float64, SMOOTH_F64_TOL),
                       (torch.float32, SMOOTH_F32_TOL)):
        for label, sys_, lay in _smooth_cases(dtype):
            for N in SMOOTH_NS:
                args = _smooth_inputs(sys_, N, seed=N, dtype=dtype)
                errs = _field_errs(SM.plain(sys_, lay, *args),
                                   SM.smooth_forward(sys_, lay, *args))
                torch.cuda.synchronize()
                rel = max(e[1] for e in errs)
                key = (label, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), rel)
                if rel > tol or not all(e[2] for e in errs):
                    raise AssertionError(
                        f"smooth kernel disagrees with its plain version: "
                        f"{label} {dtype} N={N}: {errs}")
    print("smooth-kernel: kernel vs plain on the card, N in "
          f"{list(SMOOTH_NS)}, diverged envs in each (NaN qvel, NaN joint "
          "angle): largest field error "
          "/ max|field|: " + "; ".join(f"{k[0]} {k[1]} {v:.3e}"
                                       for k, v in worst.items())
          + f" (tol {SMOOTH_F64_TOL:g} float64, {SMOOTH_F32_TOL:g} float32); "
          "NaN positions equal")

    sys_, lay, qpos, qvel, ctrl = kept["smooth"]
    ref = SM.plain(sys_, lay, qpos, qvel, ctrl)
    got = SM.smooth_forward(sys_, lay, qpos, qvel, ctrl)
    errs = _field_errs(ref, got)
    abs_err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    if rel > SMOOTH_F32_TOL or not all(e[2] for e in errs):
        raise AssertionError(f"smooth kernel disagrees on the slice's inputs: "
                             f"{errs}")
    plain_ms = _cuda_ms(lambda: SM.plain(sys_, lay, qpos, qvel, ctrl), 3, 1)
    host = [x.cpu()[:1] for x in (qpos, qvel, ctrl)]
    host_sys = _cpu_system(sys_)
    env_ops = _plain_ops(lambda: SM.plain(host_sys, lay, *host))
    tab = SM.tables(sys_, lay, qpos.dtype, qpos.device)
    times = []
    for reps in (1, 2):  # the slice's envs, and twice as many
        args = [x.repeat(reps, 1) for x in (qpos, qvel, ctrl)]
        ms = _kernel_ms(lambda: SM.smooth_forward(sys_, lay, *args))
        outs = [x for x in leaves(SM.smooth_forward(sys_, lay, *args))
                if x.stride(0) != 0]
        times.append((args[0].shape[0], ms) + _smooth_bound(
            outs, args, (tab.topo, tab.cst), env_ops * args[0].shape[0],
            qpos.dtype))
    (_, ms, bound, by, nbytes) = times[0]
    print(f"smooth-kernel: the slice's last smooth call ({qpos.shape[0]} envs "
          f"float32): max|err| {abs_err:.3e}, /max|field| {rel:.3e} (tol "
          f"{SMOOTH_F32_TOL:g}); plain {plain_ms:.3f} ms; ms/launch (cold "
          f"L2) and bound: " + "; ".join(
              f"{n} envs {t:.4f} (first design: {p:.4f}), bound "
              f"{b * 1e3:.2f} us by {w} ({nb / 1e6:.2f} MB) = {b / t:.1%} of "
              f"it (first design: {b / p:.1%})"
              for (n, t, b, w, nb), p in zip(times,
                                             FIRST_DESIGN_MS["smooth"]))
          + f"; {env_ops * qpos.shape[0] / 1e6:.1f} M operations at "
          f"{qpos.shape[0]}; {_smi_line(t0, device_name, smi)}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by)


def _update_inputs(sys_, lay, N: int, seed: int, dtype):
    """qpos, qvel (seeded; a NaN qvel in one env), M and qfrc_smooth from
    the smooth kernel, random constraint forces and qacc, with forces of
    1e14 in another env (its qvel passes 1e10)."""
    import numpy as np
    import torch

    from nightmare_rl_tpu_torch.ops import smooth as SM

    qpos, qvel, ctrl = _smooth_inputs(sys_, N, seed, dtype)
    qpos[N - 1, -1] = sys_.qpos0[-1]
    sm = SM.smooth_forward(sys_, lay, qpos, torch.nan_to_num(qvel), ctrl)
    rng = np.random.default_rng(seed + 1)
    fc, qacc = (torch.from_numpy(rng.normal(size=(N, sys_.nv)) * s).to(
        "cuda", dtype) for s in (3.0, 10.0))
    if N >= 3:
        fc[0] *= 1e14
        qacc[0] *= 1e14
    return (qpos, qvel, sm.M, sm.qfrc_smooth, fc, qacc)


def phase_integrate_kernel(kept: dict, device_name: str, smi: str) -> dict:
    """The integrate kernel (``ops/csrc/integrate.cu``) against its plain
    version (``ops/integrate.py::plain_update``) on the card in each
    integrator branch: implicitfast (nightmare_v3), Euler with implicit
    damping (anymal_c) and plain Euler (anymal_c with eulerdamp off), at
    N = 1, 37, 2047 and 2048, float64 and float32, with a NaN env and one
    driven past 1e10 (both reset to qpos0); then on the slice's last call,
    timed, with the bound."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.ops import integrate as IN
    from nightmare_rl_tpu_torch.ops import smooth as SM
    from nightmare_rl_tpu_torch.physics import arrow, loader

    t0 = time.perf_counter()
    worst = {}
    for dtype, tol in ((torch.float64, SMOOTH_F64_TOL),
                       (torch.float32, SMOOTH_F32_TOL)):
        for branch, name, change in (
                ("implicitfast", "nightmare_v3", {}),
                ("euler_damped", "anymal_c", {}),
                ("euler", "anymal_c", {"eulerdamp": False})):
            sys_ = dataclasses.replace(
                loader.load_system(name, dtype=dtype, device="cuda"), **change)
            lay = arrow.layout(sys_)
            if SM.model_plan(sys_, lay).update != branch:
                raise AssertionError(f"{name} {change} is not {branch}")
            for N in SMOOTH_NS:
                args = _update_inputs(sys_, lay, N, N + 5, dtype)
                ref = IN.plain_update(sys_, lay, *args)
                got = IN.integrate_update(sys_, lay, *args)
                errs = _field_errs(ref, got)
                torch.cuda.synchronize()
                reset = N < 3 or (torch.equal(got[0][0], sys_.qpos0)
                                  and torch.equal(got[0][N // 2], sys_.qpos0))
                rel = max(e[1] for e in errs)
                key = (branch, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), rel)
                if rel > tol or not all(e[2] for e in errs) or not reset:
                    raise AssertionError(
                        f"integrate kernel disagrees with its plain version: "
                        f"{branch} {dtype} N={N}: {errs}, reset {reset}")
    print("integrate-kernel: kernel vs plain on the card, N in "
          f"{list(SMOOTH_NS)}, a NaN env and one past 1e10 in each (reset to "
          "qpos0): largest field error / max|field|: "
          + "; ".join(f"{k[0]} {k[1]} {v:.3e}" for k, v in worst.items())
          + f" (tol {SMOOTH_F64_TOL:g} float64, {SMOOTH_F32_TOL:g} float32)")

    sys_, lay, *args = kept["integrate"]
    ref = IN.plain_update(sys_, lay, *args)
    got = IN.integrate_update(sys_, lay, *args)
    errs = _field_errs(ref, got)
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    if rel > SMOOTH_F32_TOL or not all(e[2] for e in errs):
        raise AssertionError(f"integrate kernel disagrees on the slice's "
                             f"inputs: {errs}")
    plain_ms = _cuda_ms(lambda: IN.plain_update(sys_, lay, *args), 3, 1)
    host_sys = _cpu_system(sys_)
    host = [x.cpu()[:1] for x in args]
    env_ops = _plain_ops(lambda: IN.plain_update(host_sys, lay, *host))
    tab = SM.tables(sys_, lay, args[0].dtype, args[0].device)
    times = []
    for reps in (1, 2):  # the slice's envs, and twice as many
        xs = [x.repeat((reps,) + (1,) * (x.dim() - 1)) for x in args]
        ms = _kernel_ms(lambda: IN.integrate_update(sys_, lay, *xs))
        times.append((xs[0].shape[0], ms) + _smooth_bound(
            IN.integrate_update(sys_, lay, *xs), xs, (tab.topo, tab.cst),
            env_ops * xs[0].shape[0], args[0].dtype))
    (_, ms, bound, by, nbytes) = times[0]
    print(f"integrate-kernel: the slice's last update ({args[0].shape[0]} envs "
          f"float32): max|err| {abs_err:.3e}, /max|field| {rel:.3e}; plain "
          f"{plain_ms:.3f} ms; ms/launch (cold L2) and bound: " + "; ".join(
              f"{n} envs {t:.4f} (first design: {p:.4f}), bound "
              f"{b * 1e3:.2f} us by {w} ({nb / 1e6:.2f} MB) = {b / t:.1%} of "
              f"it (first design: {b / p:.1%})"
              for (n, t, b, w, nb), p in zip(times,
                                             FIRST_DESIGN_MS["integrate"]))
          + f"; {env_ops * args[0].shape[0] / 1e6:.1f} M operations at "
          f"{args[0].shape[0]}; {_smi_line(t0, device_name, smi)}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by)


# the assemble kernel's models as the envs configure them: (name, the
# top-K condim-3 points the env keeps)
ASSEMBLE_MODELS = (("nightmare_v3", 24), ("anymal_c", 8))


def _assemble_system(name: str, K: int, dtype):
    import dataclasses

    from nightmare_rl_tpu_torch.physics import arrow, loader

    sys_ = dataclasses.replace(
        loader.load_system(name, dtype=dtype, device="cuda"), max_contacts=K)
    return sys_, arrow.layout(sys_)


def _assemble_inputs(sys_, lay, N: int, seed: int, dtype) -> list:
    """The assemble kernel's operands from seeded states through the smooth
    kernel: the base lowered 0.1 m so that feet and bodies touch the floor,
    with the smooth cases' diverged envs (a NaN qvel in env N // 2, a NaN
    last joint angle in env N - 1: its last leg's points are NaN, which the
    selection puts first) and, in env 1, a tie env: every body at the
    same height with the identity rotation, so that points with the same
    offset and radius have equal distances and the selections break ties
    by index."""
    import torch

    from nightmare_rl_tpu_torch.ops import smooth as SM

    qpos, qvel, ctrl = _smooth_inputs(sys_, N, seed, dtype)
    qpos[:, 2] -= 0.1
    sm = SM.smooth_forward(sys_, lay, qpos, qvel, ctrl)
    xpos, xquat = sm.kin.xpos.clone(), sm.kin.xquat.clone()
    if N >= 2:
        nb = sys_.nbody
        xpos[1, :, 0] = 0.1 * torch.arange(nb, dtype=dtype, device="cuda")
        xpos[1, :, 1] = 0.05 * torch.arange(nb, dtype=dtype, device="cuda")
        xpos[1, :, 2] = 0.02
        xquat[1] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=dtype)
    qacc = sm.qacc_smooth
    return [xpos, xquat, sm.kin.subtree_com, sm.kin.cdof, qpos, qvel, qacc]


def _topk_decided(d, k: int):
    """Per env: the k-th and (k+1)-th of topk_smallest's order of the rows
    of d differ by more than ASSEMBLE_GAP relative (True where d has k
    entries or fewer)."""
    import torch

    if d.shape[1] <= k:
        return torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    v = torch.sort(-d, dim=1, descending=True, stable=True).values
    a, b = -v[:, k - 1], -v[:, k]
    scale = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return (a - b).abs() / scale > ASSEMBLE_GAP


def _assemble_held(sys_, ref, got, exact: bool) -> dict:
    """The kernel's output ``got`` against the plain version's ``ref``:
    per env, every integer and flag output equal (the selections, the
    pairs' points, leg slots, activity); where ``exact`` in every env, else
    in every env whose condim-3 and pair selections are decided
    (``_topk_decided``) — the others are counted, their values not held.
    On the envs held, each float output's largest |err| over the env's
    largest |value| (NaN at the same positions).  Returns the worst error,
    the largest |err|, and the counts of envs that differ (``bad``: held
    envs, ``near``: undecided ones)."""
    import torch

    from nightmare_rl_tpu_torch.physics import solver
    from nightmare_rl_tpu_torch.utils.graph import leaves

    N = ref.con.dist.shape[0]
    dev = ref.con.dist.device
    rl, gl = leaves(ref), leaves(got)
    if len(rl) != len(gl):
        raise AssertionError(f"assemble outputs differ in number: {len(rl)} "
                             f"and {len(gl)}")
    differs = torch.zeros(N, dtype=torch.bool, device=dev)
    for r, g in zip(rl, gl):
        if not r.is_floating_point():
            differs |= (r.expand_as(g) != g).reshape(N, -1).any(dim=1)
    decided = torch.ones(N, dtype=torch.bool, device=dev)
    c3, _ = solver._condim_groups(sys_)
    if 0 < sys_.max_contacts < len(c3):
        idx = torch.tensor(c3, device=dev)
        decided &= _topk_decided(ref.con.dist[:, idx], sys_.max_contacts)
    if ref.pair_sel is not None:
        c, r = ref.con.centers, sys_.cpoint_radius
        pa, pb = sys_.cpair_a, sys_.cpair_b
        pd = (torch.linalg.vector_norm(c[:, pb] - c[:, pa], dim=-1)
              - (r[pa] + r[pb]))
        decided &= _topk_decided(pd, ref.pair_sel.shape[1])
    held = ~differs if not exact else torch.ones_like(differs)
    bad = int((differs & (decided | exact)).sum())
    near = int((differs & ~decided).sum()) if not exact else 0
    worst, abs_err = 0.0, 0.0
    for r, g in zip(rl, gl):
        if not r.is_floating_point() or r.numel() == 0:
            continue
        r2 = r.expand_as(g).reshape(N, -1)[held]
        g2 = g.reshape(N, -1)[held]
        if not torch.equal(torch.isnan(r2), torch.isnan(g2)):
            bad += 1
        fin = torch.isfinite(r2) & torch.isfinite(g2)
        zero = torch.zeros((), dtype=r2.dtype, device=dev)
        d = torch.where(fin, (r2 - g2).abs(), zero).amax(dim=1)
        s = torch.where(fin, r2.abs(), zero).amax(dim=1).clamp_min(1e-30)
        if d.numel():
            abs_err = max(abs_err, float(d.max()))
            worst = max(worst, float((d / s).max()))
    return dict(rel=worst, abs=abs_err, bad=bad, near=near)


def _assemble_bound(sys_, lay, out, ins, tab, ops: int, dtype) -> tuple:
    """The bound of an assemble call, counting the bytes the function needs:
    every output written once (the static index lists, which are views of
    one row, not); xpos and xquat at the bodies that carry points,
    subtree_com at those bodies' roots and qpos at the limited joints'
    addresses (``model_plan``'s tables); cdof, qvel and qacc_smooth at the
    dofs that each env's rows reach (the columns of its J that are not all
    zero); the int32 table and the constants once, and the pair constants
    of the pairs that this call selects."""
    import torch

    from nightmare_rl_tpu_torch.ops import assemble as AS
    from nightmare_rl_tpu_torch.utils.graph import leaves

    outs = [x for x in leaves(out) if x.numel() and x.stride(0) != 0]
    nbytes = sum(x.numel() * x.element_size() for x in
                 {(x.data_ptr(), x.numel()): x for x in outs}.values())
    plan = AS.model_plan(sys_, lay)
    f, topo = plan.fields, plan.topo

    def distinct(key: str) -> int:  # of a table with an entry per point
        return len(set(topo[f[key]:f[key] + f["ncp"]]))

    qadr = {int(sys_.jnt_qposadr[j]) for _, j in plan.dofrows if j is not None}
    item, N = ins[0].element_size(), ins[0].shape[0]
    dofs = int((out.rows.efc.J != 0).any(dim=1).sum())
    npair = (0 if out.pair_sel is None
             else torch.unique(out.pair_sel).numel())
    nbytes += item * (N * (7 * distinct("t_cp_body") + 3 * distinct("t_cp_root")
                           + len(qadr)) + 8 * dofs
                      + tab.cst.numel() + npair * tab.pcst.shape[1])
    nbytes += tab.topo.numel() * tab.topo.element_size()
    return _bytes_ops_bound(nbytes, ops, dtype)


def phase_assemble_kernel(kept: dict, device_name: str, smi: str) -> dict:
    """The assemble kernel (``ops/csrc/assemble.cu``) against its plain
    version (``ops/assemble.py::plain``) on the card: nightmare_v3 (top 24
    of 40 points, top 4 of 375 pairs, pyramidal rows, the leg slots) and
    anymal_c (top 8 of 69 condim-3 points, 4 condim-6 points, top 4 of
    1,566 pairs, 36 dof rows, elliptic rows and cones) at 2048 and 4096
    envs, float64 (indices equal in every env, values within
    ASSEMBLE_F64_TOL) and float32 (indices equal in every env whose
    selections are decided by more than ASSEMBLE_GAP, the others counted;
    values within ASSEMBLE_F32_TOL), each with a NaN env, a NaN leg and a
    tie env (``_assemble_inputs``); then on the slice's last call (float32,
    every env's selections held); then each robot's kernel timed alone
    (``_kernel_ms``) at 2048 and 4096 envs beside its plain version's
    CUDA-event time and its bound."""
    import torch

    from nightmare_rl_tpu_torch.ops import assemble as AS
    from nightmare_rl_tpu_torch.physics import solver

    t0 = time.perf_counter()
    worst, near = {}, 0
    with _pgs_mode("legs"):
        for dtype, tol in ((torch.float64, ASSEMBLE_F64_TOL),
                           (torch.float32, ASSEMBLE_F32_TOL)):
            exact = dtype == torch.float64
            for name, K in ASSEMBLE_MODELS:
                sys_, lay = _assemble_system(name, K, dtype)
                legs = solver.legs_form(sys_, lay, dtype, "cuda")
                for N in ASSEMBLE_NS:
                    args = _assemble_inputs(sys_, lay, N, N + len(name), dtype)
                    got = AS.rows(sys_, lay, *args)
                    if (got.rows.legmeta is not None) != legs:
                        raise AssertionError(f"{name}: leg slots made {legs}")
                    res = _assemble_held(sys_, AS.plain(sys_, lay, *args,
                                                        legs=legs), got, exact)
                    key = (name, str(dtype)[6:])
                    worst[key] = max(worst.get(key, 0.0), res["rel"])
                    near += res["near"]
                    print(f"assemble-kernel: {name} {str(dtype)[6:]} N={N}: "
                          f"largest error /max|field| {res['rel']:.3e}, "
                          f"envs differing where decided {res['bad']}, "
                          f"undecided envs differing {res['near']}")
                    if res["bad"] or res["rel"] > tol:
                        raise AssertionError(
                            f"assemble kernel disagrees with its plain "
                            f"version: {name} {dtype} N={N}: {res}")
    print("assemble-kernel: kernel vs plain on the card, N in "
          f"{list(ASSEMBLE_NS)}, a NaN env, a NaN leg and a tie env in each: "
          "largest field error /max|field|: " + "; ".join(
              f"{k[0]} {k[1]} {v:.3e}" for k, v in worst.items())
          + f" (tol {ASSEMBLE_F64_TOL:g} float64, {ASSEMBLE_F32_TOL:g} "
          f"float32); undecided float32 envs whose selections differ: {near}")

    sys_, lay, *args = kept["assemble"]
    legs = solver.legs_form(sys_, lay, args[0].dtype, args[0].device)
    ref = AS.plain(sys_, lay, *args, legs=legs)
    res = _assemble_held(sys_, ref, AS.rows(sys_, lay, *args), exact=True)
    print(f"assemble-kernel: the slice's last call ({args[0].shape[0]} envs "
          f"float32): largest error /max|field| {res['rel']:.3e}, max|err| "
          f"{res['abs']:.3e}, envs whose selections differ {res['bad']}")
    if res["bad"] or res["rel"] > ASSEMBLE_F32_TOL:
        raise AssertionError(f"assemble kernel disagrees on the slice's "
                             f"inputs: {res}")
    slice_plain_ms = _cuda_ms(lambda: AS.plain(sys_, lay, *args, legs=legs),
                              3, 1)
    times = {}
    with _pgs_mode("legs"):
        for name, K in ASSEMBLE_MODELS:
            sys_, lay = _assemble_system(name, K, torch.float32)
            legs = solver.legs_form(sys_, lay, torch.float32, "cuda")
            host_sys = _cpu_system(sys_)
            one = [x[:1].cpu() for x in _assemble_inputs(sys_, lay, 1, 3,
                                                         torch.float32)]
            env_ops = _plain_ops(lambda: AS.plain(host_sys, lay, *one,
                                                  legs=legs))
            tab = AS.tables(sys_, lay, torch.float32, torch.device("cuda"))
            for N in ASSEMBLE_NS:
                xs = _assemble_inputs(sys_, lay, N, 5, torch.float32)
                ms = _kernel_ms(lambda: AS.rows(sys_, lay, *xs))
                plain_ms = _cuda_ms(lambda: AS.plain(sys_, lay, *xs,
                                                     legs=legs), 3, 1)
                times[(name, N)] = (ms, plain_ms) + _assemble_bound(
                    sys_, lay, AS.rows(sys_, lay, *xs), xs, tab,
                    env_ops * N, torch.float32)
    print("assemble-kernel: ms/launch alone (cold L2), float32, and its "
          "bound: " + "; ".join(
              f"{n} {N} envs {t:.4f} (plain {p:.3f}), bound {b * 1e3:.2f} us "
              f"by {w} ({nb / 1e6:.2f} MB) = {b / t:.1%} of it"
              for (n, N), (t, p, b, w, nb) in times.items())
          + f"; the slice's plain call {slice_plain_ms:.3f} ms; "
          f"{_smi_line(t0, device_name, smi)}")
    ms, plain_ms, bound, by, _ = times[("nightmare_v3", 2048)]
    return dict(max_abs_err=res["abs"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


TASK_WRAPPERS = ("pre", "post")
TASK_LAUNCHES = {}   # per phase: the task kernels' launches (pre + post)


def _task_fns():
    """The task kernels' wrappers (``ops/task.py``: ``pre``, ``post``), by
    their counters in ``utils/graph.py``."""
    from nightmare_rl_tpu_torch.utils import graph

    fns = {fn.__name__: fn for fn in graph._COUNTED}
    return tuple(fns[k] for k in TASK_WRAPPERS)


def _zero_task() -> None:
    for fn in _task_fns():
        fn.launches = 0


def _check_task(label: str, expected=None) -> dict:
    """Asserts that ``pre`` and ``post`` each launched once per env step
    since ``_zero_task`` (``expected`` env steps, where the phase knows
    them; at least one otherwise); records their sum in TASK_LAUNCHES."""
    counts = {fn.__name__: fn.launches for fn in _task_fns()}
    print(f"{label}: task kernel launches pre {counts['pre']}, post "
          f"{counts['post']} (expected "
          f"{'at least 1' if expected is None else expected} each: one per "
          f"env step)")
    if (counts["pre"] != counts["post"] or counts["pre"] < 1
            or (expected is not None and counts["pre"] != expected)):
        raise AssertionError(f"{label}: the task kernels ran {counts} times, "
                             f"not {expected} each")
    TASK_LAUNCHES[label] = counts["pre"] + counts["post"]
    return counts


def eager_kernels_main(argv) -> int:
    """``--eager-kernels ROBOT``: prints the kernels that one eager env step
    of ROBOT at 2048 envs, float32, launches on the card (torch.profiler, as
    tools/profile_step.py counts them; the PGS form from NIGHTMARE_PGS) as
    the last line, JSON.  The graph phases run it as a process of its own,
    so that no profiler session runs in the smoke's process."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    env = _task_env(argv[0], 2048)
    state, _ = env.reset(0)
    acts = torch.zeros(env.num_envs, env.num_actions, device="cuda")
    env.step(state, acts)
    torch.cuda.synchronize()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            env.step(state, acts)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / steps
    print(json.dumps({"kernels": n}))
    return 0


def _eager_kernels(robot: str) -> float:
    """``eager_kernels_main`` in a process of its own, under this
    process's NIGHTMARE_PGS."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--eager-kernels", robot], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise RuntimeError(f"--eager-kernels {robot} failed:\n"
                           f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["kernels"]


def _task_env(robot: str, N: int, device: str = "cuda"):
    import torch

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env

    if robot == "anymal_c":
        return AnymalCEnv(AnymalCCfg(num_envs=N), device=device)
    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=N)),
                          device=device, dtype=torch.float32)


def _ulps(x: float, k):
    """float32 values k ulps from float32(x) (k an int array)."""
    import numpy as np

    x32 = np.float32(x)
    out = np.empty(len(k), dtype=np.float32)
    for i, j in enumerate(k):
        v = x32
        for _ in range(abs(int(j))):
            v = np.nextafter(v, np.float32(np.inf if j > 0 else -np.inf))
        out[i] = v
    return out


def _task_inputs(env, seed: int) -> tuple:
    """The task kernels' operands at the env's N envs on the card, float32:
    the state after 3 env steps of random actions from a reset, this step's
    raw actions, pre's actions, the physics state that pipeline.step
    returns for them, and the command draws; with edge envs: a time-out at
    max_episode_length and one step short of it, the resample step (every
    other env but the sweeps' a random episode length), a foot force at
    termination_contact_force and one ulp above, NaN in qvel and in a foot
    force, and TASK_SWEEP envs ulp by ulp across each cut: the 60° tilt
    (the base quaternion), the commands' norm cut (0.02 for nightmare_v3
    on either sign of vx, 0.05 for anymal_c) and anymal_c's 0.1 cut of the
    air-time and stand-still terms."""
    import math

    import numpy as np
    import torch

    from nightmare_rl_tpu_torch.ops import task
    from nightmare_rl_tpu_torch.physics import pipeline

    N, dev = env.num_envs, env.device
    g = torch.Generator(device=dev).manual_seed(seed)
    state, _ = env.reset(seed)
    for _ in range(3):
        state = env.step(state, 0.5 * torch.randn(
            N, env.num_actions, generator=g, device=dev)).state
    raw = 0.5 * torch.randn(N, env.num_actions, generator=g, device=dev)
    plan = env.task_plan
    actions, ctrl = task.PLAIN_PRE[plan.robot](env, state, raw)
    dec = (env.cfg.control.decimation if plan.nightmare
           else env.cfg.decimation)
    phys = pipeline.step(env.sys, state.phys, ctrl, dec)
    draws = [d.clone() for d in env._command_draws(N)]
    rng = np.random.default_rng(seed)
    S = TASK_SWEEP
    every, max_len = plan.ints["resample_every"], env.max_episode_length
    length = rng.integers(0, min(every, max_len) - 1, N)
    length[::2] = every - 1           # resample
    length[0], length[1] = max_len, max_len - 1
    qpos, qvel = phys.qpos.clone(), phys.qvel.clone()
    sd = phys.sensordata.clone()
    feet = slice(6, 12) if plan.nightmare else slice(0, plan.ints["nfeet"])
    limit = plan.reals["term_force"]
    sd[2, feet.start] = float(np.float32(limit))
    sd[3, feet.start] = float(_ulps(limit, [1])[0])
    sd[4, feet.start] = float("nan")
    qvel[5, 7] = float("nan")
    # the tilt sweep: quaternions about a horizontal axis, angles spaced
    # half a float32 ulp of the cut apart
    a = 16
    th = math.pi / 3 + (np.arange(S) - S // 2) * 6e-8
    phi = rng.uniform(0, 2 * math.pi, S)
    quat = np.stack([np.cos(th / 2), np.sin(th / 2) * np.cos(phi),
                     np.sin(th / 2) * np.sin(phi), np.zeros(S)], axis=1)
    qpos[a:a + S, 3:7] = torch.from_numpy(quat).to(qpos)
    # the command cuts' sweeps (resampled envs)
    b = a + S
    k = np.arange(S) - S // 2
    if plan.nightmare:
        half = np.arange(S // 2) - S // 4   # vx = -0.5 + u about ±0.02
        u = np.concatenate([_ulps(0.52, half), _ulps(0.48, half)])
        draws[0][b:b + S] = torch.from_numpy(u).to(dev)
    else:
        c = env.cfg
        for j, cut in enumerate((0.05, 0.1)):
            lo = b + j * S
            ux = _ulps((0.6 * cut + c.max_lin_vel_x) / (2 * c.max_lin_vel_x), k)
            uy = _ulps((0.8 * cut + c.max_lin_vel_y) / (2 * c.max_lin_vel_y), k)
            draws[0][lo:lo + S] = torch.from_numpy(ux).to(dev)
            draws[1][lo:lo + S] = torch.from_numpy(uy).to(dev)
    length[a:b + 2 * S] = every - 1
    state = state.replace(episode_length=torch.from_numpy(length).to(
        dev, torch.int32))
    phys = phys.replace(qpos=qpos, qvel=qvel, sensordata=sd)
    noise = None
    if plan.ints["add_noise"]:
        noise = torch.rand(N, env.num_obs, generator=g, device=dev)
    return state, raw, actions, phys, draws, noise


def _task_held(ref, got) -> dict:
    """The task kernels' outputs against the plain version's: envs whose
    flags (reset, time-out, contact buffers), episode counts or commands
    differ; the largest error of a value field over max(1, max|field|) and
    the largest absolute error (NaN positions must be equal)."""
    import torch

    n = ref.reset.shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=ref.reset.device)
    rel = err = 0.0
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None:
            continue
        if not a.is_floating_point() or name == "commands":
            bad |= (a != b).reshape(n, -1).any(dim=1)
            continue
        nan = torch.isnan(a) != torch.isnan(b)
        bad |= nan.reshape(n, -1).any(dim=1)
        ok = ~torch.isnan(a) & ~torch.isnan(b)
        if not ok.any():
            continue
        d = float((a[ok] - b[ok]).abs().max())
        err = max(err, d)
        rel = max(rel, d / max(1.0, float(a[ok].abs().max())))
    return dict(bad=int(bad.sum()), rel=rel, abs=err)


def _task_bytes(env, state, phys, draws, noise, out) -> tuple:
    """Bytes that pre and post must move (each operand read once where the
    config reads it, each output written once)."""
    plan = env.task_plan
    N, it = state.commands.shape[0], state.commands.element_size()
    terms = env.active_rewards
    na = env.num_actions
    pre = N * na * it * (3 if plan.nightmare else 2)
    reads = [phys.qpos, phys.qvel, phys.sensordata, state.episode_length,
             state.commands, state.actions, state.feet_air_time,
             state.last_contacts, state.episode_sums, *draws]
    reads += [state.dof_vel] if "dof_acc" in terms else []
    reads += [state.last_contacts_filt] if plan.nightmare else []
    reads += [noise] if noise is not None else []
    post = sum(x.numel() * x.element_size() for x in reads)
    post += N * 6 * it + N * na * it          # cvel at the base; actions
    post += N * it if "base_height" in terms else 0
    post += N * na * it if "torques" in terms and not plan.nightmare else 0
    post += sum(x.numel() * x.element_size() for x in out if x is not None)
    post += plan.cst.numel() * it
    return pre, post


def phase_task_kernel(device_name: str, smi: str) -> dict:
    """The task kernels (``ops/csrc/task.cu``: ``pre``, the actions and the
    control law, and ``post``, everything of the env step after the
    physics) against their plain versions (``ops/task.py``'s plain_*) on
    the card, float32, nightmare_v3 and anymal_c at 2048 and 4096 envs, on
    ``_task_inputs``' states (resets, resamples, the edge envs and the
    sweeps across every cut): 0 envs whose flags, episode counts or
    commands differ, every value within TASK_F32_TOL of its field's scale,
    NaN at the plain version's positions, pre's outputs bit for bit; then
    each robot's pair of launches timed alone (``_kernel_ms``) at both
    sizes beside the plain versions and the byte bound."""
    import torch

    from nightmare_rl_tpu_torch.ops import task

    t0 = time.perf_counter()
    res, times = {}, {}
    for robot in ("nightmare_v3", "anymal_c"):
        for N in TASK_NS:
            env = _task_env(robot, N)
            state, raw, actions, phys, draws, noise = _task_inputs(env, N)
            plan = env.task_plan
            ref_pre = task.PLAIN_PRE[plan.robot](env, state, raw)
            got_pre = task.pre(env, state, raw)
            pre_err = max(float((a - b).abs().max())
                          for a, b in zip(ref_pre, got_pre))
            ref = task.PLAIN_POST[plan.robot](env, state, actions, phys, draws,
                                              noise)
            got = task.post(env, state, actions, phys, draws, noise)
            held = _task_held(ref, got)
            sweep = int(ref.reset[16:16 + TASK_SWEEP].sum())
            print(f"task-kernel: {robot} N={N} float32: envs whose flags, "
                  f"episode counts or commands differ {held['bad']}; "
                  f"largest value error /max(1, |field|) {held['rel']:.3e}, "
                  f"max|err| {held['abs']:.3e}; pre max|err| {pre_err:.3e}; "
                  f"resets {int(ref.reset.sum())} (the tilt sweep's "
                  f"{sweep} of {TASK_SWEEP}), time-outs "
                  f"{int(ref.time_out.sum())}")
            if held["bad"] or held["rel"] > TASK_F32_TOL or pre_err != 0.0:
                raise AssertionError(f"task kernels disagree with their plain "
                                     f"versions: {robot} N={N}: {held}, pre "
                                     f"{pre_err}")
            if not 0 < sweep < TASK_SWEEP:
                raise AssertionError(f"the tilt sweep does not cross the cut: "
                                     f"{sweep} of {TASK_SWEEP} reset")
            res[(robot, N)] = dict(held, pre=pre_err)
            pre_ms = _kernel_ms(lambda: task.pre(env, state, raw))
            post_ms = _kernel_ms(lambda: task.post(env, state, actions, phys,
                                                   draws, noise))
            plain_pre = _cuda_ms(lambda: task.PLAIN_PRE[plan.robot](
                env, state, raw), 10, 2)
            plain_post = _cuda_ms(lambda: task.PLAIN_POST[plan.robot](
                env, state, actions, phys, draws, noise), 10, 2)
            nb_pre, nb_post = _task_bytes(env, state, phys, draws, noise, got)
            bound, by, nb = _bytes_ops_bound(nb_pre + nb_post, 0,
                                             torch.float32)
            times[(robot, N)] = (pre_ms, post_ms, plain_pre, plain_post, bound,
                                 by, nb)
    print("task-kernel: ms/launch alone (cold L2), float32, pre + post, "
          "beside the plain versions (CUDA events, queued) and the byte "
          "bound: " + "; ".join(
              f"{r} {N} envs {a:.4f} + {b:.4f} = {a + b:.4f} (plain "
              f"{pa:.3f} + {pb:.3f}), bound {bd * 1e3:.2f} us by {w} "
              f"({nb / 1e6:.2f} MB) = {bd / (a + b):.1%} of it"
              for (r, N), (a, b, pa, pb, bd, w, nb) in times.items())
          + f"; {_smi_line(t0, device_name, smi)}")
    a, b, pa, pb, bound, by, _ = times[("nightmare_v3", 2048)]
    main = res[("nightmare_v3", 2048)]
    return dict(max_abs_err=max(main["abs"], main["pre"]), ms=a + b,
                plain_ms=pa + pb, bound_ms=bound, bound_by=by)


ROLLOUT_WRAPPERS = ("act", "store")
ROLLOUT_LAUNCHES = {}   # per phase: the rollout kernels' launches (act, store)


def _rollout_fns():
    """The rollout kernels' wrappers (``ops/rollout.py``: ``act``,
    ``store``), by their counters in ``utils/graph.py``."""
    from nightmare_rl_tpu_torch.utils import graph

    fns = {fn.__name__: fn for fn in graph._COUNTED}
    return tuple(fns[k] for k in ROLLOUT_WRAPPERS)


def _zero_rollout() -> None:
    for fn in _rollout_fns():
        fn.launches = 0


def _check_rollout(label: str, expected: int) -> None:
    """Asserts that ``act`` and ``store`` each launched ``expected`` times
    since ``_zero_rollout`` (one per rollout step, the capture's warm-up
    step included); records them in ROLLOUT_LAUNCHES."""
    counts = {fn.__name__: fn.launches for fn in _rollout_fns()}
    print(f"{label}: rollout kernel launches act {counts['act']}, store "
          f"{counts['store']} (expected {expected} each: one per rollout "
          f"step, the graph's warm-up step included)")
    if counts["act"] != expected or counts["store"] != expected:
        raise AssertionError(f"{label}: the rollout kernels ran {counts} "
                             f"times, not {expected} each")
    ROLLOUT_LAUNCHES[label] = (counts["act"], counts["store"])


def _rollout_ppo(robot: str, N: int, weights: str,
                 policy: str = "ActorCritic", rnn: int = 512,
                 device: str = "cuda"):
    """A PPO on ``robot``'s env at N envs on ``device``, float32, recording
    on, its weights ``weights`` ("fresh": ``PPO.init(0)``'s; "model_3176":
    the file's), its rollout buffers of ROLLOUT_ROWS rows; after 3 env
    steps of its own policy, with the first 8 envs at their time-out.
    Returns the PPO and the (state, obs, hidden) reached."""
    import dataclasses

    import torch

    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    cfg = PPOCfg()
    cfg = cfg.replace(runner=RunnerCfg(num_steps_per_env=ROLLOUT_ROWS,
                                       policy_class_name=policy),
                      policy=dataclasses.replace(cfg.policy,
                                                 rnn_hidden_size=rnn))
    env = _task_env(robot, N, device)
    ppo = PPO(env, cfg, record_states=True)
    ppo.init(0)
    if weights == "model_3176":
        ppo.net.load_state_dict(torch.load(
            MODEL_3176, map_location="cpu", weights_only=True)[
                "model_state_dict"])
    ppo._rollout_buffers(ROLLOUT_ROWS)
    state, obs, hidden = ppo.env_state, ppo.obs, ppo.hidden
    for _ in range(3):
        action, *_, hidden = ppo.act(obs, hidden)
        out = env.step(state, action)
        state, obs = out.state, out.obs
    state.episode_length[:8] = env.max_episode_length
    return ppo, state, obs, hidden


def _rows_held(ref, got, exact: bool) -> dict:
    """max|err| and max|err| / max|ref| of two tensors (NaN where NaN); with
    ``exact``, the elements that differ."""
    import torch

    nan = torch.isnan(ref) if ref.is_floating_point() else None
    if nan is not None and not torch.equal(nan, torch.isnan(got)):
        return dict(abs=math.inf, rel=math.inf, differ=int(
            (nan != torch.isnan(got)).sum()))
    ok = ~nan if nan is not None else torch.ones_like(ref, dtype=torch.bool)
    a, b = ref[ok], got[ok]
    differ = int((a != b).sum())
    if not a.is_floating_point() or a.numel() == 0:
        return dict(abs=float(differ > 0), rel=float(differ > 0),
                    differ=differ)
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    return dict(abs=err, rel=err / scale if scale > 0 else err,
                differ=differ if exact else 0)


def _rollout_bound(pl, N: int, nobs: int, nterms: int, width: int,
                   shared: bool, it: int) -> tuple:
    """(act's bytes, act's operations, store's bytes, store's operations):
    each input read once, each output written once.  act: the observations
    (and the recurrent heads' two inputs), eps, the layers and std read;
    the six rows and the caller's action and value written; 2 operations a
    multiply-add, 1 a bias and 1 an activation, 10 an action for the
    sample and its log-density term and the sum.  store: the step's
    reward, value, flags and finished sums, the running sums and env 0's
    sources read; the rows, the record row and the sums written; 3
    operations an env for the bootstrap, 1 a finished term."""
    A = pl.net.std.shape[0]
    in_a, in_c = pl.actor[0].in_features, pl.critic[0].in_features
    params = sum(p.numel() for m in pl.layers for p in (m.weight, m.bias)) + A
    reads = N * nobs + (0 if shared else N * (in_a + in_c)) + N * A + params
    writes = N * nobs + 4 * N * A + 3 * N
    act_bytes = it * (reads + writes) + 8
    macs = sum(m.in_features * m.out_features for m in pl.layers)
    units = sum(m.out_features for m in pl.layers)
    hidden = sum(m.out_features for m in pl.actor[:-1] + pl.critic[:-1])
    act_ops = N * (2 * macs + units + hidden + 10 * A)
    store_bytes = (it * (2 * N + N * nterms + 1 + nterms + width - 1) + 2 * N
                   + 1 + 8 + it * (N + width + 1 + nterms) + N + 8)
    store_ops = N * (3 + nterms)
    return act_bytes, act_ops, store_bytes, store_ops


def _rollout_case(ppo, state, obs, hidden, timed: bool) -> dict:
    """act and store against their plain versions on one PPO's operands
    (env 7's observation NaN), into row 2 of copies of its trajectory and
    record buffers: every row of act's fields, store's reward and done
    rows, the record row, t + 1, the episode count and term sums; the
    plain act's action stepped by the env feeds store.  With ``timed``,
    each kernel alone (``_kernel_ms``), the plain versions, the MLPs'
    cuBLAS products alone (the library's part) and the bounds."""
    import torch

    from nightmare_rl_tpu_torch.ops import rollout as R
    from nightmare_rl_tpu_torch.utils.device import full_float32
    from nightmare_rl_tpu_torch.utils.graph import clone

    pl, N = ppo.act_plan, obs.shape[0]
    obs = obs.clone()
    obs[7] = float("nan")
    x_a, x_c, _ = ppo._policy_inputs(obs, hidden)
    eps = ppo._noise(N)
    t = torch.tensor([2], device=obs.device)
    ref_traj, got_traj = clone(ppo._traj), clone(ppo._traj)
    ref = R.plain_act(pl, obs, x_a, x_c, eps, ref_traj, t)
    got = R.act(pl, obs, x_a, x_c, eps, got_traj, t)
    held = {}
    for name in R.ACT_ROWS:
        held[name] = _rows_held(getattr(ref_traj, name)[2],
                                getattr(got_traj, name)[2],
                                name in ("obs", "sigma"))
    held["action"] = _rows_held(ref.action, got.action, False)
    held["value"] = _rows_held(ref.value, got.value, False)
    out = ppo.env.step(state, ref.action)
    fin = out.finished_episode_sums
    nterms = fin.shape[1]
    g = torch.Generator(device=obs.device).manual_seed(5)
    n_done = torch.full((), 3.0, device=obs.device)
    sums = torch.rand(nterms, generator=g, device=obs.device)
    record = (out.record_qpos, out.record_qvel, ref.action, out.done,
              out.state.commands)
    rec_ref, rec_got = ppo._rec.clone(), ppo._rec.clone()
    gamma = ppo.cfg.algorithm.gamma
    a = R.plain_store(ref_traj, t, out.reward, out.time_out, out.done,
                      ref.value, fin, n_done, sums, gamma, rec_ref, record)
    b = R.store(got_traj, t, out.reward, out.time_out, out.done, ref.value,
                fin, n_done, sums, gamma, rec_got, record)
    held["reward"] = _rows_held(ref_traj.reward[2], got_traj.reward[2], False)
    held["done"] = _rows_held(ref_traj.done[2], got_traj.done[2], True)
    held["record"] = _rows_held(rec_ref[2], rec_got[2], True)
    held["t"] = _rows_held(a[0], b[0], True)
    held["n_done"] = _rows_held(a[1], b[1], True)
    held["term_sums"] = _rows_held(a[2], b[2], False)
    res = dict(held=held, finished=int(float(a[1]) - 3.0),
               time_outs=int(out.time_out.sum()))
    if not timed:
        return res
    step_in = (out.reward, out.time_out, out.done, ref.value, fin, n_done,
               sums, gamma)
    res["act_ms"] = _kernel_ms(lambda: R.act(pl, obs, x_a, x_c, eps,
                                             got_traj, t))
    res["store_ms"] = _kernel_ms(lambda: R.store(got_traj, t, *step_in,
                                                 rec_got, record))
    res["act_plain_ms"] = _cuda_ms(lambda: R.plain_act(
        pl, obs, x_a, x_c, eps, ref_traj, t), 10, 2)
    res["store_plain_ms"] = _cuda_ms(lambda: R.plain_store(
        ref_traj, t, *step_in, rec_ref, record), 10, 2)

    def mlps():
        with full_float32():
            pl.net.actor(x_a)
            pl.net.critic(x_c)

    res["act_library_ms"] = _cuda_ms(mlps, 10, 2)
    nb_a, ops_a, nb_s, ops_s = _rollout_bound(
        pl, N, obs.shape[1], nterms, rec_got.shape[1], x_a is x_c,
        obs.element_size())
    res["act_bound"] = _bytes_ops_bound(nb_a, ops_a, torch.float32)
    res["store_bound"] = _bytes_ops_bound(nb_s, ops_s, torch.float32)
    res["act_smem"] = R.act_smem_bytes(pl, obs, x_a, x_c, eps, got_traj, t)
    return res


def _rollout_replays(ppo, state, obs, hidden) -> dict:
    """The rollout step captured (``PPO._rollout_stepper``) at the PPO's
    shapes: ROLLOUT_ROWS replays against as many eager calls of the step
    from one state and generator states (the trajectory, the record, the
    carry bit for bit: the card's counterpart of
    tests/test_torch_graph.py::test_rollout_equals_eager_loop); then a
    replay after the actor's and critic's weights and std were changed in
    place: its mu and sigma rows must move, and hold against the plain
    act on the new weights (ROLLOUT_F32_TOL; sigma exact)."""
    import torch

    from nightmare_rl_tpu_torch.ops import rollout as R
    from nightmare_rl_tpu_torch.utils.graph import clone

    gens = [ppo.generator, ppo.env.generator]
    g0 = [g.get_state() for g in gens]
    start = clone((state, obs, hidden))
    step = ppo._rollout_stepper(ROLLOUT_ROWS)
    carry = (*clone(start), *ppo._zeros)
    for _ in range(ROLLOUT_ROWS):
        carry = step(carry)
    replayed = clone((ppo._traj, ppo._rec, carry))
    for g, s in zip(gens, g0):
        g.set_state(s)
    carry = (*clone(start), *ppo._zeros)
    for _ in range(ROLLOUT_ROWS):
        carry = ppo._rollout_step(carry)
    same = _leaves_equal(replayed, (ppo._traj, ppo._rec, carry))

    pl = ppo.act_plan
    for g, s in zip(gens, g0):
        g.set_state(s)
    step((*clone(start), *ppo._zeros))
    mu0 = ppo._traj.mu[0].clone()
    params = [p for m in pl.layers for p in (m.weight, m.bias)] + [ppo.net.std]
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.mul_(1.25)
    for g, s in zip(gens, g0):
        g.set_state(s)
    step((*clone(start), *ppo._zeros))
    mu1, sigma1 = ppo._traj.mu[0].clone(), ppo._traj.sigma[0].clone()
    for g, s in zip(gens, g0):
        g.set_state(s)
    x_a, x_c, _ = ppo._policy_inputs(start[1], start[2])
    ref = R.plain_act(pl, start[1], x_a, x_c, ppo._noise(obs.shape[0]))
    res = dict(same=same, moved=float((mu1 - mu0).abs().max()),
               mu=_rows_held(ref.mu, mu1, False),
               sigma=bool(torch.equal(sigma1, ref.std)))
    with torch.no_grad():
        for p, x in zip(params, saved):
            p.copy_(x)
    for g, s in zip(gens, g0):
        g.set_state(s)
    return res


def phase_rollout_kernel(device_name: str, smi: str) -> dict:
    """The rollout kernels (``ops/csrc/rollout.cu``: ``act``, the actor's
    and critic's MLPs, the sample and its log-probability into row t of
    the trajectory; ``store``, the timeout bootstrap, done, env 0's record
    row and the finished sums) against their plain versions
    (``ops/rollout.py``) on the card, float32: nightmare_v3 with fresh
    weights and with model_3176's, and anymal_c with fresh weights, at
    ROLLOUT_NS envs, and the recurrent heads (rnn 512) at 2048: every
    field within ROLLOUT_F32_TOL of its scale, NaN at the plain version's
    positions (env 7's observation), the obs and sigma rows, done, the
    record row, t + 1 and the episode count exact.  Then the captured
    rollout step (``_rollout_replays``) at 2048 envs: replays equal to the
    eager calls bit for bit, and a replay after an in-place weight update
    reads the new weights.  Each case's kernels timed alone
    (``_kernel_ms``) beside the plain versions, the MLPs' cuBLAS products
    and the bounds; ptxas's registers and spills from the build."""
    import torch

    from nightmare_rl_tpu_torch.ops import rollout as R

    t0 = time.perf_counter()
    cases = [(r, N, w, "ActorCritic") for r, ws in (
        ("nightmare_v3", ("fresh", "model_3176")), ("anymal_c", ("fresh",)))
        for N in ROLLOUT_NS for w in ws]
    cases.append(("nightmare_v3", 2048, "fresh", "ActorCriticRecurrent"))
    res = {}
    with torch.no_grad():
        for robot, N, w, policy in cases:
            ppo, state, obs, hidden = _rollout_ppo(robot, N, w, policy)
            r = _rollout_case(ppo, state, obs, hidden, timed=True)
            key = (robot, N, w, policy)
            res[key] = r
            worst = max(r["held"].items(), key=lambda kv: kv[1]["rel"])
            exact = {k: v["differ"] for k, v in r["held"].items()
                     if v["differ"]}
            print(f"rollout-kernel: {robot} {N} envs, {w} weights, {policy}, "
                  f"float32: largest error /|field| {worst[1]['rel']:.3e} "
                  f"({worst[0]}), mu {r['held']['mu']['rel']:.3e}, value "
                  f"{r['held']['value']['rel']:.3e}, logp "
                  f"{r['held']['logp']['rel']:.3e}, term sums "
                  f"{r['held']['term_sums']['rel']:.3e}; exact fields that "
                  f"differ {exact or 'none'}; time-outs {r['time_outs']}, "
                  f"finished {r['finished']}; act {r['act_ms']:.4f} ms "
                  f"alone ({r['act_smem']} B shared a block), store "
                  f"{r['store_ms']:.4f} ms; plain {r['act_plain_ms']:.3f} + "
                  f"{r['store_plain_ms']:.3f} ms; the MLPs' cuBLAS products "
                  f"{r['act_library_ms']:.3f} ms; bounds act "
                  f"{r['act_bound'][0] * 1e3:.2f} us by {r['act_bound'][1]} "
                  f"({r['act_bound'][2] / 1e6:.2f} MB), store "
                  f"{r['store_bound'][0] * 1e3:.3f} us by "
                  f"{r['store_bound'][1]}")
            if worst[1]["rel"] > ROLLOUT_F32_TOL or exact:
                raise AssertionError(f"rollout kernels disagree with their "
                                     f"plain versions: {key}: {r['held']}")
            if r["finished"] < 8 or r["time_outs"] < 8:
                raise AssertionError(f"{key}: the step finished "
                                     f"{r['finished']} episodes")
        ppo, state, obs, hidden = _rollout_ppo("nightmare_v3", 2048, "fresh")
        rep = _rollout_replays(ppo, state, obs, hidden)
    print(f"rollout-kernel: nightmare_v3 2048 envs, the captured rollout "
          f"step: {ROLLOUT_ROWS} replays equal to the eager calls bit for "
          f"bit {rep['same']}; after the weights and std were scaled in "
          f"place the replay's mu moved by {rep['moved']:.3e} and holds "
          f"against the plain act on the new weights to "
          f"{rep['mu']['rel']:.3e}, sigma equal {rep['sigma']}")
    if not rep["same"] or rep["moved"] < 1e-3 or not rep["sigma"] \
            or rep["mu"]["rel"] > ROLLOUT_F32_TOL:
        raise AssertionError(f"the captured rollout step: {rep}")
    ptxas = " | ".join(f"{k['name']}: {k.get('registers')} registers, spill "
                       f"stores/loads {k.get('spill')} B"
                       for k in BUILD_PTXAS.get("rollout", []))
    print(f"rollout-kernel: ptxas {ptxas}; {_smi_line(t0, device_name, smi)}")
    main = res[("nightmare_v3", 2048, "fresh", "ActorCritic")]
    fields = dict(act=(*R.ACT_ROWS, "action", "value"),
                  store=("reward", "done", "record", "t", "n_done",
                         "term_sums"))
    out = {}
    for k in ROLLOUT_WRAPPERS:
        bound = main[f"{k}_bound"]
        out[k] = dict(max_abs_err=max(main["held"][f]["abs"]
                                      for f in fields[k]),
                      ms=main[f"{k}_ms"], plain_ms=main[f"{k}_plain_ms"],
                      bound_ms=bound[0], bound_by=bound[1],
                      library_ms=main.get(f"{k}_library_ms"))
    return out


@contextlib.contextmanager
def _kept_solve_out():
    """Keeps the arguments of the last call of ``ops/solve_out.py::outputs``
    (as they are: the phase that reads them steps eagerly) in the yielded
    dict; the calls go on to the wrapper."""
    from nightmare_rl_tpu_torch.ops import solve_out as SO

    last, real = {}, SO.outputs

    def kept(*args):
        last["args"] = args
        return real(*args)

    SO.outputs = kept
    try:
        yield last
    finally:
        SO.outputs = real


def _solve_out_inputs(robot: str, form, N: int) -> tuple:
    """The arguments of the last substep's ``outputs`` call after
    SOLVE_OUT_STEPS eager env steps of random actions from the reset, in
    the PGS form ``form`` (None: Newton)."""
    import torch

    with _pgs_mode(form), _kept_solve_out() as last:
        env = _task_env(robot, N)
        state, _ = env.reset(0)
        g = torch.Generator(device="cuda").manual_seed(21)
        for _ in range(SOLVE_OUT_STEPS):
            state = env.step(state, 0.3 * torch.randn(
                N, env.num_actions, device="cuda", generator=g)).state
    return last["args"]


def _solve_out_held(args, ref, got) -> dict:
    """Per output field max|err| / max|plain| (the largest), max|err|, NaN
    positions equal, and the selected points whose rows carry no force and
    no pair's: their count and the largest |nforce| the kernel gave them."""
    import torch

    sys_, groups, pair_ab, ns_offset, solved = args[:5]
    rel = ab = 0.0
    nan_same = True
    for r, k in zip(ref, got):
        nan_same &= torch.equal(torch.isnan(r), torch.isnan(k))
        if r.numel() == 0:
            continue
        ok = ~torch.isnan(r)
        err = float((r - k)[ok].abs().max()) if bool(ok.any()) else 0.0
        ab = max(ab, err)
        rel = max(rel, err / max(float(r[ok].abs().max()), 1e-30))
    f, off, idle, idle_max = solved.force, ns_offset, 0, 0.0
    for idx, nf in groups:
        n = idx.shape[1]
        quiet = (f[:, off:off + n * nf].reshape(-1, n, nf) == 0).all(-1)
        if pair_ab is not None:
            for p in pair_ab:
                quiet &= ~(idx[..., None] == p[:, None, :]).any(-1)
        vals = got.nforce.gather(1, idx.expand(f.shape[0], -1))[quiet]
        idle += int(quiet.sum())
        if vals.numel():
            idle_max = max(idle_max, float(vals.abs().max()))
        off += n * nf
    return dict(rel=rel, abs=ab, nan_same=nan_same, idle=idle,
                idle_max=idle_max, loaded=int((ref.nforce > 0).sum()))


def _solve_out_bytes(args, out) -> tuple:
    """The bytes and operations the call needs on these inputs: f, the
    form's inputs, the group and pair indices (a static group's once), S
    once and every output written; of J only the nonzero values of rows
    whose force is nonzero (the products Jᵀf needs).  Also the bytes with
    J read whole."""
    import torch

    from nightmare_rl_tpu_torch.ops import solve_out as SO

    sys_, groups, pair_ab, ns_offset, solved, a0 = args[:6]
    f, it = solved.force, solved.force.element_size()
    N, nefc = f.shape
    nv, ns, ncp = sys_.nv, sys_.nsensor, sys_.ncp
    nb = f.numel() * it + (ns * ncp) * it + (ncp + ns) * N * it
    ops = 2 * int(torch.count_nonzero(sys_.sensor_cpoint_matrix)) * N
    for idx, nf in groups:
        nb += (idx.shape[1] if idx.stride(0) == 0 else idx.numel()) * 8
        ops += idx.numel() * (nf - 1)
    if pair_ab is not None:
        nb += 2 * pair_ab[0].numel() * 8
        ops += 3 * pair_ab[0].numel() * 2
    whole = nb
    if solved.form != SO.NEWTON:
        used = int(torch.count_nonzero(solved.J * (f != 0)[..., None]))
        nb += used * it + 3 * N * nv * it        # J used; qacc_smooth, qfrc, qacc
        whole += solved.J.numel() * it + 3 * N * nv * it
        ops += 2 * used
        extra = (solved.dq.numel() if solved.form == SO.LEGS
                 else solved.Minv.numel()) * it
        nb, whole = nb + extra, whole + extra
        if solved.form == SO.DENSE:
            ops += 2 * N * nv * nv
    return nb, ops, whole


def phase_solve_out_kernel(device_name: str, smi: str) -> dict:
    """The solve_out kernel (``ops/csrc/solve_out.cu``: Jᵀf, qacc, the
    normal forces' scatter, the touch sensors) against
    ``ops/solve_out.py::plain`` on the card, float32, in each of the
    solve's forms (SOLVE_OUT_CASES) at SOLVE_OUT_NS envs, on the last
    substep of SOLVE_OUT_STEPS eager env steps: every field within
    SOLVE_OUT_F32_TOL of its scale, NaN at the plain version's positions,
    some points loaded, the selected points whose rows carry no force (nor
    a pair's) at exactly 0 (at least one such point in the nightmare_v3
    cases); each case timed
    alone (``_kernel_ms``) beside the plain version and the byte bound.
    Returns the legs form's figures at 2048 envs for the kernels' line."""
    import torch

    from nightmare_rl_tpu_torch.ops import solve_out as SO
    from nightmare_rl_tpu_torch.utils.device import full_float32

    t0 = time.perf_counter()
    rows = {}
    for robot, form, label in SOLVE_OUT_CASES:
        for N in SOLVE_OUT_NS:
            args = _solve_out_inputs(robot, form, N)
            with full_float32():
                ref = SO.plain(*args)
                got = SO.outputs(*args)
                torch.cuda.synchronize()
                held = _solve_out_held(args, ref, got)
                ms = _kernel_ms(lambda: SO.outputs(*args))
                plain_ms = _cuda_ms(lambda: SO.plain(*args), 10, 2)
            nb, ops, whole = _solve_out_bytes(args, got)
            bound, by, _ = _bytes_ops_bound(nb, ops, torch.float32)
            _, geo = SO._layout(*args[:4], args[4].force.shape[1],
                                args[4].form, args[6], torch.float32)
            per_sm = SO.envs_per_sm(geo, torch.float32)
            print(f"solve-out-kernel: {robot} {label} N={N} float32: largest "
                  f"error /max|field| {held['rel']:.3e} (tol "
                  f"{SOLVE_OUT_F32_TOL:g}), max|err| {held['abs']:.3e}, NaN "
                  f"positions equal {held['nan_same']}; {held['loaded']} "
                  f"points loaded, {held['idle']} selected points without "
                  f"force, largest |nforce| there {held['idle_max']:g}; "
                  f"{ms:.4f} ms alone (cold L2), "
                  f"plain {plain_ms:.3f} ms; bound {bound * 1e3:.2f} us by "
                  f"{by} ({nb / 1e6:.2f} MB, {ops / 1e6:.2f} M operations; "
                  f"{whole / 1e6:.2f} MB with J read whole) = "
                  f"{bound / ms:.1%} of it; {geo.envs_per_block} envs a "
                  f"block, {geo.smem_bytes} B shared, {per_sm} envs "
                  f"resident per SM")
            if (held["rel"] > SOLVE_OUT_F32_TOL or not held["nan_same"]
                    or held["idle_max"] != 0.0 or held["loaded"] < 1
                    or (robot == "nightmare_v3" and held["idle"] < 1)):
                raise AssertionError(f"the solve_out kernel disagrees with "
                                     f"its plain version: {robot} {label} "
                                     f"N={N}: {held}")
            rows[(label, N)] = dict(max_abs_err=held["abs"], ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=by)
    print(f"solve-out-kernel: {_smi_line(t0, device_name, smi)}")
    return rows[("legs", 2048)]


LEARN_WRAPPERS = ("gae", "grads", "adam")
LEARN_LAUNCHES = {}   # per phase: the learn kernels' launches (gae, grads, adam)
PLAIN_LEARN = ("plain_gae", "plain_grads", "plain_adam")


def _learn_fns():
    """The learn kernels' wrappers (``ops/learn.py``: ``gae``, ``grads``,
    ``adam``), by their counters in ``utils/graph.py``."""
    from nightmare_rl_tpu_torch.utils import graph

    fns = {fn.__name__: fn for fn in graph._COUNTED}
    return tuple(fns[k] for k in LEARN_WRAPPERS)


def _zero_learn() -> None:
    for fn in _learn_fns():
        fn.launches = 0


def _learn_expected(cfg, iters: int, recurrent: bool = False,
                    warmup: int = 1) -> tuple:
    """The learn kernels' launches of ``iters`` learning halves: one gae and
    a grads (the feed-forward net's) and an adam per minibatch, and
    ``warmup`` each for the captured parts' warm-up calls."""
    mb = cfg.algorithm.num_learning_epochs * cfg.algorithm.num_mini_batches
    return (iters + warmup, 0 if recurrent else mb * iters + warmup,
            mb * iters + warmup)


def _check_learn(label: str, expected: tuple) -> None:
    """Asserts the learn kernels' launches since ``_zero_learn``; records
    them in LEARN_LAUNCHES."""
    counts = tuple(fn.launches for fn in _learn_fns())
    print(f"{label}: learn kernel launches gae {counts[0]}, grads "
          f"{counts[1]}, adam {counts[2]} (expected {expected}: one gae and "
          f"a grads and an adam per minibatch an iteration, and the captured "
          f"parts' warm-ups)")
    if counts != tuple(expected):
        raise AssertionError(f"{label}: the learn kernels ran {counts} times, "
                             f"not {expected}")
    LEARN_LAUNCHES[label] = counts


@contextlib.contextmanager
def _plain_learn_calls():
    """Counts the calls of ``ops/learn.py``'s plain versions while the block
    runs (the yielded dict); they go on to the functions."""
    from nightmare_rl_tpu_torch.ops import learn as L

    calls = dict.fromkeys(PLAIN_LEARN, 0)
    saved = {k: getattr(L, k) for k in PLAIN_LEARN}

    def counted(k):
        def call(*args, **kw):
            calls[k] += 1
            return saved[k](*args, **kw)
        return call

    try:
        for k in PLAIN_LEARN:
            setattr(L, k, counted(k))
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(L, k, fn)


def _no_plain_learn(label: str, calls: dict) -> None:
    if any(calls.values()):
        raise AssertionError(f"{label}: plain versions of the learn kernels "
                             f"ran on the card: {calls}")


def _learn_ppo(N: int, robot: str = "nightmare_v3"):
    """A PPO on ``robot``'s env at N envs, float32, ``init(0)``'s weights,
    after one rollout of its config's steps: the PPO, the trajectory (the
    rollout's buffers) and V of the last observations."""
    import torch

    from nightmare_rl_tpu_torch.core.config import PPOCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    ppo = PPO(_task_env(robot, N), PPOCfg())
    ppo.init(0)
    ppo.randomize_episode_lengths()
    with torch.no_grad():
        traj = ppo.rollout()[0]
        last = ppo.last_value(ppo.obs, ppo.hidden)
    return ppo, traj, last


def _rel_max(ref, got) -> float:
    """max|got - ref| / max|ref| (float64)."""
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err / scale if scale > 0 else err


def _learn_bounds(ppo, T: int, N: int, B: int) -> dict:
    """Each learn kernel's bytes (each input read once, each output written
    once) and operations on these shapes in float32.  gae: reward, value,
    done and the last values read, the advantages, returns and mean
    written; 9 operations a step and env.  grads: the minibatch's rows
    (obs, action, mu, sigma, logp, value, return, advantage) and indices,
    the weights and std read, the flat buffer and the losses written; 2
    operations a multiply-add of the forward pass, the weight gradients
    and the deltas, 4 a hidden unit (bias, activation, its derivative, the
    delta's product), 30 an action and 20 a sample for the losses.  adam:
    ``_adam_bound``'s."""
    it = 4
    pl = ppo.act_plan
    A, nobs = pl.net.std.shape[0], pl.actor[0].in_features
    P = ppo._flat.numel() - 1
    macs = sum(m.in_features * m.out_features for m in pl.layers)
    dx = sum(m.in_features * m.out_features
             for m in pl.actor[1:] + pl.critic[1:])
    hidden = sum(m.out_features for m in pl.actor[:-1] + pl.critic[:-1])
    return dict(
        gae=(T * N * (4 * it + 1) + N * it + it, 9 * T * N),
        grads=(B * (it * (nobs + 3 * A + 5) + 8) + it * P + it * (P + 1)
               + 3 * it,
               B * (2 * (2 * macs + dx) + 4 * hidden + 30 * A + 20)),
        adam=_adam_bound(P, len(ppo.params)))


def _adam_bound(P: int, nt: int) -> tuple:
    """adam's bytes and operations on P parameters in nt tensors in
    float32: the flat buffer read and written, the parameters and both
    moments read and written, the step counts, the lr, the losses and the
    statistics; 16 operations a parameter."""
    it = 4
    return it * (2 * (P + 1) + 6 * P + 2 + 3 + 4) + 8 * nt, 16 * P


def _learn_case(N: int, timed: bool, robot: str = "nightmare_v3") -> dict:
    """gae, grads and adam against their plain versions on the card, each
    on the same inputs, from a PPO after a rollout at N envs (its first
    minibatch of the update's permutation; adam from the plain grads'
    gradients, world 1): per field max|err| over its scale, the calls
    repeated bit for bit; with ``timed``, each kernel alone
    (``_kernel_ms``) beside its plain version and, for adam, torch's
    fused Adam and the clip's ops."""
    import torch

    from nightmare_rl_tpu_torch.ops import learn as L

    ppo, traj, last = _learn_ppo(N, robot)
    a = ppo.cfg.algorithm
    T = traj.reward.shape[0]
    res = {"N": N, "T": T, "robot": robot}
    gae_in = (traj.reward, traj.value, traj.done, last, a.gamma, a.lam)
    ref = L.plain_gae(*gae_in)
    got, again = L.gae(*gae_in), L.gae(*gae_in)
    scale = float(ref[0].abs().max())
    res["gae"] = dict(
        adv=_rel_max(ref[0], got[0]), ret=_rel_max(ref[1], got[1]),
        mean=abs(float(ref[2]) - float(got[2])) / scale,
        differ=int((ref[0] != got[0]).sum() + (ref[1] != got[1]).sum()),
        same=all(torch.equal(x, y) for x, y in zip(got, again)),
        abs=max(float((x - y).abs().max()) for x, y in zip(ref, got)))
    adv, ret, mean = ref
    norm_adv = ppo._normalize(adv, *ppo._spread(adv, mean))
    idx = ppo.draw_perm(T, N).reshape(a.num_mini_batches, -1)[0].contiguous()
    B = idx.numel()
    res["B"] = B
    pl, flat = ppo.act_plan, ppo._flat
    g_in = (pl, a, traj, ret, norm_adv, idx, flat)
    l_ref = L.plain_grads(*g_in)
    f_ref = flat.detach().clone()
    l_got = L.grads(*g_in)
    f_got = flat.detach().clone()
    l_again = L.grads(*g_in)
    same = torch.equal(flat, f_got) and torch.equal(l_again, l_got)
    names = [n for n, _ in ppo.net.named_parameters()]
    by_tensor, i = {}, 0
    for name, p in zip(names, ppo.params):
        n = p.numel()
        by_tensor[name] = _rel_max(f_ref[i:i + n], f_got[i:i + n])
        i += n
    kl = float(f_ref[-1])
    res["grads"] = dict(
        by_tensor=by_tensor, worst=max(by_tensor.values()),
        kl=abs(float(f_got[-1]) - kl) / (1 + abs(kl)),
        losses=float(((l_got - l_ref).abs() / (1 + l_ref.abs())).max()),
        same=same, abs=float((f_got - f_ref).abs().max()),
        smem=L.grads_smem_bytes(*g_in), kl_value=kl,
        blocks=L.grads_geometry(pl, B, torch.cuda.get_device_properties(
            0).multi_processor_count)["blocks"],
        kl_band=(a.desired_kl / 2.0, a.desired_kl * 2.0))
    with torch.no_grad():
        flat.copy_(f_ref)  # adam from the plain grads' gradients
    res.update(_adam_hold((ppo.optimizer, flat, ppo.lr, 1, a, l_ref), timed))
    if timed:
        res["gae_ms"] = _kernel_ms(lambda: L.gae(*gae_in))
        res["gae_plain_ms"] = _cuda_ms(lambda: L.plain_gae(*gae_in), 10, 2)
        res["grads_ms"] = _kernel_ms(lambda: L.grads(*g_in))
        res["grads_plain_ms"] = _cuda_ms(lambda: L.plain_grads(*g_in), 10, 2)
        res["bounds"] = {k: _bytes_ops_bound(nb, ops, torch.float32)
                         for k, (nb, ops) in _learn_bounds(
                             ppo, T, N, B).items()}
    return res


def _adam_hold(a_in, timed: bool) -> dict:
    """adam against plain_adam on the card on ``a_in`` (its arguments), each
    from the same state (the parameters, gradients, Adam's state, the lr
    and the flat buffer restored in place before each call): per field
    max|err| over its scale, the step counts and the lr exact, the second
    call equal to the first bit for bit (``"adam"``); with ``timed``, adam
    alone (``_kernel_ms``) beside plain_adam and torch's fused Adam with
    the clip's ops; the state restored after."""
    import torch

    from nightmare_rl_tpu_torch.ops import learn as L

    opt, flat, lr, _, algo, _ = a_in
    params = opt.param_groups[0]["params"]
    held = [*params, *(p.grad for p in params),
            *(x for p in params for x in opt.state[p].values()), lr]
    start = [h.detach().clone() for h in held]
    f_start = flat.detach().clone()

    def restore():
        with torch.no_grad():
            for h, x in zip(held, start):
                h.copy_(x)
            flat.copy_(f_start)

    def after(stats):
        return [h.detach().clone() for h in held] + [flat.clone(),
                                                     stats.clone()]

    restore()
    s_ref = after(L.plain_adam(*a_in))
    restore()
    s_got = after(L.adam(*a_in))
    restore()
    s_again = after(L.adam(*a_in))
    n = len(params)
    # Adam's state by parameter: step, exp_avg, exp_avg_sq
    steps = [2 * n + 3 * k for k in range(n)]
    moments = [j + q for j in steps for q in (1, 2)]
    res = {"adam": dict(
        params=max(_rel_max(s_ref[j], s_got[j]) for j in range(n)),
        moments=max(_rel_max(s_ref[j], s_got[j]) for j in moments),
        steps=all(torch.equal(s_ref[j], s_got[j]) for j in steps),
        lr=torch.equal(s_ref[len(held) - 1], s_got[len(held) - 1]),
        clipped=_rel_max(s_ref[-2], s_got[-2]),
        stats=float(((s_got[-1] - s_ref[-1]).abs()
                     / (1 + s_ref[-1].abs())).max()),
        same=all(torch.equal(x, y) for x, y in zip(s_got, s_again)),
        abs=max(float((s_got[j] - s_ref[j]).abs().max()) for j in range(n)),
        lr_value=float(s_got[len(held) - 1]),
        P=flat.numel() - 1, tensors=n,
        chunks=L.adam_chunks(p.numel() for p in params))}
    restore()
    if timed:
        res["adam_ms"] = _kernel_ms(lambda: L.adam(*a_in))
        restore()
        res["adam_plain_ms"] = _cuda_ms(lambda: L.plain_adam(*a_in), 10, 2)
        restore()

        def library():
            L.clip_by_global_norm(params, algo.max_grad_norm)
            opt.step()

        res["adam_library_ms"] = _kernel_ms(library)
        restore()
        res["adam_bound"] = _bytes_ops_bound(
            *_adam_bound(flat.numel() - 1, n), torch.float32)
    return res


def _adam_recurrent_case(timed: bool) -> dict:
    """adam against plain_adam on the recurrent net's parameters at the
    config's widths (nightmare_v3's 66 observations and 18 actions, LSTMs
    of 512: P = 2,434,795 in 23 tensors), float32 on the card, from
    ``profile_learn._adam_inputs`` (``init_params(0)``'s weights, Adam a
    few steps in, gradients drawn at 1e-2, the clip engaged, the KL at 2.5
    times its target: the lr divided), as ``_adam_hold`` holds it."""
    from nightmare_rl_tpu_torch.tools.profile_learn import _adam_inputs

    return _adam_hold(_adam_inputs("ActorCriticRecurrent", kl=2.5), timed)


def _negative_alpha_case(N: int, alpha: float = -0.5) -> dict:
    """grads against plain_grads on nightmare_v3's net with ELU's
    parameter set to ``alpha`` < 0 (where the activation's output is above
    0 on both sides of z = 0 and the kernel keeps z's signs apart), after a
    rollout at N envs, float32: per gradient tensor max|err| over its
    scale, the losses' and the KL's errors."""
    import torch

    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.ops import rollout as R

    ppo, traj, last = _learn_ppo(N)
    a = ppo.cfg.algorithm
    T = traj.reward.shape[0]
    adv, ret, mean = L.plain_gae(traj.reward, traj.value, traj.done, last,
                                 a.gamma, a.lam)
    norm_adv = ppo._normalize(adv, *ppo._spread(adv, mean))
    idx = ppo.draw_perm(T, N).reshape(a.num_mini_batches, -1)[0].contiguous()
    for m in ppo.net.modules():
        if isinstance(m, torch.nn.ELU):
            m.alpha = alpha
    pl, flat = R.plan(ppo.net), ppo._flat
    g_in = (pl, a, traj, ret, norm_adv, idx, flat)
    l_ref = L.plain_grads(*g_in)
    f_ref = flat.detach().clone()
    l_got = L.grads(*g_in)
    by_tensor, i = {}, 0
    for (name, _), p in zip(ppo.net.named_parameters(), ppo.params):
        n = p.numel()
        by_tensor[name] = _rel_max(f_ref[i:i + n], flat[i:i + n])
        i += n
    kl = float(f_ref[-1])
    return dict(alpha=pl.alpha, B=idx.numel(), worst=max(by_tensor.values()),
                kl=abs(float(flat[-1]) - kl) / (1 + abs(kl)),
                losses=float(((l_got - l_ref).abs() / (1 + l_ref.abs())).max()))


def phase_learn_kernel(device_name: str, smi: str) -> dict:
    """The learn kernels (``ops/csrc/learn.cu``: ``gae``, GAE's recursion;
    ``grads``, a minibatch's forward pass, losses, backward pass, the
    gradients and the KL; ``adam``, the mean over the ranks, the adaptive
    lr, the clip and Adam's step) against their plain versions
    (``ops/learn.py``) on the card, float32, after a rollout of each of
    LEARN_CASES (nightmare_v3 at 2048 and 4096 envs, minibatches of 40,960
    and 81,920 samples; anymal_c's net at 2048), each on the same inputs: gae's advantages and returns
    within GAE_F32_TOL of max|advantage| (and the mean), every gradient
    tensor within GRADS_F32_TOL of its largest magnitude, the losses and
    the KL within LOSS_F32_TOL of 1 + |value|, Adam's updates of the
    parameters and its moments within ADAM_F32_TOL of their scales, the
    step counts and the lr exact; each kernel's second call equal to its
    first bit for bit.  Each kernel timed alone (``_kernel_ms``) beside
    its plain version, adam beside torch's fused Adam with the clip's ops,
    with its bound's share; ptxas's registers and spills from the build,
    grads' grid, shared memory a block and blocks an SM; adam also on the
    recurrent net's 2,434,795 parameters (``_adam_recurrent_case``: held
    at the same tolerances and timed so); grads also with ELU's alpha below
    0 (``_negative_alpha_case``).  Returns the
    kernels' figures on nightmare_v3 at 2048 envs for the kernels'
    line."""
    import torch

    from nightmare_rl_tpu_torch.ops import learn as L

    t0 = time.perf_counter()
    rows = {}
    for robot, N in LEARN_CASES:
        r = _learn_case(N, timed=True, robot=robot)
        rows[robot, N] = r
        g, d, m = r["gae"], r["grads"], r["adam"]
        worst = max(d["by_tensor"].items(), key=lambda kv: kv[1])
        print(f"learn-kernel: {robot} {N} envs x {r['T']} steps "
              f"float32, minibatch {r['B']}: gae advantages "
              f"{g['adv']:.3e}, returns {g['ret']:.3e}, mean {g['mean']:.3e} "
              f"of max|advantage| (tol {GAE_F32_TOL:g}; {g['differ']} "
              f"elements differ); grads largest error by tensor "
              f"{ {k: float(f'{v:.3e}') for k, v in d['by_tensor'].items()} } "
              f"(worst {worst[0]} {worst[1]:.3e}, tol {GRADS_F32_TOL:g}), KL "
              f"{d['kl']:.3e}, losses {d['losses']:.3e} (tol "
              f"{LOSS_F32_TOL:g}); the KL {d['kl_value']:.6f} against the "
              f"band {d['kl_band']}; adam parameters {m['params']:.3e} (tol "
              f"{ADAM_PARAM_F32_TOL:g}), moments {m['moments']:.3e}, clipped "
              f"gradients {m['clipped']:.3e}, statistics {m['stats']:.3e} "
              f"(tol {ADAM_F32_TOL:g}), steps equal {m['steps']}, lr equal "
              f"{m['lr']} ({m['lr_value']:.4e}); second calls bit for bit: "
              f"gae {g['same']}, grads {d['same']}, adam {m['same']}")
        b = r["bounds"]
        print(f"learn-kernel: {robot} {N} envs alone (cold L2): " + "; ".join(
            f"{k} {r[k + '_ms']:.4f} ms, plain {r[k + '_plain_ms']:.3f} ms, "
            f"bound {b[k][0] * 1e3:.2f} us by {b[k][1]} ({b[k][2] / 1e6:.2f} "
            f"MB) = {b[k][0] / r[k + '_ms']:.1%} of it"
            for k in LEARN_WRAPPERS)
            + f"; torch's fused Adam and the clip's ops "
            f"{r['adam_library_ms']:.4f} ms; grads {d['blocks']} blocks a net "
            f"of {GRADS_THREADS} threads, tiles of {L.TILE} samples, "
            f"{d['smem']} B shared a block, "
            f"{L.grads_blocks_per_sm(d['smem'], torch.float32)} blocks an SM")
        if (g["adv"] > GAE_F32_TOL or g["ret"] > GAE_F32_TOL
                or g["mean"] > GAE_F32_TOL or d["worst"] > GRADS_F32_TOL
                or d["kl"] > LOSS_F32_TOL or d["losses"] > LOSS_F32_TOL
                or m["params"] > ADAM_PARAM_F32_TOL
                or m["moments"] > ADAM_F32_TOL
                or m["clipped"] > ADAM_F32_TOL or m["stats"] > ADAM_F32_TOL
                or not (m["steps"] and m["lr"])):
            raise AssertionError(f"the learn kernels disagree with their plain "
                                 f"versions on {robot} at {N} envs: {r}")
        if not (g["same"] and d["same"] and m["same"]):
            raise AssertionError(f"a learn kernel's second call differs from "
                                 f"its first on {robot} at {N} envs")
    rec = _adam_recurrent_case(timed=True)
    m, b = rec["adam"], rec["adam_bound"]
    print(f"learn-kernel: adam on the recurrent net's parameters (P = "
          f"{m['P']:,} in {m['tensors']} tensors, {m['chunks']} chunks) "
          f"float32: parameters {m['params']:.3e} (tol "
          f"{ADAM_PARAM_F32_TOL:g}), moments {m['moments']:.3e}, clipped "
          f"gradients {m['clipped']:.3e}, statistics {m['stats']:.3e} (tol "
          f"{ADAM_F32_TOL:g}), steps equal {m['steps']}, lr equal {m['lr']} "
          f"({m['lr_value']:.4e}); second call bit for bit {m['same']}; alone "
          f"(cold L2) {rec['adam_ms']:.4f} ms, plain "
          f"{rec['adam_plain_ms']:.3f} ms, torch's fused Adam and the clip's "
          f"ops {rec['adam_library_ms']:.4f} ms, bound {b[0] * 1e3:.2f} us by "
          f"{b[1]} ({b[2] / 1e6:.2f} MB) = {b[0] / rec['adam_ms']:.1%} of it")
    if (m["params"] > ADAM_PARAM_F32_TOL or m["moments"] > ADAM_F32_TOL
            or m["clipped"] > ADAM_F32_TOL or m["stats"] > ADAM_F32_TOL
            or not (m["steps"] and m["lr"] and m["same"])):
        raise AssertionError(f"adam disagrees with its plain version on the "
                             f"recurrent net's parameters: {m}")
    neg = _negative_alpha_case(2048)
    print(f"learn-kernel: nightmare_v3 2048 envs, ELU alpha {neg['alpha']} "
          f"(z's signs kept apart), minibatch {neg['B']}: grads worst tensor "
          f"{neg['worst']:.3e} (tol {GRADS_F32_TOL:g}), KL {neg['kl']:.3e}, "
          f"losses {neg['losses']:.3e} (tol {LOSS_F32_TOL:g})")
    if (neg["worst"] > GRADS_F32_TOL or neg["kl"] > LOSS_F32_TOL
            or neg["losses"] > LOSS_F32_TOL):
        raise AssertionError(f"grads disagrees with its plain version with "
                             f"ELU's alpha below 0: {neg}")
    ptxas = " | ".join(f"{k['name']}: {k.get('registers')} registers, spill "
                       f"stores/loads {k.get('spill')} B, stack frame "
                       f"{k.get('stack')} B"
                       for k in BUILD_PTXAS.get("learn", []))
    print(f"learn-kernel: ptxas {ptxas}; {_smi_line(t0, device_name, smi)}")
    main = rows["nightmare_v3", 2048]
    errs = dict(gae=main["gae"]["abs"], grads=main["grads"]["abs"],
                adam=main["adam"]["abs"])
    return {k: dict(max_abs_err=errs[k], ms=main[f"{k}_ms"],
                    plain_ms=main[f"{k}_plain_ms"],
                    bound_ms=main["bounds"][k][0],
                    bound_by=main["bounds"][k][1],
                    library_ms=main["adam_library_ms"] if k == "adam"
                    else None)
            for k in LEARN_WRAPPERS}


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


def phase_play_grid(device_name: str, smi: str) -> dict:
    """model_3176 over the command envelope, through tools/play.py.  Returns
    the smooth and the integrate kernel's launches (``_check_smooth``)."""
    from nightmare_rl_tpu_torch.ops import pgs as P
    from nightmare_rl_tpu_torch.tools import play

    t0 = time.perf_counter()
    with _kept_pgs() as last:
        P.pgs.launches = 0
        _zero_smooth()
        _zero_task()
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
    smooth = _check_smooth("play-grid", expected)
    _check_task("play-grid", expected // 2)
    _hold_kernel("play-grid inputs (its last call)", last["args"],
                 (len(res["rows"]), 112, 24))
    return smooth


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
    _zero_task()
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
    print(f"custom-play: the control step drives pipeline.step with the gait "
          f"engine's targets and no env, so it runs no task kernel: pre "
          f"{_task_fns()[0].launches}, post {_task_fns()[1].launches} "
          f"launches")
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
    with tempfile.TemporaryDirectory() as tmp, _kept_pgs() as last, \
            _plain_learn_calls() as plain:
        P.pgs.launches = 0
        _zero_rollout()
        _zero_learn()
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
    _check_rollout("slice-recurrent", T + GRAPH_WARMUP)
    _check_learn("slice-recurrent", _learn_expected(pcfg, 1, recurrent=True))
    _no_plain_learn("slice-recurrent", plain)
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
    if sys.argv[1:2] == ["--mjx-seeds"]:
        return mjx_seeds(sys.argv[2:])
    if sys.argv[1:2] == ["--eager-kernels"]:
        return eager_kernels_main(sys.argv[2:])
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
        launches, pgs_args, runner, smooth = phase_slice(name, smi, tmp)
        phase_recorder_resume(runner, tmp, name, smi)
    phase_slice_rates(runner, name, smi)
    phase_update_graph(runner, "nightmare_v3 feed-forward", name, smi)
    entry = phase_main_path_kernel(pgs_args, launches)
    smooth_t = phase_smooth_kernel(smooth["kept"], name, smi)
    integrate_t = phase_integrate_kernel(smooth["kept"], name, smi)
    assemble_t = phase_assemble_kernel(smooth["kept"], name, smi)
    task_t = phase_task_kernel(name, smi)
    rollout_t = phase_rollout_kernel(name, smi)
    solve_out_t = phase_solve_out_kernel(name, smi)
    learn_t = phase_learn_kernel(name, smi)
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
    grid_smooth = phase_play_grid(name, smi)
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
    parts = {"slice": smooth["launches"],
             "graph-anymal": graph_anymal["smooth_launches"],
             "play-grid": grid_smooth}
    smooth_launches = {k: sum(p[k] for p in parts.values())
                       for k in STEP_KERNELS}
    for k, total in smooth_launches.items():
        print(f"kernel: {k} launches {total} = " + " + ".join(
            f"{who} {p[k]}" for who, p in parts.items()))
    smooth_entries = [
        dict(name=k, route="cuda",
             source=f"nightmare_rl_tpu_torch/ops/csrc/{k}.cu",
             replaces=f"nightmare_rl_tpu/physics/pipeline.py:{line}",
             launches=smooth_launches[k], **t, library_ms=None)
        for k, line, t in (("smooth", 59, smooth_t),
                           ("integrate", 125, integrate_t),
                           ("assemble", 84, assemble_t))]
    solve_out_entry = dict(
        name="solve_out", route="cuda",
        source="nightmare_rl_tpu_torch/ops/csrc/solve_out.cu",
        replaces="nightmare_rl_tpu/physics/solver.py:757",
        launches=smooth_launches["solve_out"], **solve_out_t,
        library_ms=None)
    task_launches = sum(TASK_LAUNCHES.values())
    print(f"kernel: task launches {task_launches} (pre + post) = " + " + ".join(
        f"{who} {n}" for who, n in TASK_LAUNCHES.items()))
    task_entry = dict(
        name="task", route="cuda",
        source="nightmare_rl_tpu_torch/ops/csrc/task.cu",
        replaces="nightmare_rl_tpu/envs/nightmare_v3.py:182",
        launches=task_launches, **task_t, library_ms=None)
    rollout_launches = [sum(n[i] for n in ROLLOUT_LAUNCHES.values())
                        for i in range(len(ROLLOUT_WRAPPERS))]
    print("kernel: rollout launches " + ", ".join(
        f"{k} {n} = " + " + ".join(f"{who} {c[i]}"
                                   for who, c in ROLLOUT_LAUNCHES.items())
        for i, (k, n) in enumerate(zip(ROLLOUT_WRAPPERS, rollout_launches))))
    rollout_entries = [
        dict(name=f"rollout.{k}", route="cuda",
             source="nightmare_rl_tpu_torch/ops/csrc/rollout.cu",
             replaces=f"nightmare_rl_tpu/rl/ppo.py:{line}", launches=n,
             **rollout_t[k])
        for k, line, n in zip(ROLLOUT_WRAPPERS, (159, 171), rollout_launches)]
    learn_launches = [sum(n[i] for n in LEARN_LAUNCHES.values())
                      for i in range(len(LEARN_WRAPPERS))]
    print("kernel: learn launches " + ", ".join(
        f"{k} {n} = " + " + ".join(f"{who} {c[i]}"
                                   for who, c in LEARN_LAUNCHES.items())
        for i, (k, n) in enumerate(zip(LEARN_WRAPPERS, learn_launches))))
    slices = {who: LEARN_LAUNCHES[who][1]
              for who in ("slice", "slice-legs", "slice-anymal")}
    print("kernel: grads launches on the training slices: " + ", ".join(
        f"{who} {n}" for who, n in slices.items()))
    if not all(n > 0 for n in slices.values()):
        raise AssertionError(f"a training slice ran no grads kernel: {slices}")
    learn_entries = [
        dict(name=f"learn.{k}", route="cuda",
             source="nightmare_rl_tpu_torch/ops/csrc/learn.cu",
             replaces=f"nightmare_rl_tpu/rl/ppo.py:{line}", launches=n,
             **learn_t[k])
        for k, line, n in zip(LEARN_WRAPPERS, (187, 339, 355),
                              learn_launches)]
    print("graph: kernels per env step, eager / captured graph's kernel "
          "nodes: " + ", ".join(f"nightmare_v3 {form} "
                                f"{r['eager_kernels']:.0f} / {r['nodes']}"
                                for form, r in graph.items())
          + f", anymal_c {graph_anymal['eager_kernels']:.0f} / "
          f"{graph_anymal['nodes'].get('KERNEL', 0)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [entry, legs_entry, newton_entry]
                      + smooth_entries + [solve_out_entry, task_entry]
                      + rollout_entries + learn_entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
