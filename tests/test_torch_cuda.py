"""Tests of the port that need an NVIDIA card: the PGS CUDA kernel against
its plain PyTorch version in cases beside those of ``chip_smoke.py``
(float32 random systems, float32 panels that take the plain-load path, a
NaN in b, infinite bounds, the occupancy of the main path's geometry); the
anymal_c step under a process-wide TF32 setting, and the nightmare_v3
step, the actor-critic, the gait engine and custom_play's control step
under ``torch.set_float32_matmul_precision("high")``; the Newton solve on the
card against the CPU (float64, 1e-10); the Newton kernel against the
plain solve on the card (float64 random batches, 64, 37 and 1 envs, cold
and warmstarted, 1e-9 above the line search's round-off floor);
tools/play.py's grid rollout of
model_3176 on the card against the CPU (float64, 3 steps, 1e-9); the
kernel on the inputs of custom_play's contact cap (max_contacts=16, float32,
1e-5 of max|f|).
The leg-sparse kernel (``ops/csrc/pgs_legs.cu``; f, and qacc's change from
its epilogue) against ``leg_panels`` + ``pgs_legs_reference`` (+
``arrow.solve_lt``) on random block-arrow problems
(``chip_smoke._random_arrow_batch``) at the edges of its design (ghost
groups, 4 and 5 legs, an odd row count, no sweeps), float32 at the main
path's shape, a NaN in b, infinite bounds, its occupancy, its refusal
of a layout it does not take, and the cases of its row and pair lists
(every row active, none, an empty env beside full ones, a NaN in b of a
pinned and of an active row; float64 to 1e-12, float32 to 1e-5).
The captured step (``utils/graph.py``): the env step's replays against the
eager steps in both PGS forms (every StepOut field bit for bit, the env
generator's state after each step, no host sync in a replay, the launch
counters counting replays), ``PPO.rollout`` against eager calls of the step
its graph holds (feed-forward and recurrent, bit for bit), and a capture
that fails naming the line; anymal_c's step captured against its eager
steps, and the PPO's learning half (``CapturedLearn`` of ``PPO._learn``)
against the same call made eagerly from one state (feed-forward and
recurrent: statistics, parameters, gradients, Adam's state, the lr, the
permutation and the generator bit for bit), and the same for a
``ShardedPPO`` on an in-process world-1 NCCL mesh (its parts replayed,
the all_reduce between them).  Tests that count the dense kernel's launches
pin NIGHTMARE_PGS=kernel (on the card the default is the dispatch probe's
verdict).
Float64 cases hold the kernel to 1e-10 of max|f|, float32 random systems
to 1e-3 (a chain of 560 dependent row steps in float32 rounding on random,
often ill-conditioned systems).  They skip where torch.cuda.is_available()
is false.  The file imports no JAX, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.physics import arrow, solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_system(N, nefc, nv, ns_offset, seed):
    g = torch.Generator().manual_seed(seed)
    J = torch.randn(N, nefc, nv, generator=g, dtype=torch.float64)
    G = torch.randn(N, nv, nv, generator=g, dtype=torch.float64)
    U = J @ (G @ G.transpose(1, 2) + 0.1 * torch.eye(nv, dtype=torch.float64))
    b = torch.randn(N, nefc, generator=g, dtype=torch.float64) * 5
    R = torch.randn(N, nefc, generator=g, dtype=torch.float64).abs() + 0.01
    lo = torch.zeros(N, nefc, dtype=torch.float64)
    hi = torch.full((N, nefc), math.inf, dtype=torch.float64)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    return [J, U, b, R, lo, hi]


@pytest.mark.cuda
@pytest.mark.parametrize("ns_offset", [0, 4])
def test_kernel_matches_reference_float32(cuda, ns_offset):
    """Main-path solver shapes in float32 (tolerance: module docstring)."""
    args = [x.to(cuda, torch.float32)
            for x in _random_system(256, 112, 24, ns_offset, 5)]
    before = P.pgs.launches
    out = P.pgs(*args, 3, 4, ns_offset)
    assert P.pgs.launches == before + 1
    ref = P.pgs_reference(*args, 3, 4, ns_offset)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-3, err


@pytest.mark.cuda
def test_kernel_takes_nv_above_one_warp(cuda):
    """nv > 32: lanes own strided columns."""
    args = [x.to(cuda) for x in _random_system(64, 40, 45, 2, 6)]
    out = P.pgs(*args, 3, 4, 2)
    ref = P.pgs_reference(*args, 3, 4, 2)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-10


def _rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
def test_kernel_plain_load_panels_float32(cuda):
    """nefc * nv * 4 bytes not a multiple of 16: the panels are staged by
    plain loads instead of bulk copies; N=7 leaves one group of the last
    block idle."""
    args = [x.to(cuda, torch.float32) for x in _random_system(7, 21, 11, 2, 8)]
    out = P.pgs(*args, 3, 4, 2)
    assert _rel_err(out, P.pgs_reference(*args, 3, 4, 2)) <= 1e-3


@pytest.mark.cuda
def test_kernel_passes_nan_through(cuda):
    """A NaN in b spreads through the clips of its own env, as in the plain
    version, and leaves the other envs alone."""
    args = [x.to(cuda) for x in _random_system(8, 112, 24, 4, 9)]
    args[2][3, 50] = math.nan
    out = P.pgs(*args, 3, 4, 4)
    ref = P.pgs_reference(*args, 3, 4, 4)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert bool(torch.isnan(out[3]).any())
    keep = torch.arange(8, device=cuda) != 3
    assert _rel_err(out[keep], ref[keep]) <= 1e-10


@pytest.mark.cuda
def test_kernel_takes_infinite_bounds(cuda):
    """Rows unbounded on both sides (lo = -inf, hi = inf) are never clipped."""
    args = [x.to(cuda) for x in _random_system(16, 112, 24, 4, 10)]
    args[4][:, :4] = -math.inf
    args[5][:, :4] = math.inf
    out = P.pgs(*args, 3, 4, 4)
    ref = P.pgs_reference(*args, 3, 4, 4)
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= 1e-10


@pytest.mark.cuda
def test_main_path_geometry_is_resident(cuda):
    """The float32 main-path geometry holds at least 8 envs on an SM: two
    blocks of 4 envs, each staging its J and U panels."""
    geo = P.launch_geometry(112, 24, 4, 0, 4)
    assert P.envs_per_sm(geo, 24, torch.float32) >= 8


@pytest.mark.cuda
def test_profile_pgs_reports_the_phases(cuda):
    """tools/profile_pgs.py times the prologue, a row step and a pair step."""
    from nightmare_rl_tpu_torch.tools import profile_pgs

    res = profile_pgs.main(["-e", "300"])
    assert res["wave_envs"] == 300 and res["lanes_per_env"] == 8
    assert res["wave_prologue_us"] > 0
    assert res["row_step_ns"] > 0 and res["pair_step_ns"] > 0


@pytest.mark.cuda
def test_anymal_step_runs_full_float32_under_tf32(cuda):
    """With TF32 allowed process-wide, the anymal_c step still multiplies at
    full float32 (the Newton line search needs it): it stays finite, equals
    the step with TF32 off within 1e-5 relative, and leaves the setting as
    it found it."""
    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv

    prev = torch.backends.cuda.matmul.allow_tf32
    obs = {}
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            env = AnymalCEnv(AnymalCCfg(num_envs=256), device=cuda)
            state, _ = env.reset(0)
            acts = 0.3 * torch.randn(256, 12, device=cuda,
                                     generator=torch.Generator(cuda).manual_seed(1))
            obs[tf32] = env.step(state, acts).obs
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert bool(torch.isfinite(obs[True]).all())
    err = float((obs[True] - obs[False]).abs().max() / obs[False].abs().max())
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_nightmare_paths_run_full_float32_under_high_precision(cuda):
    """With ``torch.set_float32_matmul_precision("high")`` (TF32 in matrix
    products), the nightmare_v3 step, the feed-forward actor-critic, the
    gait engine's batched step and custom_play's control step still
    multiply at full float32: their outputs equal those at "highest"
    within 1e-6 relative, and the setting is left as it was found."""
    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.engine import gait as G
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic
    from nightmare_rl_tpu_torch.tools import custom_play

    prev = torch.get_float32_matmul_precision()
    gen = torch.Generator(cuda).manual_seed(2)
    acts = 0.3 * torch.randn(256, 18, device=cuda, generator=gen)
    obs_in = torch.randn(2048, 66, device=cuda, generator=gen)
    net = ActorCritic(66, 18).to(cuda)
    out = {}
    try:
        for prec in ("high", "highest"):
            torch.set_float32_matmul_precision(prec)
            env = NightmareV3Env(NightmareV3Cfg().replace(
                env=EnvCfg(num_envs=256)), device=cuda)
            state, _ = env.reset(0)
            step_obs = env.step(state, acts).obs
            mu, _, value = net(obs_in)
            sys_, cfg, phys, es, limited = custom_play.make(64, device=cuda)
            lin = torch.full((64,), 0.08, device=cuda)
            ang = torch.zeros(64, device=cuda)
            phys, es, limited = custom_play.control_step(
                sys_, cfg, phys, es, limited, 0.0, lin, ang)
            _, angles = G.update(cfg, es, 0.02, lin, ang,
                                 torch.ones(64, dtype=torch.long, device=cuda),
                                 torch.ones(64, dtype=torch.long, device=cuda))
            out[prec] = (step_obs, mu, value, net.act_inference(obs_in),
                         phys.qpos, angles)
            assert torch.get_float32_matmul_precision() == prec
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(out["high"], out["highest"]):
        assert bool(torch.isfinite(a).all())
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert err <= 1e-6, err


@pytest.mark.cuda
def test_newton_solve_card_matches_cpu(cuda):
    """Random float64 batches with dim-3 and dim-6 cone groups, dof-friction
    and one-sided rows: the solve on the card equals the CPU's to 1e-10
    (4 Newton steps, 1 refinement, which on this batch stays above the
    line search's round-off floor; see tests/test_torch_newton.py)."""
    from nightmare_rl_tpu_torch.physics import newton

    g = torch.Generator().manual_seed(3)
    N, nv, n3, n6 = 64, 12, 4, 3
    nefc = 10 + 3 * n3 + 6 * n6

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    J, aref = rnd(N, nefc, nv), rnd(N, nefc)
    R = 0.05 + 0.45 * torch.rand(N, nefc, generator=g, dtype=torch.float64)
    fl = torch.zeros(N, nefc, dtype=torch.float64)
    fl[:, :4] = 0.5
    qa = torch.zeros(N, nefc, dtype=torch.bool)
    qa[:, 4:10] = True
    mus3 = 0.05 + torch.rand(N, n3, 2, generator=g, dtype=torch.float64)
    mus6 = 0.05 + torch.rand(N, n6, 5, generator=g, dtype=torch.float64)
    G = rnd(N, nv, nv)
    M = 0.2 * (G @ G.transpose(1, 2) + nv * torch.eye(nv, dtype=torch.float64))
    a0, x0 = 3.0 * rnd(N, nv), 3.0 * rnd(N, nv)

    def on(dev):
        t = lambda x: x.to(dev)
        cones = (newton.ConeGroup(10, 3, t(mus3[..., 0] / 10), t(mus3),
                                  t(torch.rand(N, n3, generator=g) < 0.8)),
                 newton.ConeGroup(10 + 3 * n3, 6, t(mus6[..., 0] / 10), t(mus6),
                                  t(torch.rand(N, n6, generator=g) < 0.8)))
        efc = newton.NewtonEfc(t(J), t(aref), t(R), t(qa), t(fl), cones)
        return newton.solve(efc, t(M), t(a0), 4, 1, x0=t(x0))

    g.manual_seed(4)
    ref = on("cpu")
    g.manual_seed(4)
    out = on(cuda)
    for name in ("force", "qfrc_constraint", "qacc"):
        a, b = getattr(ref, name), getattr(out, name).cpu()
        assert float((a - b).abs().max() / (1 + a.abs().max())) <= 1e-10, name


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 37, 1])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmstart"])
def test_newton_kernel_matches_plain(cuda, N, warm):
    """The Newton kernel (ops/csrc/newton.cu) against the plain
    newton.solve on the card, float64 random batches with dim-3 and dim-6
    cone groups, dof-friction and one-sided rows, at 2 Newton steps with 1
    refinement: every env whose line-search decisions stand above the
    round-off floor of φ' agrees to chip_smoke.NEWTON_F64_TOL
    (chip_smoke._newton_floor);
    N=37 and N=1 leave warps of a block without an env."""
    from nightmare_rl_tpu_torch.ops import newton as K
    from nightmare_rl_tpu_torch.physics import newton

    g = torch.Generator().manual_seed(5)
    nv, n3, n6 = 12, 4, 3
    nefc = 10 + 3 * n3 + 6 * n6

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    J, aref = rnd(N, nefc, nv), rnd(N, nefc)
    R = 0.05 + 0.45 * torch.rand(N, nefc, generator=g, dtype=torch.float64)
    fl = torch.zeros(N, nefc, dtype=torch.float64)
    fl[:, :4] = 0.5
    qa = torch.zeros(N, nefc, dtype=torch.bool)
    qa[:, 4:10] = True
    mus3 = 0.05 + torch.rand(N, n3, 2, generator=g, dtype=torch.float64)
    mus6 = 0.05 + torch.rand(N, n6, 5, generator=g, dtype=torch.float64)
    G = rnd(N, nv, nv)
    M = 0.2 * (G @ G.transpose(1, 2) + nv * torch.eye(nv, dtype=torch.float64))
    a0, x0 = 3.0 * rnd(N, nv), 3.0 * rnd(N, nv)
    act3 = torch.rand(N, n3, generator=g) < 0.8
    act6 = torch.rand(N, n6, generator=g) < 0.8
    t = lambda x: x.to(cuda)
    cones = (newton.ConeGroup(10, 3, t(mus3[..., 0] / 10), t(mus3), t(act3)),
             newton.ConeGroup(10 + 3 * n3, 6, t(mus6[..., 0] / 10), t(mus6),
                              t(act6)))
    efc = newton.NewtonEfc(t(J), t(aref), t(R), t(qa), t(fl), cones)
    x = t(x0) if warm else None
    launches = K.newton_solve.launches
    out = K.newton_solve(efc, t(M), t(a0), 2, 1, x0=x)
    assert K.newton_solve.launches == launches + 1
    margin, ref = smoke._newton_floor(efc, t(M), t(a0), x, 2, 1)
    gap = smoke._newton_gap(ref, out)
    held = margin >= smoke.NEWTON_FLOOR
    assert int(held.sum()) * 2 > N
    assert float(gap[held].max()) <= smoke.NEWTON_F64_TOL, gap.tolist()


@pytest.mark.cuda
def test_play_grid_rollout_card_matches_cpu(cuda, monkeypatch):
    """tools/play.py's rollout of model_3176 on the 7-command grid, float64,
    3 steps from one post-reset state: the card equals the CPU to 1e-9."""
    monkeypatch.setenv("NIGHTMARE_PGS", "kernel")
    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.tools import play
    from nightmare_rl_tpu_torch.utils.checkpoint import to_device

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "artifacts", "model_3176.pt")
    cfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=len(play.GRID)))
    recs = {}
    state0, obs0 = None, None
    for dev in ("cpu", cuda):
        env = NightmareV3Env(cfg, dtype=torch.float64, device=dev)
        if state0 is None:
            state0, obs0 = env.reset(0)
        before = P.pgs.launches
        _, _, recs[str(dev)] = play.rollout(
            env, play.load_policy(ckpt, env), to_device(state0, dev),
            obs0.to(dev), torch.from_numpy(play.GRID), 3)
    # 3 steps of 2 substeps, and the captured step's eager warm-up
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep
    assert P.pgs.launches == before + (3 + CapturedStep.WARMUP) * 2
    for k in ("qpos", "obs", "vel", "feet"):
        a, b = recs["cpu"][k], recs[str(cuda)][k]
        assert abs(a - b).max() <= 1e-9, k


@pytest.mark.cuda
def test_kernel_at_custom_play_contact_cap(cuda, monkeypatch):
    """The PGS kernel on the inputs that custom_play's physics
    (max_contacts=16, float32, 256 envs) hands it, against pgs_reference."""
    from nightmare_rl_tpu_torch.physics import pipeline
    from nightmare_rl_tpu_torch.tools import custom_play

    monkeypatch.setenv("NIGHTMARE_PGS", "kernel")
    sys_, _, phys, _, _ = custom_play.make(256, device=cuda)
    g = torch.Generator().manual_seed(12)
    qpos = phys.qpos.cpu()
    qpos[:, 7:] += 0.3 * torch.randn(256, 18, generator=g)
    qpos[:, 2] -= 0.1  # feet into the ground: ~28 % of the rows active
    kept = {}

    def pgs_kept(*args):
        kept["args"] = args
        return P.pgs(*args)

    solver.pgs = pgs_kept
    try:
        pipeline.step(sys_, phys.replace(qpos=qpos.to(cuda)),
                      torch.zeros(256, 18, device=cuda), 1)
    finally:
        solver.pgs = P.pgs
    args = kept["args"]
    J = args[0]
    assert J.shape == (256, 80, 24) and J.dtype == torch.float32
    active = float((args[5] > 0).double().mean())
    assert active >= 0.05, active
    out = P.pgs(*args)
    ref = P.pgs_reference(*args)
    assert _rel_err(out, ref) <= 1e-5


# ---------------------------------------------------------------------------
# the leg-sparse kernel


def _legs(N, nefc, B, ns_offset, seed, dtype=torch.float64, **kw):
    prob = smoke._random_arrow_batch(np.random.default_rng(seed), N, nefc, B, 3,
                                     6, ns_offset, **kw)
    return smoke._legs_args(prob, "cuda", dtype)


def _legs_plain(args, it, ns, ns_offset):
    return smoke._legs_plain(tuple(args) + (it, ns, ns_offset))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("N,nefc,B,ns_offset,it,ns", [
    (7, 112, 6, 0, 3, 4),       # ghost groups in the second block
    (64, 41, 4, 3, 3, 4),       # anymal_c's layout, an odd contact block
    (33, 20, 5, 2, 3, 0),       # 5 legs (one idle lane), no noslip
    (16, 30, 6, 4, 0, 4),       # noslip from f = 0 only
    (5, 1, 6, 1, 3, 4),         # one dof row, no pair
])
def test_legs_kernel_edges(cuda, N, nefc, B, ns_offset, it, ns):
    npair = min(8, nefc - ns_offset - (nefc - ns_offset) % 2)
    args = _legs(N, nefc, B, ns_offset, N + nefc, npair_rows=npair,
                 same_branch_rows=min(2, npair))
    before = P.pgs_legs.launches
    out, dq = P.pgs_legs(*args, it, ns, ns_offset)
    assert P.pgs_legs.launches == before + 1
    ref, dq_ref = smoke._legs_plain(tuple(args) + (it, ns, ns_offset))
    for x, r in ((out, ref), (dq, dq_ref)):
        scale = float(r.abs().max()) or 1.0
        assert float((x - r).abs().max()) / scale <= 1e-10


@pytest.mark.cuda
def test_legs_kernel_float32_main_shape(cuda):
    args = _legs(256, 112, 6, 0, 40, dtype=torch.float32, npair_rows=16)
    out, _ = P.pgs_legs(*args, 3, 4, 0)
    assert _rel_err(out, _legs_plain(args, 3, 4, 0)) <= 1e-3


@pytest.mark.cuda
def test_legs_kernel_passes_nan_through(cuda):
    """A NaN in b spreads through its own env, as in the plain version."""
    args = list(_legs(8, 112, 6, 4, 41, npair_rows=16))
    args[4][3, 50] = math.nan
    out, _ = P.pgs_legs(*args, 3, 4, 4)
    ref = _legs_plain(args, 3, 4, 4)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert bool(torch.isnan(out[3]).any())
    keep = torch.arange(8, device=cuda) != 3
    assert _rel_err(out[keep], ref[keep]) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_legs_kernel_row_and_pair_lists(cuda, case, dtype):
    """The rows and pairs the legs kernel sweeps (``chip_smoke``'s cases:
    every row active, none, an env with none beside full ones, a NaN in b
    of a pinned and of an active row) at 37 envs (a ghost group): NaN at
    the plain version's positions, the finite f and dqacc within 1e-12
    (float64) or 1e-5 (float32) of their largest value."""
    label, edit = smoke._legs_list_cases()[case]
    prob = smoke._random_arrow_batch(np.random.default_rng(50 + case), 37, 112,
                                     6, 3, 6, npair_rows=16)
    smoke._hold_legs_case(label, prob, edit, dtype)


@pytest.mark.cuda
def test_legs_kernel_takes_infinite_bounds(cuda):
    args = list(_legs(16, 112, 6, 4, 42, npair_rows=16))
    args[6][:, :4] = -math.inf
    args[7][:, :4] = math.inf
    out, dq = P.pgs_legs(*args, 3, 4, 4)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dq).all())
    assert _rel_err(out, _legs_plain(args, 3, 4, 4)) <= 1e-10


@pytest.mark.cuda
def test_legs_main_path_geometry_is_resident(cuda):
    """The float32 main-path geometry holds at least 16 envs on an SM
    (20 predicted: 5 blocks of 4), so 2048 envs take one wave."""
    geo = P.legs_geometry(112, 6, 3, 6, 4, 0, 4)
    per_sm = P.legs_envs_per_sm(geo, torch.float32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert per_sm >= 16 and per_sm * sms >= 2048


@pytest.mark.cuda
def test_legs_kernel_refuses_a_layout_it_does_not_take(cuda):
    """Legs of 4 dofs: refused on the card as on the CPU, no launch."""
    B, s, nb, nefc = 4, 4, 6, 8
    z = lambda *sh: torch.zeros(*sh, dtype=torch.float64, device=cuda)
    ids = torch.zeros(1, nefc, dtype=torch.int32, device=cuda)
    mask = torch.ones(1, nefc, dtype=torch.bool, device=cuda)
    before = P.pgs_legs.launches
    with pytest.raises(ValueError):
        P.pgs_legs(arrow.ArrowLayout(nb + B * s, nb, B, s),
                   arrow.ArrowFac(z(1, B, s, s), z(1, B, s, nb), z(1, nb, nb),
                                  z(1, B, s, nb)),
                   z(1, nefc, nb + B * s), solver.LegMeta(ids, ids, mask, mask),
                   z(1, nefc), z(1, nefc), z(1, nefc), z(1, nefc), 3, 4, 0)
    assert P.pgs_legs.launches == before


@pytest.mark.cuda
def test_profile_pgs_reports_the_legs_phases(cuda):
    """tools/profile_pgs.py --form legs times the prologue, a row step and
    a pair step of the legs kernel, a solve with the main path's share of
    active pairs (shorter), and reads its phase stamps (--timeline)."""
    from nightmare_rl_tpu_torch.tools import profile_pgs

    res = profile_pgs.main(["-e", "300", "--form", "legs", "--timeline"])
    assert res["form"] == "legs" and res["wave_envs"] == 300
    assert res["wave_prologue_us"] > 0
    assert res["row_step_ns"] > 0 and res["pair_step_ns"] > 0
    assert res["active_us"] < res["N300_it3_ns4_us"]
    for run in res["timeline"].values():
        assert set(run) == set(profile_pgs.TIMELINE_PHASES) | {"block_us"}
        assert all(v["max_us"] >= v["mean_us"] >= 0 for v in run.values())


# ---------------------------------------------------------------------------
# the captured step (utils/graph.py)


def _graph_env(cuda, n=64):
    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env

    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=n)),
                          device=cuda)


def _bitwise(a, b) -> bool:
    from nightmare_rl_tpu_torch.utils.graph import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        bool(torch.all((x == y) | (torch.isnan(x) & torch.isnan(y))
                       if x.is_floating_point() else x == y))
        for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["legs", "kernel", None])
def test_captured_env_step_replays_equal_eager(cuda, form, monkeypatch,
                                               tmp_path):
    """The env step captured as a CUDA graph, 64 envs, 8 replays against 8
    eager steps from one state and generator state: every StepOut field
    equal bit for bit, the env generator's state equal after k replays and
    k eager steps, no host sync in a replay, and the form's launch counter
    counting ``decimation`` launches per replay (none at capture).  With
    NIGHTMARE_PGS unset the form is the probe's verdict, decided in the
    env's constructor: the capture reads it from the dispatch's cache."""
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    if form is None:
        monkeypatch.delenv("NIGHTMARE_PGS", raising=False)
        monkeypatch.setenv("NIGHTMARE_PROBE_CACHE", str(tmp_path / "p.json"))
        monkeypatch.setattr(P, "_MODE_CACHE", {})
    else:
        monkeypatch.setenv("NIGHTMARE_PGS", form)
    env = _graph_env(cuda)
    form = form or solver.prewarm(env.sys)
    counter = P.pgs_legs if form == "legs" else P.pgs
    s0, _ = env.reset(0)
    s0.episode_length[:3] = env.max_episode_length - 3   # resets mid-run
    g = torch.Generator(cuda).manual_seed(4)
    acts = [0.3 * torch.randn(64, 18, device=cuda, generator=g)
            for _ in range(8)]
    gen0 = env.generator.get_state()
    eager, s, gens = [], s0, []
    for a in acts:
        out = env.step(s, a)
        eager.append(clone(out))
        gens.append(env.generator.get_state())
        s = out.state
    env.generator.set_state(gen0)
    n0 = counter.launches
    step = CapturedStep(env.step, s0, acts[0], generators=[env.generator],
                        state_field="state")
    assert step.graph is not None
    assert counter.launches == n0 + step.WARMUP * 2   # the warm-up's, eager
    assert step.launches[counter.__name__] == 2
    s = s0
    for k, a in enumerate(acts):
        before = counter.launches
        out = step(s, a)
        assert counter.launches == before + 2
        assert _bitwise(out, eager[k]), k
        assert torch.equal(env.generator.get_state(), gens[k]), k
        s = out.state
    assert bool(eager[3].done[:3].all())  # the forced time-outs
    assert smoke._host_syncs(lambda: step(s, acts[0])) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["ActorCritic", "ActorCriticRecurrent"])
def test_captured_rollout_equals_eager_steps(cuda, policy, monkeypatch):
    """PPO.rollout on the card (one replay per step) against eager calls of
    the step the graph holds, from one state and generator states, 64
    envs x 8 steps: the trajectory, the episode sums and the final state
    equal bit for bit (the recurrent net's cuDNN LSTM included)."""
    import dataclasses

    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO
    from nightmare_rl_tpu_torch.utils.graph import clone

    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    cfg = PPOCfg()
    cfg = cfg.replace(runner=RunnerCfg(num_steps_per_env=8,
                                       policy_class_name=policy),
                      policy=dataclasses.replace(cfg.policy,
                                                 rnn_hidden_size=64))
    env = _graph_env(cuda)
    ppo = PPO(env, cfg, record_states=True)
    ppo.init(0)
    ppo.env_state.episode_length[:3] = env.max_episode_length - 3
    gens = [ppo.generator, env.generator]
    g0 = [g.get_state() for g in gens]
    start = clone((ppo.env_state, ppo.obs, ppo.hidden))
    traj, n_done, sums, rec = clone(ppo.rollout())
    end = clone((ppo.env_state, ppo.obs, ppo.hidden))
    g1 = [g.get_state() for g in gens]

    for g, s in zip(gens, g0):
        g.set_state(s)
    carry = (*start, *ppo._zeros)
    with torch.no_grad():
        for _ in range(8):
            carry = ppo._rollout_step(carry)
    assert _bitwise(ppo._traj, traj)
    assert _bitwise(carry[3:], (torch.full((1,), 8, device=cuda), n_done,
                                sums))
    assert _bitwise(carry[:3], end)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, g1))
    assert bool(traj.done[:, :3].any())


@pytest.mark.cuda
def test_capture_failure_names_the_op(cuda):
    """A step that synchronizes cannot be captured: the error names the
    line, and nothing runs eagerly in its place."""
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep

    def step(x):
        return x * float(x.sum())  # a device-to-host copy

    with pytest.raises(RuntimeError, match="capture of .*step failed at"):
        CapturedStep(step, torch.ones(4, device=cuda))


@pytest.mark.cuda
def test_captured_anymal_step_equals_eager(cuda):
    """anymal_c's env step (Newton, elliptic cones) captured and replayed
    against the eager steps from one state and generator state, 64 envs x
    4 steps with a forced time-out at the second: every StepOut field bit
    for bit, the generator's state equal, no host sync in a replay."""
    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    env = AnymalCEnv(AnymalCCfg(num_envs=64), device=cuda)
    s0, _ = env.reset(0)
    s0.episode_length[:3] = env.max_episode_length - 1
    g = torch.Generator(device=cuda).manual_seed(4)
    acts = [0.3 * torch.randn(64, 12, device=cuda, generator=g)
            for _ in range(4)]
    gen0 = env.generator.get_state()
    eager, s = [], s0
    for a in acts:
        out = env.step(s, a)
        eager.append(clone(out))
        s = out.state
    gen1 = env.generator.get_state()
    env.generator.set_state(gen0)
    step = CapturedStep(env.step, s0, acts[0], generators=[env.generator],
                        state_field="state")
    s = s0
    for k, a in enumerate(acts):
        out = step(s, a)
        assert _bitwise(out, eager[k]), k
        s = out.state
    assert torch.equal(env.generator.get_state(), gen1)
    assert bool(eager[1].done[:3].all())
    assert smoke._host_syncs(lambda: step(s, acts[0])) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["ActorCritic", "ActorCriticRecurrent"])
def test_captured_update_equals_eager_update(cuda, policy, monkeypatch):
    """The PPO's learning half captured (``CapturedLearn``: the prologue
    and a minibatch step, as ``learn_step`` replays them) against the same
    call made eagerly, both from one state after a rollout of 64 envs x 8
    steps: the statistics, every held tensor (parameters, gradients, Adam's
    state, the lr), the permutation and the generator's state equal bit for
    bit; the captures' warm-ups left the held tensors and the generator as
    they were."""
    import dataclasses

    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO, CapturedLearn
    from nightmare_rl_tpu_torch.utils.graph import clone

    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    cfg = PPOCfg()
    cfg = cfg.replace(runner=RunnerCfg(num_steps_per_env=8,
                                       policy_class_name=policy),
                      policy=dataclasses.replace(cfg.policy,
                                                 rnn_hidden_size=64))
    ppo = PPO(_graph_env(cuda), cfg)
    ppo.init(0)
    hidden0 = clone(ppo.hidden)
    traj = ppo.rollout()[0]
    inputs = (traj, ppo.obs, ppo.hidden, hidden0)
    held = ppo._held()
    start = [h.detach().clone() for h in held]
    gen0 = ppo.generator.get_state()
    eager = ppo._learn(*inputs).clone()
    want = ([h.detach().clone() for h in held], ppo.last_perm.clone(),
            ppo.generator.get_state())
    with torch.no_grad():
        for h, x in zip(held, start):
            h.copy_(x)
    ppo.generator.set_state(gen0)
    cap = ppo._learner(*inputs)
    assert isinstance(cap, CapturedLearn) and cap.graph is not None
    assert all(torch.equal(h, x) for h, x in zip(held, start))
    assert torch.equal(ppo.generator.get_state(), gen0)
    got = cap(*inputs)
    assert torch.equal(got, eager)
    assert all(torch.equal(a, b) for a, b in zip(held, want[0]))
    assert torch.equal(ppo.last_perm, want[1])
    assert torch.equal(ppo.generator.get_state(), want[2])
    assert not all(torch.equal(a, b) for a, b in zip(held, start))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["ActorCritic", "ActorCriticRecurrent"])
def test_sharded_captured_update_equals_eager_update(cuda, policy,
                                                     monkeypatch):
    """A ``ShardedPPO`` on an in-process world-1 NCCL mesh, 64 envs x 8
    steps, after one iteration: its learning half as ``learn_step`` replays
    it (``CapturedLearn``'s parts, the all_reduce between them) against
    the same call made eagerly from one state (``chip_smoke._hold_learner``):
    statistics, parameters, gradients, Adam's state, the lr, the
    permutation and the generator bit for bit, no host sync inside the
    parts."""
    import dataclasses

    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.parallel import mesh as M

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    cfg = PPOCfg()
    cfg = cfg.replace(runner=RunnerCfg(num_steps_per_env=8,
                                       policy_class_name=policy),
                      policy=dataclasses.replace(cfg.policy,
                                                 rnn_hidden_size=64))
    mesh = M.make_mesh("cuda", "nccl")
    try:
        env = _graph_env(cuda)
        env = NightmareV3Env(env.cfg, device=mesh.device, shard=mesh.shard)
        ppo = M.ShardedPPO(env, cfg, mesh)
        ppo.init(0)
        ppo.learn_step()  # captures the rollout step and the learning half
        held = smoke._hold_learner(ppo)
    finally:
        M.close()
    diffs = smoke._learner_diffs(held)
    assert all(v[0] for v in diffs.values()), diffs
    assert held["syncs"] == 0
    assert held["pool_bytes"] > 0
