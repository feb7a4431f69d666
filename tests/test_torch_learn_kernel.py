"""The learn kernels' arithmetic (nightmare_rl_tpu_torch/ops/csrc/
learn_env.cuh, run on the CPU by the host driver csrc/learn_host.cpp)
against the plain versions (ops/learn.py's plain_gae, plain_grads and
plain_adam, the update's code), in float64 on inputs made with numpy from
a seed, within 1e-12 of each field's scale, and the same bits at team
sizes 1, 3, 5 and 32.

- gae: the advantages, returns and mean advantage; episodes done at t = 0
  and at t = T-1, envs over two blocks; in float32 the advantages and
  returns equal the plain version's bit for bit (each product and sum
  rounded as its ops round them).
- grads: every gradient in the flat buffer, the KL and the losses, on a
  minibatch that ends in a partial tile, over several blocks and groups:
  the nightmare_v3 net and a small net whose actor and critic differ in
  depth; ratios on both sides of the clip band with advantages of both
  signs, values on both sides of the value clip, the std floor holding
  some actions, the unclipped value loss, other activations; every net on
  the tile's edges (a minibatch below one tile of ``L.TILE`` samples, of
  exactly one, of two and a partial one) over 1, 2 and 5 blocks a net
  (more blocks than tiles: the grid takes one a tile) at every team size.
- adam: the parameters, Adam's moments and step counts, the lr, the
  clipped gradients and the statistics; the KL above twice the target,
  below half of it, inside the band and 0, the fixed schedule; a norm
  below and above max_grad_norm; world 2's mean; a net with a tensor of
  several chunks (a ragged last one) beside tensors smaller than a chunk,
  and the recurrent net at a narrow width; over one block a chunk and 1, 2
  and 5 blocks, the same bits at every block count and team size.
- the refusals and the counters; the wrapper imports nothing of JAX.

tests/test_torch_ppo.py holds the whole update through these host drivers
against the JAX package's _gae and _update.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.models import actor_critic as tac
from nightmare_rl_tpu_torch.ops import learn as L
from nightmare_rl_tpu_torch.ops import rollout as R
from nightmare_rl_tpu_torch.rl import ppo as tppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12          # host driver against the plain version, float64
TEAMS = (1, 3, 5, 32)
T, N = 6, 32
ALGO = PPOCfg().algorithm
# (num_obs, num_actions, actor hidden, critic hidden, activation, floor,
# clipped value loss)
NETS = {
    "nightmare_v3": (66, 18, (54, 42, 30), (54, 42, 30), "elu", 0.0, True),
    "small-floor": (12, 5, (10, 7), (9,), "elu", 0.6, True),
    "small-unclipped": (12, 5, (10, 7), (9,), "elu", 0.0, False),
    "small-tanh": (12, 5, (6,), (8, 5, 4), "tanh", 0.0, True),
    "small-lrelu": (12, 5, (7, 7), (3,), "lrelu", 0.0, True),
}


def _close(ref, got, tol=TOL):
    scale = max(float(ref.abs().max()), 1e-300)
    return float((got - ref).abs().max()) <= tol * scale


# ---------------------------------------------------------------------------
# gae
# ---------------------------------------------------------------------------


def _gae_inputs(n, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    done = rng.random((T, n)) < 0.2
    done[0, 0] = done[T - 1, 1] = True
    x = [torch.from_numpy(rng.normal(size=s)).to(dtype)
         for s in ((T, n), (T, n), (n,))]
    return x[0], x[1], torch.from_numpy(done), x[2]


@pytest.mark.parametrize("team", TEAMS)
def test_host_gae_matches_plain(team):
    args = _gae_inputs(300, seed=1)  # two blocks of 256 envs
    ref = L.plain_gae(*args, ALGO.gamma, ALGO.lam)
    got = L.host_gae(*args, ALGO.gamma, ALGO.lam, team=team)
    for a, b in zip(ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _close(a, b)
    one = L.host_gae(*args, ALGO.gamma, ALGO.lam, team=1)
    assert all(torch.equal(a, b) for a, b in zip(one, got))


def test_host_gae_float32_rounds_as_the_plain_ops():
    args = _gae_inputs(N, seed=2, dtype=torch.float32)
    ref = L.plain_gae(*args, ALGO.gamma, ALGO.lam)
    got = L.host_gae(*args, ALGO.gamma, ALGO.lam, team=3)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    assert abs(float(ref[2] - got[2])) <= 1e-6 * float(ref[0].abs().max())


# ---------------------------------------------------------------------------
# grads
# ---------------------------------------------------------------------------


def _ppo(name, dtype=torch.float64, seed=3, **algo):
    nobs, A, ah, ch, act, floor, clipped = {**NETS, **ADAM_NETS}[name]
    cfg = PPOCfg()
    cfg = cfg.replace(
        policy=dataclasses.replace(cfg.policy, actor_hidden_dims=list(ah),
                                   critic_hidden_dims=list(ch),
                                   activation=act, std_floor=floor,
                                   rnn_hidden_size=RNN_HIDDEN),
        algorithm=dataclasses.replace(cfg.algorithm,
                                      use_clipped_value_loss=clipped, **algo))
    if name == "recurrent":
        cfg = cfg.replace(runner=dataclasses.replace(
            cfg.runner, policy_class_name="ActorCriticRecurrent"))
    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=dtype,
                                num_obs=nobs, num_actions=A)
    p = tppo.PPO(env, cfg)
    p.init_params(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        # every parameter off its init (the zero biases included); the std
        # around the floor where there is one
        for q in p.params:
            q.add_(torch.from_numpy(0.2 * rng.normal(size=q.shape)))
        p.net.std.copy_(torch.from_numpy(0.3 + rng.random(A)) if floor == 0
                        else torch.from_numpy(floor + rng.normal(
                            scale=0.2, size=A)))
    return p


def _batch(p, seed):
    """A trajectory (T, N) from the net's own outputs moved off them, so
    that ratios and values fall on both sides of their clips, and the
    returns and normalized advantages."""
    rng = np.random.default_rng(seed)
    nobs, A = p.env.num_obs, p.env.num_actions
    t = lambda *s: torch.from_numpy(rng.normal(size=s))  # noqa: E731
    obs = t(T, N, nobs)
    with torch.no_grad():
        mu, std, value = p.net(obs)
        action = mu + std * t(T, N, A)
        logp = tac.log_prob(mu, std, action) + 0.5 * t(T, N)
        traj = tppo.Transition(*[x.detach().clone() for x in (
            obs, action, t(T, N), torch.from_numpy(rng.random((T, N)) < 0.1),
            value + 0.4 * t(T, N), logp, mu + 0.1 * t(T, N, A),
            std * (1 + 0.2 * torch.from_numpy(rng.random((T, N, A)))))])
    return traj, value + 0.5 * t(T, N), t(T, N)


def _grads_case(name, seed=4, B=L.TILE + 36):
    """A PPO and a minibatch of B samples (by default a full tile and a
    partial one)."""
    p = _ppo(name)
    traj, ret, adv = _batch(p, seed)
    idx = torch.from_numpy(np.random.default_rng(seed).permutation(T * N)[:B])
    return p, (traj, ret, adv, idx)


def _branches(p, traj, ret, adv, idx):
    """Which branches of the losses the minibatch reaches."""
    a = p.cfg.algorithm
    mb, mb_ret, mb_adv = L._gathered(traj, ret, adv, idx)
    with torch.no_grad():
        mu, std, value = p.net(mb.obs)
        ratio = torch.exp(tac.log_prob(mu, std, mb.action) - mb.logp)
    dv = value - mb.value
    return dict(
        ratio_hi=bool(((ratio > 1 + a.clip_param) & (mb_adv > 0)).any()),
        ratio_hi_neg=bool(((ratio > 1 + a.clip_param) & (mb_adv < 0)).any()),
        ratio_lo=bool(((ratio < 1 - a.clip_param) & (mb_adv < 0)).any()),
        ratio_in=bool(((ratio - 1).abs() < a.clip_param).any()),
        value_out=bool((dv.abs() > a.clip_param).any()),
        value_in=bool((dv.abs() < a.clip_param).any()),
        floor=bool((p.net.std < p.net.std_floor).any()))


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("name", list(NETS))
def test_host_grads_matches_plain(name, team):
    p, batch = _grads_case(name)
    hit = _branches(p, *batch)
    assert all(v for k, v in hit.items() if k != "floor"), hit
    assert hit["floor"] == (NETS[name][5] > 0)
    ref = L.plain_grads(p.act_plan, p.cfg.algorithm, *batch, p._flat)
    want = p._flat.clone()
    p._flat.fill_(7.0)
    got = L.host_grads(p.act_plan, p.cfg.algorithm, *batch, p._flat,
                       team=team, blocks=2)
    assert torch.all(p._flat != 7.0)  # every element written
    i = 0
    for q in p.params:
        n = q.numel()
        assert _close(want[i:i + n], p._flat[i:i + n]), i
        i += n
    assert _close(want[-1:], p._flat[-1:]) and float(want[-1]) > 0
    assert _close(ref, got)
    if NETS[name][5] > 0:
        held = p.net.std < p.net.std_floor
        assert torch.all(p.net.std.grad[held] == 0)


@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_host_grads_is_the_same_at_every_team_size(blocks):
    """Teams of 1, 3, 5 and 32, the grid's sums over 1, 2 and 5 blocks a
    net (5 asked on 3 tiles: 3 blocks, groups of 2 and 1)."""
    p, batch = _grads_case("nightmare_v3", seed=5, B=2 * L.TILE + 22)
    outs = []
    for team in TEAMS:
        got = L.host_grads(p.act_plan, p.cfg.algorithm, *batch, p._flat,
                           team=team, blocks=blocks)
        outs.append((got.clone(), p._flat.clone()))
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
    geo = L.grads_geometry(p.act_plan, 2 * L.TILE + 22, blocks)
    assert (geo["blocks"], geo["groups"]) == ((3, 2) if blocks == 5
                                              else (blocks, 1))


# minibatch sizes at the edges of grads' tile: below one tile, exactly one,
# two full tiles and a partial one (T * N = 192 rows to draw from)
TILE_EDGES = {"below-one": L.TILE - 14, "one": L.TILE,
              "ragged": 2 * L.TILE + 22}


@pytest.mark.parametrize("blocks", [1, 2, 5])
@pytest.mark.parametrize("edge", list(TILE_EDGES))
@pytest.mark.parametrize("name", list(NETS))
def test_host_grads_at_the_tile_edges(name, edge, blocks):
    """Each net on each tile edge over 1, 2 and 5 blocks a net (more
    blocks than tiles: one a tile) at every team size in TEAMS: every
    gradient tensor, the KL and the losses within TOL of the plain
    version, every element written, the same bits at every team size."""
    B = TILE_EDGES[edge]
    p, batch = _grads_case(name, seed=8, B=B)
    ref = L.plain_grads(p.act_plan, p.cfg.algorithm, *batch, p._flat)
    want = p._flat.clone()
    tiles = -(-B // L.TILE)
    assert L.grads_geometry(p.act_plan, B, blocks)["blocks"] == min(blocks,
                                                                    tiles)
    outs = []
    for team in TEAMS:
        p._flat.fill_(7.0)
        got = L.host_grads(p.act_plan, p.cfg.algorithm, *batch, p._flat,
                           team=team, blocks=blocks)
        assert torch.all(p._flat != 7.0)
        i = 0
        for q in p.params:
            n = q.numel()
            assert _close(want[i:i + n], p._flat[i:i + n]), (team, i)
            i += n
        assert _close(want[-1:], p._flat[-1:]) and _close(ref, got), team
        outs.append((got.clone(), p._flat.clone()))
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))


@pytest.mark.parametrize("name,alpha", [("nightmare_v3", -0.7),
                                        ("small-lrelu", -0.3)])
def test_host_grads_with_a_negative_alpha(name, alpha):
    """ELU's and LeakyReLU's parameter below 0, where the activation's
    output is above 0 on both sides of z = 0 (grads keeps z's signs): within
    TOL of the plain version over a full tile and a partial one, the same
    bits at every team size."""
    p, batch = _grads_case(name, seed=9)
    for m in p.net.modules():
        if isinstance(m, torch.nn.ELU):
            m.alpha = alpha
        elif isinstance(m, torch.nn.LeakyReLU):
            m.negative_slope = alpha
    pl = R.plan(p.net)
    assert pl.alpha == alpha
    ref = L.plain_grads(pl, p.cfg.algorithm, *batch, p._flat)
    want = p._flat.clone()
    outs = []
    for team in TEAMS:
        p._flat.fill_(7.0)
        got = L.host_grads(pl, p.cfg.algorithm, *batch, p._flat, team=team,
                           blocks=2)
        i = 0
        for q in p.params:
            n = q.numel()
            assert _close(want[i:i + n], p._flat[i:i + n]), (team, i)
            i += n
        assert _close(want[-1:], p._flat[-1:]) and _close(ref, got), team
        outs.append((got.clone(), p._flat.clone()))
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))


def test_grads_refuses_what_it_does_not_take():
    """A net the rollout plan refuses (mixed activations, a Linear layer
    without a bias) raises on the CPU as on the card; so does the
    recurrent net's (its MLPs read the LSTMs), and a flat buffer that the
    gradients do not tile, for grads and for adam."""
    mixed = tac.ActorCritic(66, 18)
    mixed.actor[1] = torch.nn.ReLU()
    bare = tac.ActorCritic(66, 18)
    bare.critic[0] = torch.nn.Linear(66, 54, bias=False)
    for net, why in ((mixed, "mixes the activations"), (bare, "without a bias")):
        with pytest.raises(ValueError, match=why):
            R.plan(net)
    p, batch = _grads_case("small-floor")
    rnn = tac.ActorCriticRecurrent(12, 5, rnn_hidden=8).double()
    with pytest.raises(ValueError, match="observations"):
        L.host_grads(R.plan(rnn), p.cfg.algorithm, *batch, p._flat)
    wider = torch.zeros(p._flat.numel() + 1, dtype=p._flat.dtype)
    with pytest.raises(ValueError, match="does not write|not a view"):
        L.host_grads(p.act_plan, p.cfg.algorithm, *batch, wider)
    # adam: gradients that leave an element of the flat buffer out
    i = 0
    for q in p.params:
        q.grad = wider[i:i + q.numel()].view_as(q)
        i += q.numel()
    with pytest.raises(ValueError, match="does not step"):
        L.host_adam(p.optimizer, wider, p.lr, 1, p.cfg.algorithm,
                    torch.zeros(3, dtype=wider.dtype))


# ---------------------------------------------------------------------------
# adam
# ---------------------------------------------------------------------------

# adam's nets beside NETS' nightmare_v3 (17 tensors): "wide", whose first
# actor weight takes several chunks of L.ADAM_CHUNK elements and a ragged
# last one, beside tensors smaller than a chunk; and "recurrent",
# ActorCriticRecurrent with LSTMs of RNN_HIDDEN units (23 trained tensors:
# the LSTMs' bias_ih stays frozen), whose LSTM weights take several chunks
# each at flat offsets of 2 (mod 4).
RNN_HIDDEN = 48
ADAM_NETS = {
    "wide": (66, 18, (130, 7), (9,), "elu", 0.0, True),
    "recurrent": (66, 18, (54, 42, 30), (54, 42, 30), "elu", 0.0, True),
}
# (the KL as a multiple of the target, the gradients' scale, the world,
# the schedule, the net)
ADAM_CASES = {
    "kl-above-2x": (2.5, 1e-3, 1, "adaptive", "nightmare_v3"),
    "kl-below-half": (0.25, 1e-3, 1, "adaptive", "nightmare_v3"),
    "kl-inside": (1.0, 1e-3, 1, "adaptive", "nightmare_v3"),
    "kl-zero": (0.0, 1e-3, 1, "adaptive", "nightmare_v3"),
    "norm-above": (1.0, 10.0, 1, "adaptive", "nightmare_v3"),
    "world-2": (2.5, 10.0, 2, "adaptive", "nightmare_v3"),
    "fixed": (2.5, 10.0, 1, "fixed", "nightmare_v3"),
    "chunks": (0.25, 10.0, 2, "adaptive", "wide"),
    "recurrent": (1.0, 1e-3, 1, "adaptive", "recurrent"),
}
ADAM_BLOCKS = (None, 1, 2, 5)  # None: one block a chunk, the card's grid


def _adam_case(case, seed=6):
    kl_scale, g_scale, world, schedule, net = ADAM_CASES[case]
    p = _ppo(net, seed=seed, schedule=schedule)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        # a few steps in: moments and step counts away from their start
        for st in p.optimizer.state.values():
            st["step"].fill_(3.0)
            st["exp_avg"].copy_(torch.from_numpy(
                1e-3 * rng.normal(size=st["exp_avg"].shape)))
            st["exp_avg_sq"].copy_(torch.from_numpy(
                1e-5 * rng.random(size=st["exp_avg_sq"].shape)))
        p._flat.copy_(torch.from_numpy(
            g_scale * rng.normal(size=p._flat.shape)) * world)
        p._flat[-1] = ALGO.desired_kl * kl_scale * world
        p.lr = 3e-3
    losses = torch.from_numpy(rng.normal(size=3))
    return p, world, losses


def _adam_state(p, stats):
    return ([x.detach().clone() for x in p._held()]
            + [p._flat.clone(), stats.clone()])


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_host_adam_matches_plain(case, team):
    """Every field within TOL of the plain step (the step counts and the
    lr exact) over one block a chunk and over 1, 2 and 5 blocks (a block
    takes every blocks-th chunk), the same bits at each block count and
    team size as at one block a chunk with a team of one."""
    ref_p, world, losses = _adam_case(case)
    norm = float(torch.linalg.vector_norm(ref_p._flat[:-1])) / world
    assert (norm > ALGO.max_grad_norm) == (case in ("norm-above", "world-2",
                                                     "fixed", "chunks"))
    numels = [q.numel() for q in ref_p.params]
    if case in ("chunks", "recurrent"):
        # a tensor over several chunks ending in a ragged one, beside
        # tensors smaller than a chunk
        assert any(n > 2 * L.ADAM_CHUNK and n % L.ADAM_CHUNK for n in numels)
        assert any(n < L.ADAM_CHUNK for n in numels)
    assert case != "recurrent" or len(numels) == 23
    lr0 = float(ref_p.lr)
    ref = _adam_state(ref_p, L.plain_adam(ref_p.optimizer, ref_p._flat,
                                          ref_p.lr, world,
                                          ref_p.cfg.algorithm, losses))
    moved = float(ref_p.lr) != lr0
    assert moved == (case in ("kl-above-2x", "kl-below-half", "world-2",
                              "chunks"))
    assert torch.equal(ref[-1][:3], losses)
    one_p, _, _ = _adam_case(case)
    one = _adam_state(one_p, L.host_adam(one_p.optimizer, one_p._flat,
                                         one_p.lr, world, one_p.cfg.algorithm,
                                         losses, team=1))
    for blocks in ADAM_BLOCKS:
        got_p, _, _ = _adam_case(case)
        got = _adam_state(got_p, L.host_adam(
            got_p.optimizer, got_p._flat, got_p.lr, world,
            got_p.cfg.algorithm, losses, team=team, blocks=blocks))
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype
            if a.dtype == torch.float32 or a.dim() == 0:  # steps and the lr
                assert torch.equal(a, b), blocks
            else:
                assert _close(a, b), blocks
        assert all(torch.equal(a, b) for a, b in zip(one, got)), blocks


def test_adam_keeps_the_optimizer_state_dict():
    """After the host driver's step, Adam's ``state_dict`` (rsl_rl's
    ``optimizer_state_dict``) is the plain step's: the step counts float32
    tensors one higher."""
    ref_p, world, losses = _adam_case("kl-inside")
    got_p, _, _ = _adam_case("kl-inside")
    L.plain_adam(ref_p.optimizer, ref_p._flat, ref_p.lr, world,
                 ref_p.cfg.algorithm, losses)
    L.host_adam(got_p.optimizer, got_p._flat, got_p.lr, world,
                got_p.cfg.algorithm, losses)
    a, b = ref_p.optimizer_state(), got_p.optimizer_state()
    assert a["param_groups"] == b["param_groups"]
    for k, st in a["state"].items():
        assert float(st["step"]) == 4.0 and st["step"].dtype == torch.float32
        assert torch.equal(st["step"], b["state"][k]["step"])


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_counts_only_kernel_launches_and_refuses_other_devices():
    p, batch = _grads_case("small-floor")
    args = _gae_inputs(N, seed=7)
    before = (L.gae.launches, L.grads.launches, L.adam.launches)
    L.gae(*args, ALGO.gamma, ALGO.lam)
    losses = L.grads(p.act_plan, p.cfg.algorithm, *batch, p._flat)
    L.adam(p.optimizer, p._flat, p.lr, 1, p.cfg.algorithm, losses)
    assert (L.gae.launches, L.grads.launches, L.adam.launches) == before
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        L.gae(*meta, ALGO.gamma, ALGO.lam)
    with pytest.raises(ValueError, match="host_gae takes CPU tensors"):
        L.host_gae(*meta, ALGO.gamma, ALGO.lam)
    with pytest.raises(ValueError, match="teams of 1 to 64"):
        L.host_gae(*args, ALGO.gamma, ALGO.lam, team=65)


def test_wrapper_imports_nothing_of_jax():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.ops.learn\n"
            "import nightmare_rl_tpu_torch.rl.ppo\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nightmare_rl_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
