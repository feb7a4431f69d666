"""The rollout kernels' arithmetic (nightmare_rl_tpu_torch/ops/csrc/
rollout_env.cuh, run on the CPU by the host driver csrc/rollout_host.cpp)
against the plain versions (ops/rollout.py's plain_act and plain_store, the
rollout step's code), and the plain versions against the JAX package's
rollout step, in float64 on inputs made with numpy from a seed.

- act: the host driver's rows of obs, action, value, logp, mu and sigma
  (and the caller's action and value) within 1e-12 of each field's scale
  of the plain version's, obs and sigma equal, NaN where the plain version
  has NaN (an env's observation is NaN); for both robots' nets (66 -> 18
  and 48 -> 12 through [54, 42, 30] ELU), std_floor 0 and 0.4, the
  weights staged whole and in chunks (a small budget: several stages), 16,
  12 and 8 envs a block, teams of 1, 3 and 32 (the same bits at every team
  size); the recurrent heads (two inputs of their own).
- store: the reward and done rows, env 0's record row (recording on and
  off), t + 1, the episode count and the NaN-skipping term sums; the
  record row as rl/ppo.py's _record_to_host reads it.
- the JAX package: nightmare_rl_tpu/rl/ppo.py:153-185's arithmetic
  (``PPO._policy`` or the recurrent net's apply, ``sample_action``'s
  affine part with eps handed in, ``log_prob``, the timeout bootstrap)
  against plain_act and plain_store to 1e-10.
- A rollout step captured by PPO._rollout_stepper reads weights updated in
  place after its capture (on the CPU through the plain route's call
  path; chip_smoke.py's rollout-kernel phase holds the graph on the card),
  and its calls equal the plain step's bit for bit.
- plan() refuses the nets the kernels do not take; the counters count
  only kernel launches.

tests/test_torch_graph.py::test_rollout_equals_eager_loop holds the
rollout (through these functions) against an eager loop of PPO.act and
env.step bit for bit.
"""

import dataclasses
import importlib.util
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.core.config import PPOCfg as JPPOCfg
from nightmare_rl_tpu.models import actor_critic as jac
from nightmare_rl_tpu.rl.ppo import PPO as JPPO
from nightmare_rl_tpu_torch.models import actor_critic as tac
from nightmare_rl_tpu_torch.ops import rollout as R
from nightmare_rl_tpu_torch.rl import ppo as tppo
from nightmare_rl_tpu_torch.utils.torch_io import (
    actor_critic_recurrent_state_from_jax, actor_critic_state_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N, T, ROW = 40, 3, 1
TOL = 1e-12          # host driver against the plain version, float64
JAX_TOL = 1e-10      # plain version against the JAX package, float64
TEAMS = (1, 3, 32)
NETS = {"nightmare_v3": (66, 18, 25, 24), "anymal_c": (48, 12, 19, 18)}
GAMMA = 0.99


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _moved(params, seed):
    """Every leaf moved off its init (the zero biases included), std kept
    positive."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float64)
                              + 0.3 * rng.random(size=x.shape)), params)


def _nets(robot: str, floor: float, seed: int = 0):
    """A flax ActorCritic (float64, weights moved) and the port's net with
    its weights."""
    nobs, A = NETS[robot][:2]
    jnet = jac.ActorCritic(num_actions=A, std_floor=floor)
    params = _moved(jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, nobs))),
                    seed)
    net = tac.ActorCritic(nobs, A, std_floor=floor).double()
    net.load_state_dict(actor_critic_state_from_jax(_np(params)))
    return jnet, params, net


def _traj(nobs: int, A: int) -> tppo.Transition:
    def z(*shape, dtype=torch.float64):
        return torch.zeros(T, N, *shape, dtype=dtype)

    return tppo.Transition(z(nobs), z(A), z(), z(dtype=torch.bool), z(), z(),
                           z(A), z(A))


def _act_inputs(nobs: int, A: int, seed: int, nan_env: bool = True):
    rng = np.random.default_rng(seed)
    obs = torch.from_numpy(rng.normal(size=(N, nobs)))
    if nan_env:
        obs[5] = float("nan")
    eps = torch.from_numpy(rng.normal(size=(N, A)))
    return obs, eps


def _held(ref, got, exact: bool = False) -> None:
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert torch.equal(torch.isnan(ref), torch.isnan(got))
    ok = ~torch.isnan(ref)
    if exact:
        assert torch.equal(ref[ok], got[ok])
        return
    scale = max(1e-300, float(ref[ok].detach().abs().max()))
    assert float((ref[ok] - got[ok]).detach().abs().max()) <= TOL * scale


def _act_pair(pl, obs, x_a, x_c, eps, **host_kw):
    nobs, A = obs.shape[1], eps.shape[1]
    t = torch.tensor([ROW])
    ref_traj, got_traj = _traj(nobs, A), _traj(nobs, A)
    ref = R.plain_act(pl, obs, x_a, x_c, eps, ref_traj, t)
    got = R.host_act(pl, obs, x_a, x_c, eps, got_traj, t, **host_kw)
    return ref_traj, got_traj, ref, got


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("floor", [0.0, 0.4], ids=["no floor", "floor"])
@pytest.mark.parametrize("robot", list(NETS))
def test_host_act_matches_plain(robot, floor, team):
    """Row t of each field and the caller's action and value; the weights
    staged whole (16 envs a block) and in chunks (12 envs a block: a
    ragged last block; a budget of 700 elements); the other rows untouched."""
    _, _, net = _nets(robot, floor)
    pl = R.plan(net)
    obs, eps = _act_inputs(*NETS[robot][:2], seed=1)
    for kw in (dict(), dict(envs_per_block=12, budget=700)):
        with torch.no_grad():
            ref_traj, got_traj, ref, got = _act_pair(pl, obs, obs, obs, eps,
                                                     team=team, **kw)
        for name in R.ACT_ROWS:
            a, b = getattr(ref_traj, name), getattr(got_traj, name)
            _held(a[ROW], b[ROW], exact=name in ("obs", "sigma"))
            assert not b[ROW + 1].any() and not b[ROW - 1].any()
        _held(ref.action, got.action)
        _held(ref.value, got.value)
        assert got.mu is None and got.std is None and got.logp is None
    assert float(ref_traj.sigma[ROW].min()) >= floor


@pytest.mark.parametrize("robot", list(NETS))
def test_host_act_is_the_same_at_every_team_size(robot):
    """Without a trajectory: the five outputs, the same bits at teams of 1,
    3 and 32 and in chunks; against the plain version to 1e-12."""
    _, _, net = _nets(robot, 0.0, seed=2)
    pl = R.plan(net)
    obs, eps = _act_inputs(*NETS[robot][:2], seed=3)
    with torch.no_grad():
        ref = R.plain_act(pl, obs, obs, obs, eps)
        outs = [R.host_act(pl, obs, obs, obs, eps, team=team, budget=500,
                           envs_per_block=8) for team in TEAMS]
    for a, b in zip(ref, outs[0]):
        _held(a, b)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_host_act_recurrent_heads():
    """The recurrent net's MLPs on the two LSTMs' outputs (x_a, x_c of
    their own), the first layers staged in chunks."""
    net = tac.ActorCriticRecurrent(66, 18, rnn_hidden=32).double()
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1)
    pl = R.plan(net)
    rng = np.random.default_rng(4)
    obs, eps = _act_inputs(66, 18, seed=5, nan_env=False)
    x_a = torch.from_numpy(rng.normal(size=(N, 32)))
    x_c = torch.from_numpy(rng.normal(size=(N, 32)))
    for team in (1, 32):
        with torch.no_grad():
            ref_traj, got_traj, ref, got = _act_pair(
                pl, obs, x_a, x_c, eps, team=team, budget=300)
        for name in R.ACT_ROWS:
            _held(getattr(ref_traj, name)[ROW], getattr(got_traj, name)[ROW],
                  exact=name in ("obs", "sigma"))
        _held(ref.value, got.value)


def _store_inputs(robot: str, seed: int):
    nobs, A, nq, nv = NETS[robot]
    rng = np.random.default_rng(seed)
    nterms = 8
    f = torch.from_numpy

    time_out = f(rng.random(N) < 0.2)
    done = time_out | f(rng.random(N) < 0.2)
    finished = f(rng.normal(size=(N, nterms)))
    finished[~done] = float("nan")
    first = int(torch.nonzero(done)[0])
    finished[first, 3] = float("nan")  # a NaN term of a finished episode
    step = dict(reward=f(rng.normal(size=N)), time_out=time_out, done=done,
                value=f(rng.normal(size=N)), finished=finished,
                n_done=torch.tensor(5.0, dtype=torch.float64),
                term_sums=f(rng.normal(size=nterms)))
    record = (f(rng.normal(size=(N, nq))), f(rng.normal(size=(N, nv))),
              f(rng.normal(size=(N, A))), done, f(rng.normal(size=(N, 3))))
    return step, record, nq + nv + A + 1 + 3


@pytest.mark.parametrize("recording", [True, False], ids=["record", "none"])
@pytest.mark.parametrize("robot", list(NETS))
def test_host_store_matches_plain(robot, recording):
    """The reward and done rows, the record row, t + 1 and the episode
    count exact or within 1e-12 (reward, term sums), at teams of 1, 3 and
    32."""
    step, record, width = _store_inputs(robot, seed=6)
    nobs, A = NETS[robot][:2]
    t = torch.tensor([ROW])
    for team in TEAMS:
        ref_traj, got_traj = _traj(nobs, A), _traj(nobs, A)
        ref_rec = torch.zeros(T, width, dtype=torch.float64)
        got_rec = ref_rec.clone()
        kw = dict(rec=ref_rec, record=record) if recording else {}
        ref = R.plain_store(ref_traj, t, **step, gamma=GAMMA, **kw)
        if recording:
            kw["rec"] = got_rec
        got = R.host_store(got_traj, t, **step, gamma=GAMMA, team=team, **kw)
        _held(ref_traj.reward[ROW], got_traj.reward[ROW])
        assert torch.equal(ref_traj.done, got_traj.done)
        assert torch.equal(ref_rec, got_rec)
        assert torch.equal(ref[0], got[0]) and int(got[0]) == ROW + 1
        assert torch.equal(ref[1], got[1])
        _held(ref[2], got[2])
    assert int(got[1]) == 5 + int(step["done"].sum())
    assert not recording or bool(got_rec[ROW].any())


def test_store_record_row_is_what_record_to_host_reads():
    step, record, width = _store_inputs("nightmare_v3", seed=7)
    rec = torch.zeros(T, width, dtype=torch.float64)
    R.host_store(_traj(66, 18), torch.tensor([ROW]), **step, gamma=GAMMA,
                 rec=rec, record=record)
    cols = tppo._record_to_host(rec, (25, 24, 18, 1, 3))
    for got, want in zip(cols, record):
        np.testing.assert_array_equal(got[ROW], want[0].numpy())


def _jax_step(jppo, params, obs, eps, reward, time_out, recurrent_hidden=None):
    """nightmare_rl_tpu/rl/ppo.py:159-171 with eps handed in: the policy,
    sample_action's affine part, log_prob and the timeout bootstrap."""
    if recurrent_hidden is None:
        mu, std, value = jppo._policy(params, jnp.asarray(obs))
    else:
        (mu, std, value), _ = jppo.net.apply(params, jnp.asarray(obs),
                                             recurrent_hidden)
    action = mu + std * jnp.asarray(eps)
    logp = jac.log_prob(mu, std, action)
    r = jnp.asarray(reward) + GAMMA * value * jnp.asarray(time_out).astype(
        value.dtype)
    return [np.asarray(x) for x in (mu, std, value, action, logp, r)]


def _port_step(pl, obs, x_a, x_c, eps, reward, time_out):
    nobs, A = obs.shape[1], eps.shape[1]
    traj, t = _traj(nobs, A), torch.tensor([ROW])
    with torch.no_grad():
        R.plain_act(pl, obs, x_a, x_c, eps, traj, t)
        zeros = torch.zeros(N, 8, dtype=torch.float64)
        R.plain_store(traj, t, reward, time_out, time_out, traj.value[ROW],
                      zeros * float("nan"), torch.tensor(0.0,
                                                         dtype=torch.float64),
                      zeros[0], GAMMA)
    return [x[ROW].numpy() for x in (traj.mu, traj.sigma, traj.value,
                                     traj.action, traj.logp, traj.reward)]


@pytest.mark.parametrize("floor", [0.0, 0.4], ids=["no floor", "floor"])
@pytest.mark.parametrize("robot", list(NETS))
def test_plain_matches_jax_rollout_step(robot, floor):
    nobs, A = NETS[robot][:2]
    jnet, params, net = _nets(robot, floor, seed=8)
    cfg = JPPOCfg()
    cfg = cfg.replace(policy=dataclasses.replace(cfg.policy, std_floor=floor))
    jppo = JPPO(types.SimpleNamespace(num_actions=A), cfg)
    obs, eps = _act_inputs(nobs, A, seed=9, nan_env=False)
    rng = np.random.default_rng(10)
    reward = torch.from_numpy(rng.normal(size=N))
    time_out = torch.from_numpy(rng.random(N) < 0.3)
    want = _jax_step(jppo, params, obs.numpy(), eps.numpy(), reward.numpy(),
                     time_out.numpy())
    got = _port_step(R.plan(net), obs, obs, obs, eps, reward, time_out)
    for name, a, b in zip(("mu", "std", "value", "action", "logp", "reward"),
                          want, got):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=JAX_TOL * max(1.0, np.abs(a).max()),
                                   err_msg=name)


def test_plain_recurrent_matches_jax_rollout_step():
    """The recurrent net: its LSTMs' step (``ActorCriticRecurrent.memory``)
    then plain_act on their outputs, against the flax net's apply."""
    H = 24
    jnet = jac.ActorCriticRecurrent(num_actions=18, rnn_hidden=H)
    params = _moved(jnet.init(jax.random.PRNGKey(11), jnp.zeros((2, 66)),
                              jnet.initial_state(2)), 11)
    net = tac.ActorCriticRecurrent(66, 18, rnn_hidden=H).double()
    net.load_state_dict(actor_critic_recurrent_state_from_jax(_np(params)))
    rng = np.random.default_rng(12)
    fh = tuple((jnp.asarray(rng.normal(size=(N, H))),
                jnp.asarray(rng.normal(size=(N, H)))) for _ in range(2))
    th = tuple((torch.from_numpy(np.array(c[1])), torch.from_numpy(np.array(c[0])))
               for c in fh)
    obs, eps = _act_inputs(66, 18, seed=13, nan_env=False)
    reward = torch.from_numpy(rng.normal(size=N))
    time_out = torch.from_numpy(rng.random(N) < 0.3)
    jppo = types.SimpleNamespace(net=jnet)
    want = _jax_step(jppo, params, obs.numpy(), eps.numpy(), reward.numpy(),
                     time_out.numpy(), recurrent_hidden=fh)
    with torch.no_grad():
        (x_a, x_c), _ = net.memory(obs, th)
    got = _port_step(R.plan(net), obs, x_a, x_c, eps, reward, time_out)
    for name, a, b in zip(("mu", "std", "value", "action", "logp", "reward"),
                          want, got):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=JAX_TOL * max(1.0, np.abs(a).max()),
                                   err_msg=name)


def test_captured_step_reads_weights_updated_in_place():
    """PPO._rollout_stepper's step (CapturedStep, eager on the CPU): its
    calls equal the plain step's bit for bit, and a call after the weights
    and std were scaled in place reads them (mu equal to plain_act's on the
    new weights, sigma the new std)."""
    with torch.no_grad():
        ppo, state, obs, hidden = smoke._rollout_ppo("nightmare_v3", 16,
                                                     "fresh", device="cpu")
        rep = smoke._rollout_replays(ppo, state, obs, hidden)
    assert rep["same"] and rep["sigma"] and rep["moved"] > 1e-3, rep
    assert rep["mu"]["abs"] == 0.0, rep


def _mixed():
    net = tac.ActorCritic(66, 18)
    net.critic[1] = torch.nn.Tanh()
    return net


def _no_bias():
    net = tac.ActorCritic(66, 18)
    net.actor[0] = torch.nn.Linear(66, 54, bias=False)
    return net


@pytest.mark.parametrize("make, why", [
    (_mixed, "mixes the activations"),
    (_no_bias, "without a bias"),
    (lambda: tac.ActorCritic(66, 18, actor_hidden=(8,) * 8), "9 Linear"),
])
def test_plan_refuses_a_net_it_does_not_take(make, why):
    with pytest.raises(ValueError, match=why):
        R.plan(make())


def test_counts_only_kernel_launches_and_refuses_other_devices():
    _, _, net = _nets("anymal_c", 0.0)
    pl = R.plan(net)
    obs, eps = _act_inputs(48, 12, seed=14)
    step, record, width = _store_inputs("anymal_c", seed=15)
    before = R.act.launches, R.store.launches
    with torch.no_grad():
        R.act(pl, obs, obs, obs, eps)
    R.store(_traj(48, 12), torch.tensor([0]), **step, gamma=GAMMA)
    assert (R.act.launches, R.store.launches) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        R.act(pl, obs, obs, obs, eps.to("meta"))
    with pytest.raises(ValueError, match="host_act takes CPU tensors"):
        R.host_act(pl, obs, obs, obs, eps.to("meta"))
