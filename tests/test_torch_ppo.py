"""The port's actor-critic and PPO (nightmare_rl_tpu_torch/models, rl)
against the JAX package's.

- ``artifacts/model_3176.pt`` loaded on the JAX side through its own
  torch_io and on the port's side both with ``load_state_dict`` and through
  the carry-across function: forward passes agree to 1e-12 in float64.
- One PPO update on a fixed batch with the JAX side's permutation: GAE, the
  20 minibatch steps (clip by global norm, Adam, adaptive lr) and the
  resulting parameters agree to 1e-9 in float64 (summation order only),
  through the plain route and through the learn kernels' host drivers
  (ops/learn.py's host_gae, host_grads, host_adam: the kernels'
  arithmetic on the CPU).
- A CPU training iteration of the runner, its checkpoint and resume path.
"""

import os
import types
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nightmare_rl_tpu.core.config import PPOCfg as JPPOCfg
from nightmare_rl_tpu.models import actor_critic as jac
from nightmare_rl_tpu.rl.ppo import PPO as JPPO
from nightmare_rl_tpu.rl.ppo import TrainState, Transition as JTransition
from nightmare_rl_tpu.utils import torch_io as jtorch_io
from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models import actor_critic as tac
from nightmare_rl_tpu_torch.ops import learn as L
from nightmare_rl_tpu_torch.rl import ppo as tppo
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
from nightmare_rl_tpu_torch.utils.torch_io import actor_critic_state_from_jax

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "artifacts", "model_3176.pt")
TOL = 1e-9


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _port_net(params):
    net = tac.ActorCritic(66, 18).double()
    net.load_state_dict(actor_critic_state_from_jax(_np(params)))
    return net


def test_actor_critic_forward_on_model_3176():
    jnet = jac.ActorCritic(num_actions=18)
    tpl = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 66)))
    params = jtorch_io.load_pt(CKPT, tpl)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)
    obs = np.random.default_rng(0).normal(size=(16, 66))
    mu_j, std_j, v_j = jnet.apply(params, jnp.asarray(obs))

    sd = torch.load(CKPT, map_location="cpu", weights_only=True)["model_state_dict"]
    direct = tac.ActorCritic(66, 18)
    direct.load_state_dict(sd)
    carried = _port_net(params)
    for net in (direct.double(), carried):
        with torch.no_grad():
            mu, std, v = net(torch.from_numpy(obs))
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-12)
        np.testing.assert_allclose(std.detach().numpy(), np.asarray(std_j), rtol=0, atol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-12)
        np.testing.assert_allclose(net.act_inference(torch.from_numpy(obs)).detach(),
                                   np.asarray(mu_j), rtol=0, atol=1e-12)


def test_std_floor_clamps_sampling_std():
    net = tac.ActorCritic(66, 18, std_floor=0.25).double()
    with torch.no_grad():
        net.std.fill_(0.05)
    _, std, _ = net(torch.zeros(3, 66, dtype=torch.float64))
    assert float(std.detach().min()) == 0.25
    net.std_floor = 0.0
    _, std0, _ = net(torch.zeros(3, 66, dtype=torch.float64))
    assert float(std0.detach().max()) == 0.05


def test_distribution_functions_match():
    rng = np.random.default_rng(4)
    mu, mu2, a = (rng.normal(size=(5, 18)) for _ in range(3))
    std, std2 = (np.abs(rng.normal(size=(5, 18))) + 0.1 for _ in range(2))
    t = torch.from_numpy
    np.testing.assert_allclose(tac.log_prob(t(mu), t(std), t(a)).numpy(),
                               np.asarray(jac.log_prob(mu, std, a)), rtol=1e-13)
    np.testing.assert_allclose(tac.entropy(t(std)).numpy(),
                               np.asarray(jac.entropy(std)), rtol=1e-13)
    np.testing.assert_allclose(
        tac.gaussian_kl(t(mu), t(std), t(mu2), t(std2)).numpy(),
        np.asarray(jac.gaussian_kl(mu, std, mu2, std2)), rtol=1e-13)
    g = torch.Generator().manual_seed(0)
    x = tac.sample_action(t(mu), t(std), g)
    assert x.shape == (5, 18) and x.dtype == torch.float64


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(5)
    grads = [rng.normal(size=(7, 3)) * scale, rng.normal(size=(4,)) * scale]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape, dtype=torch.float64))
              for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    tppo.clip_by_global_norm(params, 1.0)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-14)


@pytest.fixture(scope="module")
def update_pair():
    """One PPO iteration's learning half on a fixed batch, both sides; the
    port's through the plain versions and through the learn kernels' host
    drivers (teams of 3, grads' grid of 2 blocks a net)."""
    T, N = 8, 16
    cfg = JPPOCfg()
    jppo = JPPO(types.SimpleNamespace(num_actions=18), cfg)
    key = jax.random.PRNGKey(3)
    params = jppo.net.init(key, jnp.zeros((1, 66)))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)

    rng = np.random.default_rng(6)
    obs = rng.normal(size=(T, N, 66))
    mu, std, value = jppo.net.apply(params, jnp.asarray(obs))
    action = mu + std * rng.normal(size=(T, N, 18))
    traj = JTransition(
        obs=jnp.asarray(obs), action=action,
        reward=jnp.asarray(rng.normal(size=(T, N))),
        done=jnp.asarray(rng.random((T, N)) < 0.1), value=value,
        logp=jac.log_prob(mu, std, action), mu=mu, sigma=std)
    last_value = jnp.asarray(rng.normal(size=N))
    adv_j, ret_j, nadv_j = jppo._gae(traj, last_value)
    ts = TrainState(params=params, opt_state=jppo.tx.init(params),
                    lr=jnp.asarray(cfg.algorithm.learning_rate, jnp.float64),
                    rng=jax.random.split(key, N), env_state=(), obs=None,
                    iteration=jnp.zeros((), jnp.int32))
    new_params, _, lr_j, _, stats_j = jppo._update(ts, traj, ret_j, nadv_j, ts.rng)
    perm = np.array(jax.random.permutation(
        jax.random.fold_in(ts.rng[0], 23), T * N))

    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64,
                                num_obs=66, num_actions=18)
    ttraj = tppo.Transition(*[torch.from_numpy(np.array(x)) for x in traj])

    def port():
        tp = tppo.PPO(env, PPOCfg())
        tp.net.load_state_dict(actor_critic_state_from_jax(_np(params)))
        gae = tp.gae(ttraj, torch.from_numpy(np.array(last_value)))
        return tp, gae, tp.update(ttraj, gae[1], gae[2], torch.from_numpy(perm))

    tp, gae_t, stats_t = port()
    with mock.patch.object(L, "gae", lambda *a: L.host_gae(*a, team=3)), \
            mock.patch.object(L, "grads", lambda *a: L.host_grads(
                *a, team=3, blocks=2)), \
            mock.patch.object(L, "adam", lambda *a: L.host_adam(*a, team=3)):
        th, gae_h, stats_h = port()
    return dict(gae_j=(adv_j, ret_j, nadv_j), gae_t=gae_t, gae_h=gae_h,
                params_j=new_params, net_t=tp.net, net_h=th.net,
                stats_j=stats_j, stats_t=stats_t, stats_h=stats_h, lr_j=lr_j)


def test_gae_matches(update_pair):
    for a, b in zip(update_pair["gae_j"], update_pair["gae_t"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)


def test_ppo_update_matches(update_pair):
    sj, st = update_pair["stats_j"], update_pair["stats_t"]
    for key in ("loss", "surrogate_loss", "value_loss", "kl", "lr"):
        np.testing.assert_allclose(st[key], float(sj[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    ref = actor_critic_state_from_jax(_np(update_pair["params_j"]))
    got = update_pair["net_t"].state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    # the update moved the parameters and the lr adapted from 1e-3
    assert st["lr"] != 1e-3


def test_gae_matches_host_route(update_pair):
    """GAE through the learn kernels' host driver against the JAX _gae."""
    for a, b in zip(update_pair["gae_j"], update_pair["gae_h"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)


def test_ppo_update_matches_host_route(update_pair):
    """The 20 minibatch steps through the grads and adam host drivers
    against the JAX _update: the statistics, the lr and every parameter."""
    sj, sh = update_pair["stats_j"], update_pair["stats_h"]
    for key in ("loss", "surrogate_loss", "value_loss", "kl", "lr"):
        np.testing.assert_allclose(sh[key], float(sj[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    ref = actor_critic_state_from_jax(_np(update_pair["params_j"]))
    got = update_pair["net_h"].state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert sh["lr"] != 1e-3


def test_runner_trains_saves_and_resumes(tmp_path):
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=4)),
                         device="cpu")
    cfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=4))
    runner = OnPolicyRunner(env, cfg, log_dir=str(tmp_path / "run"))
    runner.init(0)
    runner.learn(1, init_at_random_ep_len=True)
    assert np.isfinite(runner.last_stats["loss"])
    assert runner.ppo.iteration == 1
    path = get_load_path(str(tmp_path))
    assert path.endswith("model_1.pt")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert set(blob) == {"model_state_dict", "optimizer_state_dict", "iter",
                         "infos", "train_state"}
    assert "actor.6.weight" in blob["model_state_dict"]
    other = OnPolicyRunner(env, cfg)
    other.load(path)
    assert other.ppo.iteration == 1 and other.ppo.lr == runner.ppo.lr
    for a, b in zip(other.ppo.net.parameters(), runner.ppo.net.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kl_scale", [2.5, 0.25, 1.0, 0.0],
                         ids=["above-2x", "below-half", "inside", "zero"])
def test_adapt_lr_matches_jax(kl_scale):
    """The port's device-side adaptive rule (``torch.where`` on 0-dim
    tensors) against the JAX ``_adapt_lr``, float64: kl above twice the
    target, below half of it, inside the band and 0 (no change).
    Tolerance 0: the same divisions and products in float64."""
    cfg = JPPOCfg()
    a = cfg.algorithm
    jppo = JPPO(types.SimpleNamespace(num_actions=18), cfg)
    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64,
                                num_obs=66, num_actions=18)
    tp = tppo.PPO(env, PPOCfg())
    lr, kl = 3e-3, a.desired_kl * kl_scale
    want = float(jppo._adapt_lr(a, jnp.asarray(lr, jnp.float64),
                                jnp.asarray(kl, jnp.float64)))
    got = tp._adapt_lr(torch.tensor(lr, dtype=torch.float64),
                       torch.tensor(kl, dtype=torch.float64))
    assert got.shape == () and got.dtype == torch.float64
    assert float(got) == want
    assert (want != lr) == (kl_scale in (2.5, 0.25))


def _held_copy(ppo):
    return [x.detach().clone() for x in ppo._held()]


def test_captured_update_equals_update():
    """``CapturedLearn``, the PPO's learning half as ``learn_step`` calls it
    on the card (the prologue's three captured parts: V of the last
    observations and GAE's recursion, the sum of squares, the
    normalization and the permutation drawn from the PPO's generator; and
    a minibatch step's two captured parts replayed per minibatch), which
    the CPU runs eagerly on its buffers, against the same steps called one
    by one ending in ``PPO.update``, from two PPOs in one state, float64:
    the statistics, every parameter, Adam's state, the lr and the
    generator's state equal bit for bit (tolerance 0).  Every part's
    warm-up leaves the parameters, gradients, Adam's state, the lr and the
    generator as they were."""
    T, N = 8, 16
    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64,
                                num_obs=66, num_actions=18)
    pair = []
    for _ in range(2):
        tp = tppo.PPO(env, PPOCfg())
        tp.init_params(3)
        tp.generator.manual_seed(5)
        pair.append(tp)
    cap_ppo, ref = pair
    rng = np.random.default_rng(9)
    obs = torch.from_numpy(rng.normal(size=(T, N, 66)))
    with torch.no_grad():
        mu, std, value = ref.net(obs)
        action = mu + std * torch.from_numpy(rng.normal(size=(T, N, 18)))
        # clones: std is a view of the net's std parameter
        traj = tppo.Transition(*[x.detach().clone() for x in (
            obs, action, torch.from_numpy(rng.normal(size=(T, N))),
            torch.from_numpy(rng.random((T, N)) < 0.1), value,
            tac.log_prob(mu, std, action), mu, std)])
    last_obs = torch.from_numpy(rng.normal(size=(N, 66)))

    before, gen0 = _held_copy(cap_ppo), cap_ppo.generator.get_state()
    cap = tppo.CapturedLearn(cap_ppo, traj, last_obs, (), ())
    assert cap.graph is None  # the CPU runs the update eagerly
    assert torch.equal(cap_ppo.generator.get_state(), gen0)
    for part in cap.parts:
        part.warm_up([cap_ppo.generator])
    assert all(torch.equal(a, b) for a, b in zip(_held_copy(cap_ppo), before))
    assert torch.equal(cap_ppo.generator.get_state(), gen0)
    got = dict(zip(tppo.STAT_KEYS, cap(traj, last_obs, (), ()).tolist()))

    _, returns, norm_adv = ref.gae(traj, ref.last_value(last_obs, ()))
    want = ref.update(traj, returns, norm_adv, ref.draw_perm(T, N))
    assert got == want
    assert float(want["lr"]) != PPOCfg().algorithm.learning_rate
    assert all(torch.equal(a, b) for a, b in zip(_held_copy(cap_ppo),
                                                 _held_copy(ref)))
    assert not all(torch.equal(a, b) for a, b in zip(_held_copy(cap_ppo),
                                                     before))
    assert torch.equal(cap_ppo.generator.get_state(), ref.generator.get_state())


def test_checkpoint_resume_restores_tensor_lr(tmp_path):
    """A resume writes the saved learning rate and Adam's state into the
    PPO's own tensors (the ones a captured update holds): the lr tensor and
    every Adam tensor keep their storage and take the saved values; the
    file keeps rsl_rl's ``optimizer_state_dict`` with the lr a number."""
    from nightmare_rl_tpu_torch.utils import checkpoint

    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=4)),
                         device="cpu")
    cfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=4))
    ref = tppo.PPO(env, cfg)
    ref.init(0)
    ref.learn_step()
    ref.lr = 3.7e-4  # away from both the initial and any adapted value
    path = str(tmp_path / "model_1.pt")
    checkpoint.save(path, ref)
    blob = torch.load(path, weights_only=True)
    assert isinstance(blob["optimizer_state_dict"]["param_groups"][0]["lr"],
                      float)
    assert isinstance(blob["train_state"]["lr"], float)

    fresh = tppo.PPO(env, cfg)
    fresh.init(7)
    ptrs = [x.data_ptr() for x in fresh._held()]
    assert float(fresh.lr) != float(ref.lr)
    assert checkpoint.load(path, fresh) is True
    assert [x.data_ptr() for x in fresh._held()] == ptrs
    assert fresh.optimizer.param_groups[0]["lr"] is fresh.lr
    assert torch.equal(fresh.lr, ref.lr)
    for p, q in zip(fresh.params, ref.params):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.optimizer.state[p][k],
                               ref.optimizer.state[q][k]), k
