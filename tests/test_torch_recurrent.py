"""The port's recurrent actor-critic and recurrent PPO against the JAX
package's (models/actor_critic.py ActorCriticRecurrent, rl/ppo.py
``PPO._update_recurrent``).

- The forward pass over a sequence with resets, flax weights carried
  across (``actor_critic_recurrent_state_from_jax``), float64: 1e-12.
- One recurrent update on a fixed batch with the JAX side's env
  permutation: GAE, the 20 minibatch steps over whole-env trajectories
  replayed from the rollout-start hidden state, and the resulting
  parameters agree to 1e-9 in float64.
- A recurrent learn step at 8 envs (rnn 32) leaves a nonzero hidden state
  (tests/test_ppo.py:36-48); the state dict has rsl_rl's keys; a checkpoint
  restores the hidden state and the run continues bit-identically.

The flax carry is (c, h); the port's is torch's (h, c).
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.core.config import PPOCfg as JPPOCfg
from nightmare_rl_tpu.core.config import PolicyCfg as JPolicyCfg
from nightmare_rl_tpu.core.config import RunnerCfg as JRunnerCfg
from nightmare_rl_tpu.models import actor_critic as jac
from nightmare_rl_tpu.rl.ppo import PPO as JPPO
from nightmare_rl_tpu.rl.ppo import TrainState, Transition as JTransition
from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PolicyCfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models import actor_critic as tac
from nightmare_rl_tpu_torch.rl import ppo as tppo
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
from nightmare_rl_tpu_torch.utils import checkpoint
from nightmare_rl_tpu_torch.utils.torch_io import (
    actor_critic_recurrent_state_from_jax,
)

TOL = 1e-9


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _port_hidden(flax_hidden):
    """flax ((cA, hA), (cC, hC)) → the port's ((hA, cA), (hC, cC))."""
    return tuple((torch.from_numpy(np.array(carry[1])),
                  torch.from_numpy(np.array(carry[0])))
                 for carry in flax_hidden)


def _flax_hidden(rng, N, H):
    return tuple((jnp.asarray(rng.normal(size=(N, H))),
                  jnp.asarray(rng.normal(size=(N, H)))) for _ in range(2))


def _jax_net(H, seed):
    """A flax ActorCriticRecurrent with float64 weights, every leaf (the
    zero-initialised biases included) moved off its init."""
    jnet = jac.ActorCriticRecurrent(num_actions=18, rnn_hidden=H)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((2, 66)),
                       jnet.initial_state(2))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float64)
                              + 0.05 * rng.normal(size=x.shape)), params)
    return jnet, params


def _port_net(params, H):
    net = tac.ActorCriticRecurrent(66, 18, rnn_hidden=H).double()
    net.load_state_dict(actor_critic_recurrent_state_from_jax(_np(params)))
    return net


def test_forward_matches_flax_over_a_sequence_with_resets():
    T, N, H = 6, 5, 24
    jnet, params = _jax_net(H, 1)
    net = _port_net(params, H)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(T, N, 66))
    done = rng.random((T, N)) < 0.3
    jh = _flax_hidden(rng, N, H)
    th = _port_hidden(jh)
    for t in range(T):
        (mu_j, std_j, v_j), jh = jnet.apply(params, jnp.asarray(obs[t]), jh)
        jh = jac.reset_hidden(jh, jnp.asarray(done[t]))
        with torch.no_grad():
            (mu, std, v), th = net(torch.from_numpy(obs[t]), th)
        th = tac.reset_hidden(th, torch.from_numpy(done[t]))
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(std.detach().numpy(), np.asarray(std_j))
        for a, b in zip(jax.tree_util.tree_leaves(_port_hidden(jh)),
                        jax.tree_util.tree_leaves(th)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-12)
    assert done.sum() >= T  # the sequence resets carries on the way


def test_state_dict_has_rsl_rl_keys():
    net = tac.ActorCriticRecurrent(66, 18, rnn_hidden=16)
    lstm = [f"memory_{s}.rnn.{w}_l0" for s in "ac"
            for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    mlp = [f"{m}.{i}.{w}" for m in ("actor", "critic") for i in (0, 2, 4, 6)
           for w in ("weight", "bias")]
    assert set(net.state_dict()) == {"std", *lstm, *mlp}
    assert net.memory_a.rnn.weight_ih_l0.shape == (64, 66)
    assert net.actor[0].weight.shape == (54, 16)
    # flax's init: zero biases, per-gate orthogonal recurrent kernels
    assert float(net.memory_c.rnn.bias_hh_l0.detach().abs().max()) == 0.0
    w = net.memory_a.rnn.weight_hh_l0.detach()[16:32]
    torch.testing.assert_close(w @ w.T, torch.eye(16), atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="single-layer"):
        tppo.PPO(types.SimpleNamespace(device=torch.device("cpu"),
                                       dtype=torch.float64, num_obs=66,
                                       num_actions=18),
                 PPOCfg(runner=RunnerCfg(
                     policy_class_name="ActorCriticRecurrent"),
                        policy=PolicyCfg(rnn_num_layers=2)))


@pytest.fixture(scope="module")
def update_pair():
    """One recurrent PPO iteration's learning half on a fixed batch, both
    sides, from a nonzero rollout-start hidden state."""
    T, N, H = 8, 16, 16
    jcfg = JPPOCfg().replace(
        runner=JRunnerCfg(policy_class_name="ActorCriticRecurrent"),
        policy=JPolicyCfg(rnn_hidden_size=H))
    jppo = JPPO(types.SimpleNamespace(num_actions=18), jcfg)
    assert jppo.recurrent
    _, params = _jax_net(H, 3)
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(T, N, 66))
    done = rng.random((T, N)) < 0.15
    h0 = _flax_hidden(rng, N, H)
    # the rollout's stored policy outputs, from h0 with the resets
    h, mus, stds, vals = h0, [], [], []
    for t in range(T):
        (mu, std, v), h = jppo.net.apply(params, jnp.asarray(obs[t]), h)
        h = jac.reset_hidden(h, jnp.asarray(done[t]))
        mus.append(mu), stds.append(std), vals.append(v)
    mu, std, value = (jnp.stack(x) for x in (mus, stds, vals))
    action = mu + std * rng.normal(size=(T, N, 18))
    traj = JTransition(
        obs=jnp.asarray(obs), action=action,
        reward=jnp.asarray(rng.normal(size=(T, N))),
        done=jnp.asarray(done), value=value,
        logp=jac.log_prob(mu, std, action), mu=mu, sigma=std)
    last_value = jnp.asarray(rng.normal(size=N))
    adv_j, ret_j, nadv_j = jppo._gae(traj, last_value)
    key = jax.random.PRNGKey(9)
    ts = TrainState(params=params, opt_state=jppo.tx.init(params),
                    lr=jnp.asarray(jcfg.algorithm.learning_rate, jnp.float64),
                    rng=jax.random.split(key, N), env_state=(), obs=None,
                    iteration=jnp.zeros((), jnp.int32), hidden=h0)
    new_params, _, _, _, stats_j = jppo._update(ts, traj, ret_j, nadv_j,
                                                ts.rng)
    perm = np.array(jax.random.permutation(
        jax.random.fold_in(ts.rng[0], 23), N))

    env = types.SimpleNamespace(device=torch.device("cpu"), dtype=torch.float64,
                                num_obs=66, num_actions=18)
    tp = tppo.PPO(env, PPOCfg(runner=RunnerCfg(
        policy_class_name="ActorCriticRecurrent"),
        policy=PolicyCfg(rnn_hidden_size=H)))
    assert tp.recurrent
    tp.net.load_state_dict(actor_critic_recurrent_state_from_jax(_np(params)))
    ttraj = tppo.Transition(*[torch.from_numpy(np.array(x)) for x in traj])
    adv_t, ret_t, nadv_t = tp.gae(ttraj, torch.from_numpy(np.array(last_value)))
    stats_t = tp.update(ttraj, ret_t, nadv_t, torch.from_numpy(perm),
                        _port_hidden(h0))
    return dict(gae_j=(adv_j, ret_j, nadv_j), gae_t=(adv_t, ret_t, nadv_t),
                params_j=new_params, net_t=tp.net, stats_j=stats_j,
                stats_t=stats_t)


def test_recurrent_gae_matches(update_pair):
    for a, b in zip(update_pair["gae_j"], update_pair["gae_t"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)


def test_recurrent_update_matches(update_pair):
    sj, st = update_pair["stats_j"], update_pair["stats_t"]
    for key in ("loss", "surrogate_loss", "value_loss", "kl", "lr"):
        np.testing.assert_allclose(st[key], float(sj[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    ref = actor_critic_recurrent_state_from_jax(_np(update_pair["params_j"]))
    got = update_pair["net_t"].state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert st["lr"] != 1e-3


CFG = PPOCfg(runner=RunnerCfg(num_steps_per_env=8,
                              policy_class_name="ActorCriticRecurrent"),
             policy=PolicyCfg(rnn_hidden_size=32))


def _env():
    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(
        num_envs=8, episode_length_s=0.05)), device="cpu")


def test_recurrent_learn_step():
    ppo = tppo.PPO(_env(), CFG)
    ppo.init(0)
    assert all(float(x.abs().max()) == 0 for c in ppo.hidden for x in c)
    stats = ppo.learn_step()
    assert np.isfinite(stats["loss"]) and ppo.iteration == 1
    assert 0.99e-5 <= stats["lr"] <= 1.01e-2
    assert stats["dones"] > 0  # the short episodes reset the carries
    for carry in ppo.hidden:
        for x in carry:
            assert x.shape == (8, 32) and float(x.abs().max()) > 0


def test_lstm_runs_without_tf32():
    """torch lets cuDNN's LSTM use TF32 by default: the port turns TF32 off
    around every LSTM call and every backward pass through it, whatever the
    caller's flags, and restores the flags afterwards."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    ppo = tppo.PPO(_env(), CFG)
    ppo.init(0)
    seen = []

    def record(tag):
        seen.append((tag, cudnn.allow_tf32, matmul.allow_tf32))

    def on_forward(module, inputs, out):
        record("forward")
        if out[0].requires_grad:
            out[0].register_hook(lambda grad: record("backward"))

    hooks = [m.rnn.register_forward_hook(on_forward)
             for m in (ppo.net.memory_a, ppo.net.memory_c)]
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        ppo.learn_step()
        after = cudnn.allow_tf32, matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
        for h in hooks:
            h.remove()
    assert {tag for tag, _, _ in seen} == {"forward", "backward"}
    assert not any(c or m for _, c, m in seen), seen
    assert after == (True, True)


def test_recurrent_checkpoint_round_trip(tmp_path):
    cfg = CFG.replace(runner=dataclasses.replace(CFG.runner,
                                                 num_steps_per_env=4))
    ref = OnPolicyRunner(_env(), cfg, log_dir=str(tmp_path / "a"))
    ref.init(0)
    ref.learn(1, init_at_random_ep_len=True)
    path = get_load_path(str(tmp_path))
    hid = torch.load(path, weights_only=True)["train_state"]["hidden"]
    assert torch.equal(hid["critic"]["c"], ref.ppo.hidden[1][1])
    ref.learn(1)

    resumed = OnPolicyRunner(_env(), cfg)
    resumed.init(7)
    assert resumed.load(path) is True
    resumed.learn(1)
    a, b = (checkpoint.state_items(r.ppo) for r in (ref, resumed))
    assert a.keys() == b.keys() and "hidden.actor.h" in a
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                else a[k] == b[k]), k
    assert ref.last_stats["loss"] == resumed.last_stats["loss"]
