"""``PPO.init(seed)`` and ``ExternalPPO.init(seed, obs0)`` fix the train
state from the seed alone, as the JAX package's ``init`` builds params,
Adam state, lr and iteration from ``PRNGKey(seed)``: one seed gives equal
weights whatever torch's global RNG did before, two seeds give different
ones, and Adam's state, the learning rate and the iteration count start
afresh.  (Bit-equality with JAX's PRNG is not sought: tests that compare
with the JAX package copy the weights across.)"""

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PolicyCfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.external import ExternalPPO
from nightmare_rl_tpu_torch.rl.ppo import PPO

FF = PPOCfg(runner=RunnerCfg(num_steps_per_env=2))
RNN = PPOCfg(runner=RunnerCfg(num_steps_per_env=2,
                              policy_class_name="ActorCriticRecurrent"),
             policy=PolicyCfg(rnn_hidden_size=16))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests step a few envs, and the suite's
    workers share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _env():
    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=4)),
                          device="cpu")


def _weights(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _fresh_adam(ppo) -> bool:
    """Adam's state as a fresh optimizer's: every step count 0 and every
    moment zero (the port makes the state with the optimizer and resets it
    in place, so that a captured update keeps its tensors)."""
    states = [ppo.optimizer.state[p] for p in ppo.params]
    return bool(states) and all(
        set(st) == {"step", "exp_avg", "exp_avg_sq"}
        and not any(bool(x.any()) for x in st.values()) for st in states)


def _distinct(a, b):
    """Every randomly drawn tensor differs (zero biases and the std do not)."""
    drawn = [k for k in a if k.endswith("weight") or "weight_" in k]
    return bool(drawn) and all(not torch.equal(a[k], b[k]) for k in drawn)


@pytest.mark.parametrize("cfg", [FF, RNN], ids=["feed-forward", "recurrent"])
def test_ppo_init_fixes_the_weights(cfg):
    ppo = PPO(_env(), cfg)
    torch.manual_seed(123)
    ppo.init(1)
    w1 = _weights(ppo.net)
    lr0 = ppo.lr.clone()
    ppo.learn_step()                 # moves weights, Adam state, lr, iteration
    assert ppo.iteration == 1 and not _fresh_adam(ppo)
    assert not _equal(w1, _weights(ppo.net))

    torch.manual_seed(456)           # another global RNG state
    torch.rand(17)
    ppo.init(1)
    assert _equal(w1, _weights(ppo.net))
    assert ppo.iteration == 0 and ppo.lr == lr0 == cfg.algorithm.learning_rate
    assert _fresh_adam(ppo)
    assert all(g["lr"] is ppo.lr for g in ppo.optimizer.param_groups)

    other = PPO(_env(), cfg)         # a second instance, same seed
    other.init(1)
    assert _equal(w1, _weights(other.net))
    other.init(2)
    assert _distinct(w1, _weights(other.net))


def test_external_init_fixes_the_weights():
    env = _env()
    _, obs0 = env.reset(0)
    obs0 = obs0.numpy()
    ext = ExternalPPO(env.num_obs, env.num_actions, 4, FF, device="cpu")
    torch.manual_seed(7)
    ext.init(1, obs0)
    w1 = _weights(ext.ppo.net)
    ext.ppo.lr = 5e-3
    ext.ppo.iteration = 9
    torch.manual_seed(8)
    ext.init(1, obs0)
    assert _equal(w1, _weights(ext.ppo.net))
    assert ext.ppo.lr == FF.algorithm.learning_rate and ext.ppo.iteration == 0
    assert _fresh_adam(ext.ppo)
    ext.init(2, obs0)
    assert _distinct(w1, _weights(ext.ppo.net))

    fused = PPO(env, FF)             # the fused trainer draws the same weights
    fused.init(1)
    assert _equal(w1, _weights(fused.net))


def test_seeded_weights_keep_their_distributions():
    """The seeded draw keeps the init distributions: lecun-normal kernels
    truncated at 2σ, zero biases, the std at init_noise_std."""
    ppo = PPO(_env(), FF)
    ppo.init(3)
    sd = ppo.net.state_dict()
    w = sd["actor.0.weight"]
    std = np.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - 0.88 * std) < 0.1 * std
    assert float(sd["actor.0.bias"].abs().max()) == 0.0
    assert torch.equal(sd["std"], torch.full_like(sd["std"], 1.0))
