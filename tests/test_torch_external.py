"""The port's host-stepped PPO driver (rl/external.py) against its fused PPO
(rl/ppo.py), mirroring tests/test_ppo.py:51-93: the same seed, weights and
env, one iteration each; the driver reuses the fused trainer's policy step,
GAE, permutation and update, so the two take the same step (held to the
JAX test's tolerances)."""

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.external import ExternalPPO
from nightmare_rl_tpu_torch.rl.ppo import PPO

CFG = PPOCfg(runner=RunnerCfg(num_steps_per_env=8))


def _env():
    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(
        num_envs=8, episode_length_s=0.1)), device="cpu")


def test_external_driver_matches_fused_ppo():
    fused = PPO(_env(), CFG)
    fused.init(0)

    env = _env()
    state0, obs0 = env.reset(0)
    ext = ExternalPPO(env.num_obs, env.num_actions, env.num_envs, CFG,
                      device="cpu")
    ext.init(0, obs0.numpy())
    ext.ppo.net.load_state_dict(fused.net.state_dict())
    box = {"state": state0}

    def step_fn(actions):
        out = env.step(box["state"], torch.as_tensor(actions))
        box["state"] = out.state
        return (out.obs.numpy(), out.reward.numpy(), out.done.numpy(),
                out.time_out.numpy())

    stats_f = fused.learn_step()
    stats_e = ext.learn_iteration(step_fn)

    assert stats_e["dones"] == stats_f["dones"] > 0
    np.testing.assert_allclose(stats_f["loss"], stats_e["loss"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(stats_f["kl"], stats_e["kl"], rtol=2e-3,
                               atol=1e-6)
    for (k, a), b in zip(fused.net.state_dict().items(),
                         ext.ppo.net.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    assert ext.ppo.iteration == 1
    assert stats_e["mean_noise_std"] == stats_f["mean_noise_std"]
    np.testing.assert_allclose(ext.ppo.obs.numpy(), fused.obs.numpy(), rtol=0,
                               atol=0)


def test_external_driver_takes_the_feed_forward_policy():
    cfg = CFG.replace(runner=RunnerCfg(policy_class_name="ActorCriticRecurrent"))
    with pytest.raises(ValueError, match="feed-forward"):
        ExternalPPO(66, 18, 8, cfg, device="cpu")
