"""Full-train-state checkpoints of the port (utils/checkpoint.py), on the
CPU: a run saved after one iteration and resumed in a fresh runner is
bit-identical to the uninterrupted run, through the runner and through the
train CLI's ``-r``; a weights-only ``.pt`` (artifacts/model_3176.pt) still
loads; ``tools/export_torch.py``'s output loads back through the JAX
package's ``load_pt`` and gives the same forward pass to 1e-12."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nightmare_rl_tpu.models.actor_critic import ActorCritic as JActorCritic
from nightmare_rl_tpu.utils.torch_io import load_pt
from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
from nightmare_rl_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "model_3176.pt")


def _env():
    return NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=4, episode_length_s=0.2)), device="cpu")


CFG = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=8))


def _assert_identical(a, b):
    fa, fb = checkpoint.state_items(a.ppo), checkpoint.state_items(b.ppo)
    assert fa.keys() == fb.keys()
    assert any(k.startswith("env.phys.") for k in fa)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    assert a.last_stats["loss"] == b.last_stats["loss"]


def test_resume_is_bit_identical(tmp_path):
    ref = OnPolicyRunner(_env(), CFG, log_dir=str(tmp_path / "a"))
    ref.init(0)
    ref.learn(1, init_at_random_ep_len=True)
    path = get_load_path(str(tmp_path))
    assert path.endswith("model_1.pt")
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"model_state_dict", "optimizer_state_dict", "iter",
                         "infos", "train_state"}
    ref.learn(1)

    resumed = OnPolicyRunner(_env(), CFG)
    resumed.init(7)  # another seed: everything must come from the file
    assert resumed.load(path) is True
    resumed.learn(1)
    _assert_identical(ref, resumed)
    assert resumed.ppo.iteration == 2


def test_weights_only_file_still_loads():
    runner = OnPolicyRunner(NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=2)), device="cpu"), PPOCfg())
    runner.init(0)
    obs = runner.ppo.obs.clone()
    assert runner.load(CKPT) is False
    sd = torch.load(CKPT, weights_only=True)["model_state_dict"]
    for k, v in runner.ppo.net.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
    assert torch.equal(runner.ppo.obs, obs)  # envs keep their reset state


def test_train_cli_resume_matches_uninterrupted(tmp_path):
    from nightmare_rl_tpu_torch.tools import train

    args = ["-e", "4", "--device", "cpu", "--seed", "3"]
    whole = train.main(args + ["-n", "2", "--log_root", str(tmp_path / "w")],
                       pcfg=CFG)
    train.main(args + ["-n", "1", "--log_root", str(tmp_path / "r")], pcfg=CFG)
    resumed = train.main(args + ["-n", "1", "-r", "--log_root",
                                 str(tmp_path / "r")], pcfg=CFG)
    assert resumed.ppo.iteration == 2
    _assert_identical(whole, resumed)


def test_export_loads_through_the_jax_reader(tmp_path):
    from nightmare_rl_tpu_torch.tools import export_torch

    runner = OnPolicyRunner(_env(), CFG, log_dir=str(tmp_path / "run"))
    runner.init(0)
    runner.learn(1)
    src = get_load_path(str(tmp_path))
    out = str(tmp_path / "exported.pt")
    export_torch.main(["--ckpt", src, "--out", out])
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"model_state_dict", "iter"} and blob["iter"] == 1

    jnet = JActorCritic(num_actions=18)
    tpl = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 66)))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                    load_pt(out, tpl))
    obs = np.random.default_rng(2).normal(size=(5, 66))
    jmu, jstd, jv = jnet.apply(params, jnp.asarray(obs))
    net = runner.ppo.net.double()
    mu, std, v = net(torch.from_numpy(obs))
    for a, b in ((mu, jmu), (std, jstd), (v, jv)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-12, atol=1e-12)


def test_to_device_keeps_every_field():
    env = _env()
    state, _ = env.reset(0)
    moved = checkpoint.to_device(state, "cpu")
    assert type(moved) is type(state) and moved is not state
    a, b = checkpoint._fields(state), checkpoint._fields(moved)

    def walk(x, y):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                walk(x[k], y[k])
            else:
                assert torch.equal(x[k], y[k]) and y[k].device.type == "cpu", k

    walk(a, b)
    assert "qpos" in a["phys"]
