"""The port's exploration reset (``nightmare_rl_tpu_torch/tools/
reset_exploration.py``, the counterpart of ``scripts/reset_exploration.py``)
on a port run trained on the CPU: 4 envs, 2-step rollouts, one iteration.

After the reset the std parameter holds the value asked for and Adam's
state is that of its first step (zero moments, step 0); every other field
of the train state (weights, the adaptive learning rate, the iteration,
the env state, observations and generators) equals the source's with
``torch.equal``.  ``train -r -p DST`` resumes from it at the source's
iteration, and a DST that holds checkpoints is refused without
``--force``.
"""

import os

import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner
from nightmare_rl_tpu_torch.tools import reset_exploration, train
from nightmare_rl_tpu_torch.utils import checkpoint

ENVS = 4
CFG = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=2))
LR = 3.7e-4  # away from the configured and any adapted learning rate


def _state(path):
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=ENVS)),
                         device="cpu")
    runner = OnPolicyRunner(env, CFG)
    assert runner.load(path) is True
    return runner.ppo, checkpoint.state_items(runner.ppo)


@pytest.fixture(scope="module")
def reset(tmp_path_factory):
    root = tmp_path_factory.mktemp("reset")
    runner = train.main(["-e", str(ENVS), "-n", "1", "--device", "cpu",
                         "--log_root", str(root / "src")], pcfg=CFG)
    # the source's lr set apart, so that keeping it is seen
    runner.ppo.lr = LR
    src = str(root / "model_1.pt")
    checkpoint.save(src, runner.ppo)
    dst = str(root / "dst")
    path = reset_exploration.main([src, dst, "--envs", str(ENVS), "--std",
                                   "0.8", "--device", "cpu"])
    return dict(root=root, src=src, dst=dst, path=path)


def test_reset_sets_std_and_adam_and_keeps_the_rest(reset):
    assert reset["path"] == os.path.join(reset["dst"], "0000_reset_from_1",
                                         "model_1.pt")
    src_ppo, src = _state(reset["src"])
    ppo, got = _state(reset["path"])
    assert src.keys() == got.keys()
    assert torch.equal(ppo.net.std.detach(), torch.full_like(ppo.net.std, 0.8))
    assert not torch.equal(src_ppo.net.std, ppo.net.std)
    adam = [k for k in got if k.startswith("adam.")]
    assert len(adam) == 3 * len(ppo.params)
    for k in adam:
        assert not bool(got[k].any()), k
    assert any(bool(src[k].any()) for k in adam if k.endswith(".step"))
    kept = [k for k in got if k not in adam and k != "net.std"]
    assert {"lr", "iteration", "generator", "env_generator", "obs",
            "net.actor.0.weight"} <= set(kept)
    for k in kept:
        a, b = src[k], got[k]
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert same, k
    assert float(got["lr"]) == float(torch.tensor(LR)) and got["iteration"] == 1


def test_train_resumes_from_the_reset(reset, capsys):
    runner = train.main(["-r", "-p", reset["dst"], "-e", str(ENVS), "-n", "1",
                         "--device", "cpu", "--log_root",
                         str(reset["root"] / "continued")], pcfg=CFG)
    assert f"Loading model from: {reset['path']}" in capsys.readouterr().out
    assert runner.ppo.iteration == 2


def test_refuses_a_destination_with_checkpoints(reset, capsys):
    argv = [reset["src"], reset["dst"], "--envs", str(ENVS), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        reset_exploration.main(argv)
    assert e.value.code == 2
    assert "already holds checkpoints" in capsys.readouterr().err
    assert reset_exploration.main(argv + ["--force"]) == reset["path"]
