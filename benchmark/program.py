"""The system under test, built as ``tools/train.py`` builds it: the env
and ``PPO`` of ``nightmare_rl_tpu_torch`` from a configuration file's
dicts, at a cell's number of envs, with the CLI's own PGS dispatch.  The
only module of this benchmark that imports the program."""

from __future__ import annotations

import contextlib
import hashlib
import os
from unittest import mock

from benchmark.reference.ppo import from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "nightmare_rl_tpu_torch", "assets")


def archive_sha256(model: str) -> str:
    """The program's compiled model archive, hashed: a configuration names
    the archive it was measured on."""
    with open(os.path.join(ASSETS, model + ".npz"), "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def build(config: dict, num_envs: int, seed: int, device):
    """(env, ppo) of the configuration at ``num_envs`` envs.  PPO records
    env 0's rows where the env's config records states, as the runner
    does for a run with a log directory."""
    from nightmare_rl_tpu_torch.core.config import NightmareV3Cfg, PPOCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    model = config["archive"]["model"]
    if archive_sha256(model) != config["archive"]["sha256"]:
        raise ValueError(f"the program's {model}.npz is not the archive that "
                         "the configuration names")
    env_cfg = dict(config["env"])
    if config["robot"] == "anymal_c":
        from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv

        env_cfg["num_envs"] = num_envs
        env = AnymalCEnv(from_dict(AnymalCCfg(), env_cfg), device=device)
    else:
        from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env

        env_cfg["env"] = dict(env_cfg["env"], num_envs=num_envs)
        env = NightmareV3Env(from_dict(NightmareV3Cfg(), env_cfg),
                             device=device)
    pcfg = from_dict(PPOCfg(), dict(config["ppo"], seed=seed))
    record = bool(getattr(getattr(env.cfg, "viewer", None), "record_states",
                          False))
    return env, PPO(env, pcfg, record_states=record)


def counted_launches() -> dict:
    """Each kernel wrapper's launch counter (a captured graph's launches
    count once per replay), by wrapper name."""
    from nightmare_rl_tpu_torch.utils.graph import _COUNTED

    return {f.__name__: getattr(f, "launches", 0) for f in _COUNTED}


def pgs_form(env) -> str:
    """The solve's form that the CLI's dispatch chose for this env."""
    from nightmare_rl_tpu_torch.physics import solver

    return solver.prewarm(env.sys, env.device)


@contextlib.contextmanager
def recording_learner(ppo, recorder_cls):
    """While the first iteration builds the learning half's graphs
    (``rl/ppo.py::CapturedLearn``), its minibatch step is wrapped by
    ``recorder_cls(step, ppo)``, which the block receives; on exit the
    learning half's parts are the program's own again."""
    from nightmare_rl_tpu_torch.rl import ppo as P

    made = {}

    class Recording(P.CapturedLearn):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.update(obj=self, parts=self.parts)
            made["rec"].step = self.parts.step
            self.parts = self.parts._replace(step=made["rec"])

    made["rec"] = recorder_cls(None, ppo)
    with mock.patch.object(P, "CapturedLearn", Recording):
        yield made["rec"]
    if "obj" in made:
        made["obj"].parts = made["parts"]
