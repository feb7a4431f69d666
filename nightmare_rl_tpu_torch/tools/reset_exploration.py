"""Reset a trained policy's exploration noise for a continued training
run (port of ``scripts/reset_exploration.py``).

    python -m nightmare_rl_tpu_torch.tools.reset_exploration SRC DST \\
        [--robot nightmare_v3|anymal_c] [--std 0.8] [--envs 2048] \\
        [--seed 1] [--force] [--device cpu]

PPO with rsl_rl's free-parameter action std can collapse into a standing
local optimum: the std shrinks and, with exploration gone, the tracking
terms plateau.  The remedy is to restart exploration from the stable
policy: the std parameter set to ``--std`` and Adam given a fresh state
(step 0, zero moments, written in place), everything else of the train
state kept: the weights, the adaptive learning rate, the iteration, the
env state, the observations and the generators.

``SRC`` is a checkpoint of the port's trainer (``model_<iter>.pt`` with its
train state); ``--envs`` must be the number of envs it holds.  The tool
writes ``DST/0000_reset_from_<iter>/model_<iter>.pt``, which
``python -m nightmare_rl_tpu_torch.tools.train -r -p DST`` resumes.  That
run directory sorts before the dated ones the continuation creates, so
``rl/runner.py::get_load_path`` (the newest run directory holding a
checkpoint) resolves the reset first and the continuation's own
checkpoints afterwards.  A ``DST`` that already holds checkpoints would
shadow it, so it is refused unless ``--force``.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg, PPOCfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner
from nightmare_rl_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Returns the path of the checkpoint written."""
    p = argparse.ArgumentParser()
    p.add_argument("src", help="a checkpoint of the port's trainer, "
                               "model_<iter>.pt")
    p.add_argument("dst", help="a fresh log root for the continuation run")
    p.add_argument("--robot", type=str, default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--std", type=float, default=0.8)
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--force", action="store_true",
                   help="allow a dst that already holds checkpoints (they "
                        "shadow the reset or are shadowed by it)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    existing = glob.glob(os.path.join(args.dst, "*", "model_*"))
    if existing and not args.force:
        p.error(f"{args.dst} already holds checkpoints ({existing[0]}, ...); "
                "resume resolution would not see the reset checkpoint as "
                "newest.  Use a fresh log root, or --force.")
    device = resolve_device(args.device)
    if args.robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=args.envs), device=device)
    else:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=args.envs)), device=device)
    runner = OnPolicyRunner(env, PPOCfg().replace(seed=args.seed))
    runner.init(args.seed)
    if not runner.load(args.src):
        raise SystemExit(f"{args.src} holds no train state (weights only): "
                         "the reset keeps the env state, which it lacks")
    ppo = runner.ppo
    if ppo.obs.shape[0] != env.num_envs:
        raise SystemExit(f"{args.src} holds {ppo.obs.shape[0]} envs; pass "
                         f"--envs {ppo.obs.shape[0]}")
    with torch.no_grad():
        std = ppo.net.std
        print(f"std before: {float(std.min()):.4f}..{float(std.max()):.4f}")
        std.fill_(args.std)
    ppo.reset_adam_state()
    it = ppo.iteration
    runner.log_dir = os.path.join(args.dst, f"0000_reset_from_{it}")
    runner.save(it)
    path = os.path.join(runner.log_dir, f"model_{it}.pt")
    print(f"wrote {path} with std={args.std}, fresh optimizer")
    return path


if __name__ == "__main__":
    main()
