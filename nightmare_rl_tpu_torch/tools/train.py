"""Train nightmare_v3 (or anymal_c) PPO with the PyTorch port.

    python -m nightmare_rl_tpu_torch.tools.train -e 2048 -n 1000 [-r] [-p PATH]
        [--robot nightmare_v3|anymal_c] [--profile DIR]

    python -m torch.distributed.run --nproc_per_node 2 \
        -m nightmare_rl_tpu_torch.tools.train --mesh -e 2048 -n 1000
        [--backend nccl|gloo] [--multihost]

Runs on the card; ``--device cpu`` is the only way onto the CPU, and a
missing card raises.  ``-n`` is the number of learning iterations.  ``-r``
resumes the newest checkpoint under ``-p`` (or the log root): a checkpoint
of the port restores the full train state (weights, optimizer, lr, RNG, env
state and observations), so the run continues as if uninterrupted; a
weights-only ``.pt`` restores the weights (and optimizer) and starts the
envs from reset.  nightmare_v3 runs record env 0's episodes as ``.pkl``
files in the run directory (``tools/replay.py`` plays them).

``--mesh`` shards the ``-e`` envs over the ranks that
``torch.distributed.run`` starts (parallel/mesh.py), each rank on
``cuda:LOCAL_RANK`` (or on the CPU with ``--device cpu``); rank 0 alone
prints and writes.  The backend is nccl on the card and gloo on the CPU;
``--backend gloo`` puts several ranks on one card, which NCCL refuses.
``--multihost`` marks ranks that span hosts: the run then refuses to start
outside ``torch.distributed.run``.  A checkpoint saved at any world size
resumes at any other.  The recurrent policy is chosen in the PPO config
(``runner.policy_class_name``), which Python callers pass as ``pcfg``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Optional, Sequence

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg, PPOCfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.parallel import mesh as M
from nightmare_rl_tpu_torch.parallel.shard import Shard
from nightmare_rl_tpu_torch.rl.runner import OnPolicyRunner, get_load_path
from nightmare_rl_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None,
         pcfg: Optional[PPOCfg] = None) -> OnPolicyRunner:
    """``pcfg``: the PPO config (default ``PPOCfg()``); ``--seed`` and
    ``--std_floor`` override its fields."""
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048, dest="num_envs")
    p.add_argument("-n", "--iterations", type=int, default=1000)
    p.add_argument("-r", "--resume", action="store_true", default=False)
    p.add_argument("-p", "--resume_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--robot", type=str, default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of iterations 2-4 here")
    p.add_argument("--std_floor", type=float, default=0.0,
                   help="exploration floor on the action std (flag-gated "
                        "deviation from rsl_rl; 0 = parity config)")
    p.add_argument("--max_ang_vel", type=float, default=None,
                   help="override the sampled |wz| command range of "
                        "nightmare_v3 (reference default 0.8 rad/s)")
    p.add_argument("--mesh", action="store_true",
                   help="shard the envs over the ranks of "
                        "python -m torch.distributed.run")
    p.add_argument("--multihost", action="store_true",
                   help="the ranks span hosts: refuse to start outside "
                        "torch.distributed.run (implies --mesh)")
    p.add_argument("--backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="collectives under --mesh: nccl (the card's default) "
                        "or gloo (the CPU's; several ranks on one card)")
    args = p.parse_args(argv)
    if args.backend is not None and not (args.mesh or args.multihost):
        p.error("--backend needs --mesh")

    mesh, shard = None, Shard()
    if args.mesh or args.multihost:
        mesh = M.make_mesh(args.device, args.backend,
                           require_launcher=args.multihost)
        device, shard = mesh.device, mesh.shard
    else:
        device = resolve_device(args.device)
    main_rank = shard.rank == 0

    log_root = args.log_root or os.path.join("logs", args.robot)
    log_dir = os.path.join(log_root, str(datetime.datetime.now()))
    if main_rank:
        print(f"Logging to {log_dir}")
        if mesh is not None:
            print(f"mesh: {mesh.world} rank(s), backend {mesh.backend}, "
                  f"rank 0 on {mesh.device}")

    pcfg = (pcfg or PPOCfg()).replace(seed=args.seed)
    if args.std_floor > 0.0:
        pcfg = pcfg.replace(policy=dataclasses.replace(
            pcfg.policy, std_floor=args.std_floor))
    if args.robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=args.num_envs), device=device,
                         shard=shard)
    else:
        cfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=args.num_envs))
        if args.max_ang_vel is not None:
            cfg = cfg.replace(commands=dataclasses.replace(
                cfg.commands, ranges=dataclasses.replace(
                    cfg.commands.ranges, max_ang_vel=args.max_ang_vel)))
        env = NightmareV3Env(cfg, device=device, shard=shard)

    runner = OnPolicyRunner(env, pcfg, log_dir=log_dir, mesh=mesh)
    runner.init(args.seed)
    resumed = False
    if args.resume:
        path = get_load_path(args.resume_path or log_root)
        if main_rank:
            print(f"Loading model from: {path}")
        resumed = runner.load(path)
    # a full-state resume keeps the saved episode lengths
    runner.learn(args.iterations, init_at_random_ep_len=not resumed,
                 profile_dir=args.profile)
    return runner


if __name__ == "__main__":
    try:
        main()
    finally:
        M.close()
