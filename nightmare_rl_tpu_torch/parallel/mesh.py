"""Data parallelism for the PPO trainer over ``torch.distributed`` (port of
``nightmare_rl_tpu/parallel/mesh.py``).

One process per rank, started by ``python -m torch.distributed.run``, whose
environment gives each its rank, world size and local rank.  Envs and the
recurrent hidden state are sharded on the env axis (each rank steps
``num_envs / world`` envs), parameters are replicated (rank 0's are
broadcast at start), and where the JAX package reduces with
``pmean``/``psum`` inside its shard_map the port calls ``all_reduce``:

- per minibatch, the gradients and the KL in ONE flat buffer (the PPO's,
  whose views the gradients are), averaged before the clip by global norm
  and before the adaptive learning rate, so every rank takes the same step
  with the same lr;
- the advantage mean and variance (over n_global − 1);
- the loss statistics, finished-episode counts and sums, dones and the
  mean reward.

These reductions run eagerly between the replays of the learning half's
captured parts (``rl/ppo.py::CapturedLearn``), each in place on the tensor
that one part wrote and the next reads, so no graph holds a collective:
every rank captures alone, and gloo (which a graph cannot hold) and NCCL
take one code path.

Random draws are made at the global shape and cut per rank
(``parallel/shard.py``), so the rollout does not depend on the world size;
the minibatches are shard-local, the one documented deviation (PARITY.md
§4).  Backends: NCCL on the card, gloo on the CPU and for several ranks that
share one card (NCCL refuses that).  gloo takes only ``broadcast`` and
``all_reduce`` for CUDA tensors, so those are the only collectives used.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.parallel.shard import Shard
from nightmare_rl_tpu_torch.rl.ppo import PPO

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """This process's place in the process group."""

    rank: int
    world: int
    backend: str
    device: torch.device

    @property
    def shard(self) -> Shard:
        return Shard(self.rank, self.world)


def make_mesh(device: str = "cuda", backend: Optional[str] = None,
              require_launcher: bool = False) -> Mesh:
    """Join (or create) the default process group and pick this rank's
    device: ``cuda:LOCAL_RANK`` (ranks beyond the card count share cards,
    which only gloo allows), or the CPU when ``device="cpu"``.  Rank and
    world size come from ``torch.distributed.run``'s environment; without
    it the process is a world of one (refused when ``require_launcher``).
    ``backend`` defaults to nccl on the card and gloo on the CPU; a failed
    init raises and is never retried with another backend."""
    env = os.environ
    launched = all(k in env for k in _LAUNCHER_VARS)
    if require_launcher and not launched:
        raise RuntimeError("the ranks must be started by python -m "
                           "torch.distributed.run (its environment sets "
                           + ", ".join(_LAUNCHER_VARS) + ")")
    rank = int(env["RANK"]) if launched else 0
    world = int(env["WORLD_SIZE"]) if launched else 1
    local_rank = int(env["LOCAL_RANK"]) if launched else 0
    local_world = int(env.get("LOCAL_WORLD_SIZE", world)) if launched else 1
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on {cards} card(s): NCCL refuses two "
                "ranks on one card; use the gloo backend")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif dev.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"the {backend} backend needs the card; the CPU "
                             "takes gloo")
    else:
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev}")
    if dist.is_initialized():
        if (dist.get_backend() != backend or dist.get_world_size() != world
                or dist.get_rank() != rank):
            raise RuntimeError("a different process group is already "
                               "initialized")
    elif launched:
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
            f"{env['MASTER_PORT']}", rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return Mesh(rank, world, backend, dev)


def close() -> None:
    """Leave the default process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


class ShardedPPO(PPO):
    """PPO with the envs sharded over the ranks of ``mesh``; parameters
    replicated.  The env must be built with ``shard=mesh.shard`` and
    ``device=mesh.device``; its ``num_envs`` is then this rank's share.
    Recording env 0's trajectory is an unsharded feature (env 0 lives on
    rank 0 alone) and stays off."""

    distributed = True

    def __init__(self, env, cfg: PPOCfg, mesh: Mesh):
        if getattr(env, "shard", Shard()) != mesh.shard:
            raise ValueError(f"the env holds shard {getattr(env, 'shard', None)}"
                             f", the mesh is {mesh.shard}: build it with "
                             "shard=mesh.shard")
        super().__init__(env, cfg, record_states=False)
        self.mesh = mesh
        # replicate rank 0's parameters (state_dict tensors share storage)
        for t in self.net.state_dict().values():
            dist.broadcast(t, src=0)

    def _all_sum(self, x: torch.Tensor) -> torch.Tensor:
        # synchronous: ordered after the replay that wrote x and before the
        # next, which are on the current stream
        dist.all_reduce(x)
        return x

    def gather_envs(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in rank order, by one broadcast per rank (gloo
        takes broadcast and all_reduce for CUDA tensors); exact bytes."""
        parts = []
        for r in range(self.shard.world):
            part = x.contiguous() if r == self.shard.rank else torch.empty_like(x)
            dist.broadcast(part.view(torch.uint8) if part.dtype == torch.bool
                           else part, src=r)
            parts.append(part)
        return torch.cat(parts)

    def any_rank(self, flag: bool) -> bool:
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t)
        return bool(t.item() > 0)
