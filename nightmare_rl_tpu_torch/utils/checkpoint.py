"""Full-train-state checkpoints with ``torch.save`` (the port's counterpart
of ``nightmare_rl_tpu/utils/checkpoint.py``, which saves the whole JAX
TrainState with orbax).

A file keeps rsl_rl's keys (``model_state_dict``, ``optimizer_state_dict``,
``iter``, ``infos``), so the reference's ``play.py`` still loads it, and adds
one ``train_state`` entry for a deterministic resume: the learning rate, the
PPO generator's state, every field of the env state, the last observation,
the recurrent policy's hidden state and the env's own generator state.  A
file without ``train_state`` (for example ``artifacts/model_3176.pt``)
restores the weights, and the optimizer where present.  The learning rate,
a tensor in the PPO, is a number in the file (in ``optimizer_state_dict``
as rsl_rl writes it, and in ``train_state``).  A load writes every tensor
of the train state into the PPO's own with ``copy_`` (the weights, Adam's
state, the learning rate, the rollout's buffers): the captured rollout
step and update read and write those.

Under a mesh (``parallel/mesh.py``) the file holds the GLOBAL env state: every
rank takes part in gathering it and rank 0 writes it; a load gives each rank
its own rows.  A checkpoint saved at any world size resumes at any other (the
generators are equal on every rank, parallel/shard.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch


def _fields(state) -> Dict[str, Any]:
    """A dataclass state as nested dicts of its tensors."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def _rebuild(template, saved: Dict[str, Any], device, rows=lambda x: x):
    """``template``'s dataclass filled from ``saved`` (nested dicts), each
    tensor cut by ``rows``."""
    kw = {}
    for f in dataclasses.fields(template):
        cur = getattr(template, f.name)
        v = saved[f.name]
        kw[f.name] = (_rebuild(cur, v, device, rows)
                      if dataclasses.is_dataclass(cur) else rows(v).to(device))
    return dataclasses.replace(template, **kw)


def _map(fn, d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in d.items()}


def _hidden(ppo, fn):
    """The recurrent hidden state as nested dicts of ``fn`` of each tensor
    (torch's (h, c) per LSTM), or None for the feed-forward net."""
    if not ppo.recurrent:
        return None
    return {name: {"h": fn(carry[0]), "c": fn(carry[1])}
            for name, carry in zip(("actor", "critic"), ppo.hidden)}


def _global(ppo) -> Dict[str, Any]:
    """The env-axis part of the train state, gathered over the ranks
    (a collective under a mesh)."""
    g = ppo.gather_envs
    return {"env_state": _map(g, _fields(ppo.env_state)), "obs": g(ppo.obs),
            "hidden": _hidden(ppo, g)}


def to_device(state, device):
    """A dataclass state (an env or physics state) with every tensor on
    ``device``."""
    return _rebuild(state, _fields(state), device)


def _generator(ppo):
    return getattr(ppo.env, "generator", None)


def save(path: str, ppo, infos=None) -> None:
    """Write the PPO's weights, optimizer and full train state to ``path``
    (under a mesh every rank calls this, and rank 0 writes)."""
    glob = _global(ppo)
    if ppo.shard.rank != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    env_gen = _generator(ppo)
    torch.save({
        "model_state_dict": ppo.net.state_dict(),
        "optimizer_state_dict": ppo.optimizer_state(),
        "iter": ppo.iteration,
        "infos": infos,
        "train_state": {
            "lr": float(ppo.lr),
            "generator": ppo.generator.get_state(),
            **glob,
            "env_generator": None if env_gen is None else env_gen.get_state(),
        },
    }, path)


def state_items(ppo) -> Dict[str, Any]:
    """Every tensor and number of ``ppo``'s global train state, flat by
    name (for comparing two train states; a collective under a mesh)."""
    out = {f"net.{k}": v for k, v in ppo.net.state_dict().items()}
    for i, st in ppo.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    env_gen = _generator(ppo)
    out.update(lr=ppo.lr, iteration=ppo.iteration,
               generator=ppo.generator.get_state(),
               env_generator=None if env_gen is None else env_gen.get_state())

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                out[prefix + k] = v

    glob = _global(ppo)
    out["obs"] = glob["obs"]
    walk("env.", glob["env_state"])
    if glob["hidden"] is not None:
        walk("hidden.", glob["hidden"])
    return out


def load(path: str, ppo) -> bool:
    """Restore ``path`` into ``ppo``.  Returns whether the full train state
    was restored (False for a weights-only file)."""
    dev = ppo.device
    blob = torch.load(path, map_location=dev, weights_only=True)
    ts = blob.get("train_state")
    if ts is not None and ppo.env_state is None:
        # the template that the saved env state fills; it draws weights and
        # resets the optimizer, so it comes before they are restored
        ppo.init()
    ppo.net.load_state_dict(blob["model_state_dict"])
    if "optimizer_state_dict" in blob:
        ppo.load_optimizer_state(blob["optimizer_state_dict"])
    ppo.iteration = int(blob.get("iter", 0))
    if ts is None:
        return False
    ppo.lr = ts["lr"]
    # generator states are CPU byte tensors whatever the generator's device
    ppo.generator.set_state(ts["generator"].cpu())
    rows = ppo.shard.rows
    hidden = ()
    if ppo.recurrent:
        hid = ts["hidden"]
        hidden = tuple((rows(hid[k]["h"]).to(dev), rows(hid[k]["c"]).to(dev))
                       for k in ("actor", "critic"))
    # into the rollout's buffers (a captured rollout step reads them)
    ppo.set_rollout_state(_rebuild(ppo.env_state, ts["env_state"], dev, rows),
                          rows(ts["obs"]).to(dev), hidden)
    env_gen = _generator(ppo)
    if env_gen is not None and ts["env_generator"] is not None:
        env_gen.set_state(ts["env_generator"].cpu())
    return True
