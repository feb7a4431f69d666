"""Full-train-state checkpoints with ``torch.save`` (the port's counterpart
of ``nightmare_rl_tpu/utils/checkpoint.py``, which saves the whole JAX
TrainState with orbax).

A file keeps rsl_rl's keys (``model_state_dict``, ``optimizer_state_dict``,
``iter``, ``infos``), so the reference's ``play.py`` still loads it, and adds
one ``train_state`` entry for a deterministic resume: the learning rate, the
PPO generator's state, every field of the env state, the last observation
and the env's own generator state.  A file without ``train_state`` (for
example ``artifacts/model_3176.pt``) restores the weights, and the
optimizer where present.
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


def _rebuild(template, saved: Dict[str, Any], device):
    """``template``'s dataclass filled from ``saved`` (nested dicts)."""
    kw = {}
    for f in dataclasses.fields(template):
        cur = getattr(template, f.name)
        v = saved[f.name]
        kw[f.name] = (_rebuild(cur, v, device) if dataclasses.is_dataclass(cur)
                      else v.to(device))
    return dataclasses.replace(template, **kw)


def to_device(state, device):
    """A dataclass state (an env or physics state) with every tensor on
    ``device``."""
    return _rebuild(state, _fields(state), device)


def _generator(ppo):
    return getattr(ppo.env, "generator", None)


def save(path: str, ppo, infos=None) -> None:
    """Write the PPO's weights, optimizer and full train state to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    env_gen = _generator(ppo)
    torch.save({
        "model_state_dict": ppo.net.state_dict(),
        "optimizer_state_dict": ppo.optimizer.state_dict(),
        "iter": ppo.iteration,
        "infos": infos,
        "train_state": {
            "lr": ppo.lr,
            "generator": ppo.generator.get_state(),
            "env_state": _fields(ppo.env_state),
            "obs": ppo.obs,
            "env_generator": None if env_gen is None else env_gen.get_state(),
        },
    }, path)


def state_items(ppo) -> Dict[str, Any]:
    """Every tensor and number of ``ppo``'s train state, flat by name (for
    comparing two train states)."""
    out = {f"net.{k}": v for k, v in ppo.net.state_dict().items()}
    for i, st in ppo.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    env_gen = _generator(ppo)
    out.update(lr=ppo.lr, iteration=ppo.iteration, obs=ppo.obs,
               generator=ppo.generator.get_state(),
               env_generator=None if env_gen is None else env_gen.get_state())

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                out[prefix + k] = v

    walk("env.", _fields(ppo.env_state))
    return out


def load(path: str, ppo) -> bool:
    """Restore ``path`` into ``ppo``.  Returns whether the full train state
    was restored (False for a weights-only file)."""
    dev = ppo.device
    blob = torch.load(path, map_location=dev, weights_only=True)
    ppo.net.load_state_dict(blob["model_state_dict"])
    if "optimizer_state_dict" in blob:
        ppo.optimizer.load_state_dict(blob["optimizer_state_dict"])
        ppo.lr = ppo.optimizer.param_groups[0]["lr"]
    ppo.iteration = int(blob.get("iter", 0))
    ts = blob.get("train_state")
    if ts is None:
        return False
    if ppo.env_state is None:
        ppo.init()  # the template that the saved env state fills
    ppo.lr = ts["lr"]
    for group in ppo.optimizer.param_groups:
        group["lr"] = ppo.lr
    # generator states are CPU byte tensors whatever the generator's device
    ppo.generator.set_state(ts["generator"].cpu())
    ppo.env_state = _rebuild(ppo.env_state, ts["env_state"], dev)
    ppo.obs = ts["obs"].to(dev)
    env_gen = _generator(ppo)
    if env_gen is not None and ts["env_generator"] is not None:
        env_gen.set_state(ts["env_generator"].cpu())
    return True
