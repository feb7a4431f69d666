"""Carrying actor-critic weights across from the JAX package.

The JAX package stores its ActorCritic as a flax tree
(``params['params']['actor']['Dense_k']['kernel'/'bias']``, ``std``); the
port's module uses rsl_rl's ``nn.Sequential`` keys (``actor.0.weight``,
``actor.2.weight``, …: Linears at even indices, weights the transposed
kernels), the layout of the reference's ``model_*.pt`` files.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _mlp_state(tree: Dict[str, Any], prefix: str, out: dict) -> None:
    names = sorted(tree, key=lambda k: int(k.split("_")[1]))
    for i, k in enumerate(names):
        out[f"{prefix}.{2 * i}.weight"] = torch.from_numpy(
            np.array(tree[k]["kernel"], copy=True).T.copy())
        out[f"{prefix}.{2 * i}.bias"] = torch.from_numpy(
            np.array(tree[k]["bias"], copy=True))


def actor_critic_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ActorCritic params (numpy leaves) → the port's ActorCritic
    state_dict."""
    p = params["params"]
    out = {"std": torch.from_numpy(np.array(p["std"], copy=True))}
    _mlp_state(p["actor"], "actor", out)
    _mlp_state(p["critic"], "critic", out)
    return out
