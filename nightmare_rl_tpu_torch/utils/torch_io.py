"""Carrying actor-critic weights across from the JAX package.

The JAX package stores its ActorCritic as a flax tree
(``params['params']['actor']['Dense_k']['kernel'/'bias']``, ``std``); the
port's module uses rsl_rl's ``nn.Sequential`` keys (``actor.0.weight``,
``actor.2.weight``, …: Linears at even indices, weights the transposed
kernels), the layout of the reference's ``model_*.pt`` files.

The recurrent net's flax ``OptimizedLSTMCell``s keep one Dense per gate:
input kernels ``ii/if/ig/io`` (in, H) without bias and recurrent kernels
``hi/hf/hg/ho`` (H, H) with bias.  torch's ``nn.LSTM`` stacks the gates in
the same order i, f, g, o: ``weight_ih`` is the transposed concatenation of
the input kernels, ``weight_hh`` that of the recurrent kernels, ``bias_hh``
the recurrent biases and ``bias_ih`` zero.
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


def _lstm_state(cell: Dict[str, Any], prefix: str, out: dict) -> None:
    def cat(names, leaf):
        return torch.from_numpy(np.concatenate(
            [np.asarray(cell[n][leaf]) for n in names], axis=-1).T.copy())

    w_hh = cat(("hi", "hf", "hg", "ho"), "kernel")
    out[f"{prefix}.rnn.weight_ih_l0"] = cat(("ii", "if", "ig", "io"), "kernel")
    out[f"{prefix}.rnn.weight_hh_l0"] = w_hh
    out[f"{prefix}.rnn.bias_ih_l0"] = w_hh.new_zeros(w_hh.shape[0])
    out[f"{prefix}.rnn.bias_hh_l0"] = cat(("hi", "hf", "hg", "ho"), "bias")


def actor_critic_recurrent_state_from_jax(params: Dict[str, Any]
                                          ) -> Dict[str, torch.Tensor]:
    """Flax ActorCriticRecurrent params (numpy leaves) → the port's
    ActorCriticRecurrent state_dict (rsl_rl's keys)."""
    out = actor_critic_state_from_jax(params)
    p = params["params"]
    _lstm_state(p["memory_a"], "memory_a", out)
    _lstm_state(p["memory_c"], "memory_c", out)
    return out
