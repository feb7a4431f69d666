"""Runs of a cell driven on the CPU at a small size (8 envs, 8-step
rollouts; the harness's look for a card skipped), sound and with the timed
path broken underneath.  On the CPU the program runs its plain versions,
the code the reference is a frozen copy of, so a sound run's numbers are 0
and ``correct`` is true; each fault that a training cell can have makes
``correct`` false."""

import contextlib
import copy
import time
from unittest import mock

import pytest
import torch

from benchmark import harness

SEED = 3_000_000_019     # above 2**31: a seed may need more than 32 bits
CELLS = ("nv3-train-2048", "anymal-train-4096")


def _files(name):
    """A cell's workload and configuration files (anymal_c's cell is out of
    BENCHMARK.json while the program's fault on it stands; its files stay)."""
    workload = harness.load(harness.BENCH, "workloads", name + ".json")
    return workload, harness.load(harness.BENCH, "configs",
                                  workload["config"] + ".json")


def _run(name, patches=()):
    workload, config = _files(name)
    config = copy.deepcopy(config)
    config["ppo"]["runner"]["num_steps_per_env"] = 8
    workload = dict(workload, num_envs=8, checked_steps=2)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        return harness.run_cell(name, config, workload, SEED, 0.1, False,
                                "cpu", time.perf_counter(), lambda line: None,
                                harness.cell_metrics(name, False))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"]
    assert all(c["value"] == 0.0 for c in result["checks"].values())
    assert set(result["metrics"]) >= {"env_steps_per_s", "setup_s"}


def _adam_moves_nothing():
    from nightmare_rl_tpu_torch.ops import learn as L

    return mock.patch.object(
        L, "adam", lambda opt, flat, lr, world, algo, losses:
        torch.cat([losses, flat[-1:]]))


def _grads_over_half():
    from nightmare_rl_tpu_torch.ops import learn as L

    grads = L.grads

    def half(pl, algo, traj, returns, norm_adv, idx, flat):
        return grads(pl, algo, traj, returns, norm_adv,
                     idx[:idx.numel() // 2], flat)
    return mock.patch.object(L, "grads", half)


def _physics_returns_its_state():
    from nightmare_rl_tpu_torch.physics import pipeline

    return mock.patch.object(pipeline, "step",
                             lambda sys, state, ctrl, n_steps=1: state)


def _reward_altered():
    from nightmare_rl_tpu_torch.ops import rollout as R

    store = R.store

    def altered(traj, t, reward, *args, **kw):
        return store(traj, t, reward * 1.01, *args, **kw)
    return mock.patch.object(R, "store", altered)


def _lr_rule_inverted():
    from nightmare_rl_tpu_torch.ops import learn as L

    return mock.patch.object(L, "adapt_lr", lambda algo, lr, kl: lr * 1.5)


FAULTS = {
    "the update's step returns its state unchanged": _adam_moves_nothing,
    "the physics step returns its state unchanged": _physics_returns_its_state,
    "half of the minibatch left out, the mean over the rest": _grads_over_half,
    "an answer altered where it is produced": _reward_altered,
    "the adaptive lr's rule altered": _lr_rule_inverted,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    result = _run("nv3-train-2048", [FAULTS[fault]()])
    assert not result["correct"], result["checks"]


def test_the_numbers_catch_what_they_are_for():
    """Each planted fault fails the number meant for it."""
    failed = {}
    for fault, patch in FAULTS.items():
        checks = _run("nv3-train-2048", [patch()])["checks"]
        failed[fault] = {k for k, c in checks.items()
                         if not c["value"] <= c["limit"]}
    assert "change_gap" in failed["the update's step returns its state "
                                  "unchanged"]
    assert "step_gap" in failed["the physics step returns its state "
                                "unchanged"]
    assert failed["half of the minibatch left out, the mean over the rest"] & {
        "loss_gap", "grad_gap"}
    assert "step_gap" in failed["an answer altered where it is produced"]
    assert "lr_gap" in failed["the adaptive lr's rule altered"]
