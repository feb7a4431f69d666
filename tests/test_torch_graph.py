"""The port's captured step (``nightmare_rl_tpu_torch/utils/graph.py``) on
the CPU, where it runs the step eagerly on its own buffers (the card's CUDA
graph is held in tests/test_torch_cuda.py and chip_smoke.py):

- ``CapturedStep`` of ``env.step`` gives every ``StepOut`` field of the
  plain step, bit for bit, over 6 steps that include a masked reset
  (two envs forced to time out), and draws the same numbers from the env's
  generator; the same for ``pipeline.step`` over 2-substep calls;
- its warm-up leaves the state buffers, the env's and the PPO's
  generators as they were;
- ``PPO.rollout`` equals an eager loop of ``act`` + ``env.step`` with the
  old rollout's bookkeeping, bit for bit, for the feed-forward and the
  recurrent policy: trajectory, episode metrics, env 0's record, the final
  state and the generators;
- a checkpoint saved after one iteration and restored into the buffers of a
  fresh PPO (not rebound) gives the same next rollout as the uninterrupted
  run;
- the buffers refuse a call of another shape, and ``assign`` writes into
  buffers rather than rebinding them;
- no captured step talks to the host: the nightmare_v3 and anymal_c env
  steps (also with the smooth and integrate kernels' host drivers in
  place of their wrappers, so the wrappers' road to a kernel is
  watched), custom_play's control step, the PPO's learning half
  (``PPO._learn``), a ``ShardedPPO``'s (its captured parts, the
  reductions between them left out) and a rank's permutation at world 2
  (``Shard.perm``), each called once to warm up and then once under a
  ``TorchDispatchMode`` that records every op reading a value to the host
  (``_local_scalar_dense``: ``item``, ``float``, ``bool`` of a tensor;
  ``nonzero`` and indexing by a boolean mask, whose length the host
  reads) or making a tensor from host
  data (``lift_fresh``/``lift_fresh_copy``: ``torch.tensor`` of a list or
  a number).  On the card each is a synchronization that a CUDA graph's
  capture refuses; here the CPU shows them on every PR.  The plain
  versions that stand in for the CUDA kernels on the CPU (``ops/pgs.py``,
  which checks the legs form's slot ids there) are left out: on the card
  those calls are the kernels' launches.  So are the reductions
  (``parallel/mesh.py``), which run between the graphs.

The JAX-parity tests of the same paths (test_torch_env.py, test_torch_ppo.py,
test_torch_play.py's rollout, test_torch_recurrent.py,
test_torch_checkpoint.py) run through the same code.
"""

import dataclasses
import shutil
import traceback
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models import actor_critic as ac
from nightmare_rl_tpu_torch.ops import integrate as IN
from nightmare_rl_tpu_torch.ops import smooth as SM
from nightmare_rl_tpu_torch.physics import pipeline
from nightmare_rl_tpu_torch.rl.ppo import PPO, Transition
from nightmare_rl_tpu_torch.utils import checkpoint
from nightmare_rl_tpu_torch.utils.graph import (
    CapturedStep, assign, clone, leaves,
)

N = 8


def _env(n=N, seed=0):
    return NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=n)),
                          device="cpu", seed=seed)


def _same(a, b) -> bool:
    """Every leaf equal, bit for bit (NaN where NaN)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(torch.all((x == y) | (torch.isnan(x) & torch.isnan(y))
                           if x.is_floating_point() else x == y))
        for x, y in zip(la, lb))


def _actions(steps, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(scale=0.5, size=(N, 18)).astype(
        np.float32)) for _ in range(steps)]


def test_captured_env_step_equals_env_step():
    env = _env()
    s0, _ = env.reset(0)
    # envs 1 and 5 time out at the third step: a masked reset mid-run
    s0.episode_length[[1, 5]] = env.max_episode_length - 2
    acts = _actions(6)
    gen0 = env.generator.get_state()
    eager, s = [], s0
    for a in acts:
        out = env.step(s, a)
        eager.append(clone(out))
        s = out.state
    gen_eager = env.generator.get_state()
    assert bool(eager[2].done[[1, 5]].all()) and bool(eager[2].time_out[1])

    env.generator.set_state(gen0)
    step = CapturedStep(env.step, s0, acts[0], generators=[env.generator],
                        state_field="state")
    assert step.graph is None  # the CPU runs the step eagerly
    s = s0
    for k, a in enumerate(acts):
        out = step(s, a)
        assert out.state is step.state
        assert _same(out, eager[k]), k
        s = out.state
    assert torch.equal(env.generator.get_state(), gen_eager)


def test_captured_pipeline_step_equals_pipeline_step():
    sys_ = _env().sys
    rng = np.random.default_rng(2)
    st = pipeline.make_state(sys_, N)
    qpos = st.qpos.clone()
    qpos[:, 7:] += torch.from_numpy(rng.normal(scale=0.3, size=(N, 18)).astype(
        np.float32))
    qpos[:, 2] -= 0.05
    st = st.replace(qpos=qpos)
    ctrls = [torch.from_numpy(rng.normal(size=(N, sys_.nu)).astype(np.float32))
             for _ in range(4)]

    def substeps(state, ctrl):
        return pipeline.step(sys_, state, ctrl, 2)

    step = CapturedStep(substeps, st, ctrls[0])
    ref, cap = st, st
    for c in ctrls:
        ref = pipeline.step(sys_, ref, c, 2)
        cap = step(cap, c)
        assert cap is step.state
        assert _same(cap, ref)
    assert float(ref.sensordata.abs().max()) > 0  # the feet touched down


def test_warm_up_leaves_state_and_generators_unchanged():
    env = _env()
    ppo = PPO(env, PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=3)))
    ppo.init(0)
    step = ppo._rollout_stepper(3)
    before = clone(step.state)
    gens = [ppo.generator, env.generator]
    states = [g.get_state() for g in gens]
    step.warm_up(gens)
    assert _same(step.state, before)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, states))
    # the warm-up did draw: without the restore the generators would move
    ppo.act(ppo.obs, ())
    assert not torch.equal(ppo.generator.get_state(), states[0])


def _eager_rollout(ppo, T):
    """The rollout as a plain loop of act + env.step with the bookkeeping
    of the rollout step (the rollout before it was captured)."""
    gamma = ppo.cfg.algorithm.gamma
    rows, rec = [], []
    n_done = torch.zeros(())
    term_sums = None
    state, obs, hidden = ppo.env_state, ppo.obs, ppo.hidden
    for _ in range(T):
        action, mu, std, value, logp, hidden = ppo.act(obs, hidden)
        out = ppo.env.step(state, action)
        if ppo.recurrent:
            hidden = ac.reset_hidden(hidden, out.done)
        reward = out.reward + gamma * value * out.time_out.to(value.dtype)
        rows.append(Transition(obs, action, reward, out.done, value, logp,
                               mu, std))
        rec.append(torch.cat([x.reshape(-1).to(obs.dtype) for x in (
            out.record_qpos[0], out.record_qvel[0], action[0], out.done[0],
            out.state.commands[0])]))
        fin = out.finished_episode_sums
        n_done = n_done + torch.sum(~torch.isnan(fin[:, 0]))
        s = torch.nansum(fin, dim=0)
        term_sums = s if term_sums is None else term_sums + s
        state, obs = out.state, out.obs
    traj = Transition(*[torch.stack(xs) for xs in zip(*rows)])
    return traj, n_done, term_sums, torch.stack(rec), (state, obs, hidden)


@pytest.mark.parametrize("policy", ["ActorCritic", "ActorCriticRecurrent"])
def test_rollout_equals_eager_loop(policy):
    T = 16  # env 0 finishes an episode inside it (short episodes below)
    cfg = PPOCfg()
    cfg = cfg.replace(runner=RunnerCfg(num_steps_per_env=T,
                                       policy_class_name=policy),
                      policy=dataclasses.replace(cfg.policy,
                                                 rnn_hidden_size=32))
    env = _env()
    ppo = PPO(env, cfg, record_states=True)
    ppo.init(0)
    ppo.env_state.episode_length[:4] = env.max_episode_length - 5
    gens = [ppo.generator, env.generator]
    g0 = [g.get_state() for g in gens]
    start = clone((ppo.env_state, ppo.obs, ppo.hidden))
    traj_e, n_e, sums_e, rec_e, end_e = _eager_rollout(ppo, T)
    end_e = clone(end_e)
    g_e = [g.get_state() for g in gens]

    for g, s in zip(gens, g0):
        g.set_state(s)
    ppo.set_rollout_state(*start)
    traj, n_done, term_sums, record = ppo.rollout()
    assert _same(traj, traj_e)
    assert bool(traj.done[:, :4].any())
    assert _same((n_done, term_sums), (n_e, sums_e))
    widths = np.cumsum([0, 25, 24, 18, 1, 3])
    host = rec_e.numpy()
    for k, col in enumerate(record):
        want = host[:, widths[k]:widths[k + 1]]
        np.testing.assert_array_equal(col, want[:, 0] > 0.5 if k == 3 else want)
    assert _same((ppo.env_state, ppo.obs, ppo.hidden), end_e)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, g_e))


def test_checkpoint_restores_into_the_rollout_buffers(tmp_path):
    cfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=4))
    ref = PPO(_env(), cfg)
    ref.init(0)
    ref.learn_step()
    path = str(tmp_path / "model_1.pt")
    checkpoint.save(path, ref)
    want = clone(ref.rollout())

    fresh = PPO(_env(seed=3), cfg)
    fresh.init(7)
    fresh.rollout()  # the buffers exist
    buffers = leaves((fresh.env_state, fresh.obs))
    assert checkpoint.load(path, fresh) is True
    assert all(a is b for a, b in zip(leaves((fresh.env_state, fresh.obs)),
                                      buffers))
    got = fresh.rollout()
    assert _same(got, want)
    assert _same((fresh.env_state, fresh.obs), (ref.env_state, ref.obs))


def test_buffers_refuse_another_shape_and_assign_copies():
    x = torch.zeros(3, 2)
    step = CapturedStep(lambda s, a: s + a, x, torch.ones(3, 2))
    out = step(x, torch.ones(3, 2))
    assert out is step.state and float(out.sum()) == 6.0
    assert torch.equal(step(out, torch.ones(3, 2)), torch.full((3, 2), 2.0))
    with pytest.raises(ValueError, match="capture a new step"):
        step(torch.zeros(4, 2), torch.ones(4, 2))

    dst = (torch.zeros(2), (torch.zeros(3),))
    src = (torch.ones(2), (torch.full((3,), 2.0),))
    kept = leaves(dst)
    assert assign(dst, src) is dst
    assert all(a is b for a, b in zip(leaves(dst), kept))
    assert _same(dst, src)
    # other shapes, or two leaves in one memory, take the new tensors
    other = (torch.ones(5), (torch.ones(3),))
    assert assign(dst, other) is other
    z = torch.zeros(2)
    new = (torch.ones(2), torch.full((2,), 3.0))
    assert assign((z, z), new) is new


class HostTransfers(TorchDispatchMode):
    """Records every op that reads a tensor's value to the host (a boolean
    mask's indexing included) or makes a tensor from host data, with the
    innermost line of the port that called
    it; ops called from the kernels' CPU stand-ins (``ops/pgs.py``) and
    from the reductions over the ranks (``parallel/mesh.py``, which run
    between the captured parts) are left out."""

    LEFT_OUT = ("ops/pgs.py", "parallel/mesh.py")

    OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        # indexing with a boolean mask: its length is read to the host
        masked = name.startswith("aten.index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name.startswith(self.OPS) or masked:  # lift_fresh(_copy) too
            ours = [f for f in traceback.extract_stack()
                    if "nightmare_rl_tpu_torch" in f.filename]
            if not any(f.filename.endswith(self.LEFT_OUT) for f in ours):
                self.seen.append((name, f"{ours[-1].filename}:"
                                  f"{ours[-1].lineno}" if ours else "?"))
        return func(*args, **(kwargs or {}))


def _nightmare_step():
    env = _env(4)
    state, _ = env.reset(0)
    acts = _actions(2)

    def call(k):
        nonlocal state
        state = env.step(state, acts[k][:4]).state
    return call


def _anymal_step():
    env = AnymalCEnv(AnymalCCfg(num_envs=4), device="cpu")
    state, _ = env.reset(0)
    a = torch.full((4, 12), 0.1)

    def call(k):
        nonlocal state
        state = env.step(state, a * k).state
    return call


def _with_host_drivers(make):
    """``make``'s step with the smooth and integrate wrappers replaced by
    their kernels' host drivers (``ops/smooth.py::host_forward``,
    ``ops/integrate.py::host_update``), which take the wrappers' own road
    to the kernel (plan, static tables, layout, outputs) on CPU tensors:
    after the warm-up it reads nothing to the host either."""
    def factory():
        if shutil.which("g++") is None:
            pytest.skip("g++ is not installed: the host drivers cannot be built")
        patches = [mock.patch.object(SM, "smooth_forward", SM.host_forward),
                   mock.patch.object(IN, "integrate_update", IN.host_update)]
        for p in patches:
            p.start()
        try:
            call = make()
        except BaseException:
            for p in patches:
                p.stop()
            raise

        def close():
            for p in patches:
                p.stop()
        call.close = close
        return call
    return factory


def _control_step():
    from nightmare_rl_tpu_torch.tools import custom_play

    sys_, cfg, phys, es, limited = custom_play.make(4, device="cpu")
    lin, ang = torch.full((4,), 0.08), torch.zeros(4)
    carry = (phys, es, limited)
    clock = torch.tensor([0.02, 0.04])  # the tool's clock, made once

    def call(k):
        nonlocal carry
        carry = custom_play.control_step(sys_, cfg, *carry, clock[k], lin, ang)
    return call


def _ppo_learn():
    env = _env(4)
    ppo = PPO(env, PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=4)))
    ppo.init(0)
    traj = ppo.rollout()[0]

    def call(k):
        ppo._learn(traj, ppo.obs, ppo.hidden, ())
    return call


def _sharded_learn():
    """The parts of a ``ShardedPPO``'s learning half (``CapturedLearn``, run
    eagerly on the CPU) on an in-process world-1 gloo mesh; the reductions
    between them (``parallel/mesh.py``) are left out of the watch."""
    from nightmare_rl_tpu_torch.parallel import mesh as M
    from nightmare_rl_tpu_torch.rl.ppo import CapturedLearn

    mesh = M.make_mesh(device="cpu")
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=4)),
                         device="cpu", shard=mesh.shard)
    ppo = M.ShardedPPO(env, PPOCfg().replace(
        runner=RunnerCfg(num_steps_per_env=4)), mesh)
    ppo.init(0)
    traj = ppo.rollout()[0]
    inputs = (traj, ppo.obs, ppo.hidden, ())
    cap = ppo._learner(*inputs)
    assert isinstance(cap, CapturedLearn)

    def call(k):
        cap(*inputs)
    call.close = M.close
    return call


def _shard_perm():
    """A rank's permutation at world 2 (``Shard.perm``), which the sharded
    learning half's captured tail draws: the in-process mesh above is a
    world of one, whose permutation takes no mask."""
    from nightmare_rl_tpu_torch.parallel.shard import Shard

    g = torch.Generator().manual_seed(0)

    def call(k):
        Shard(1, 2).perm(4, 3, g, "cpu")
    return call


@pytest.mark.parametrize("make", [_nightmare_step, _anymal_step,
                                  _with_host_drivers(_nightmare_step),
                                  _with_host_drivers(_anymal_step),
                                  _control_step, _ppo_learn, _sharded_learn,
                                  _shard_perm],
                         ids=["nightmare_v3-step", "anymal_c-step",
                              "nightmare_v3-step-host-drivers",
                              "anymal_c-step-host-drivers",
                              "custom_play-control_step", "ppo-update",
                              "sharded-update", "shard-perm"])
def test_step_makes_no_host_transfer(make):
    call = make()
    try:
        call(0)  # the warm-up: caches and constants are made here, as on the card
        watch = HostTransfers()
        with watch:
            call(1)
    finally:
        getattr(call, "close", lambda: None)()  # the sharded case's mesh
    assert not watch.seen, watch.seen
