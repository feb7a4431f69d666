"""The task kernels' per-env arithmetic (nightmare_rl_tpu_torch/ops/csrc/
task_env.cuh, run on the CPU by the host driver csrc/task_host.cpp)
against the plain version (ops/task.py's plain_*_pre and plain_*_post, the
envs' step code), in float64 on inputs made with numpy from a seed.

Every decision (reset, time-out, the contact buffers, the episode count,
the resample) must be equal and every value within 1e-12 of its field's
scale, NaN where the plain version has NaN; the host driver gives the same
bits at team sizes 1, 3 and 32.  The inputs hold an env at each edge: a
time-out at max_episode_length and one step short of it, a foot force at
and just above termination_contact_force, a tilt a hair under and over
60°, the step of a resample, commands at the norm cuts (0.02 for
nightmare_v3, 0.05 and the air-time / stand-still cut 0.1 for anymal_c),
NaN in qvel and in a foot force, tibia and body forces at their limits
(contact modes 1 and 2), first contacts after a swing.  The configs: each
robot's default, nightmare_v3 with the tibia or the body contact mode 2
(the other 1), with the tibia mode 1 alone, with the observation noise, and with the feet_air_time term
active; anymal_c with stand_still active.  The kernels on the card are
held against the same plain version by chip_smoke.py's task-kernel phase.

The host driver and the kernels take the JAX package's semantics through
the plain version, which tests/test_torch_env.py and test_torch_anymal.py
hold against the JAX envs by both routes (the plain version, and the host
driver in its place).
"""

import math

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (EnvCfg, NightmareV3Cfg,
                                                NoiseCfg, RewardScalesCfg,
                                                RewardsCfg)
from nightmare_rl_tpu_torch.envs import anymal_c as anymal_mod
from nightmare_rl_tpu_torch.envs import nightmare_v3 as nightmare_mod
from nightmare_rl_tpu_torch.ops import task
from nightmare_rl_tpu_torch.physics import pipeline

N = 40
TOL = 1e-12          # host driver against the plain version, float64
TEAMS = (1, 3, 32)


def _nightmare(**env_kw):
    cfg = NightmareV3Cfg()
    noise = env_kw.pop("add_noise", False)
    fat = env_kw.pop("feet_air_time", 0.0)
    cfg = cfg.replace(env=EnvCfg(num_envs=N, **env_kw),
                      noise=NoiseCfg(add_noise=noise),
                      rewards=RewardsCfg(scales=RewardScalesCfg(
                          feet_air_time=fat)))
    return nightmare_mod.NightmareV3Env(cfg, dtype=torch.float64,
                                        device="cpu")


def _anymal(**kw):
    return anymal_mod.AnymalCEnv(anymal_mod.AnymalCCfg(num_envs=N, **kw),
                                 dtype=torch.float64, device="cpu")


CONFIGS = {
    "nightmare_v3": lambda: _nightmare(),
    "nightmare_v3 tibia mode 2": lambda: _nightmare(tibia_contact_mode=2),
    "nightmare_v3 body mode 2": lambda: _nightmare(body_contact_mode=2),
    "nightmare_v3 tibia mode 1 alone": lambda: _nightmare(body_contact_mode=0),
    "nightmare_v3 noise": lambda: _nightmare(add_noise=True),
    "nightmare_v3 feet_air_time": lambda: _nightmare(feet_air_time=1.0),
    "anymal_c": lambda: _anymal(),
    "anymal_c stand_still": lambda: _anymal(rew_stand_still=-0.5),
}


def _tilted(theta: float, phi: float) -> np.ndarray:
    """A base quaternion tilted by theta about a horizontal axis."""
    return np.array([math.cos(theta / 2), math.sin(theta / 2) * math.cos(phi),
                     math.sin(theta / 2) * math.sin(phi), 0.0])


def _inputs(env, seed: int):
    """(state, phys, raw actions, actions, draws, noise) of N envs, with an
    env at each edge (see the module docstring)."""
    rng = np.random.default_rng(seed)
    nightmare = isinstance(env, nightmare_mod.NightmareV3Env)
    sys, na = env.sys, env.num_actions
    nf = 6 if nightmare else env.num_feet

    def t(x, dtype=torch.float64):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)

    qpos = np.tile(sys.qpos0.numpy(), (N, 1)) + rng.normal(size=(N, sys.nq)) * 0.1
    quat = rng.normal(size=(N, 4)) * 0.1 + np.array([1.0, 0, 0, 0])
    quat[4] = _tilted(math.pi / 3 - 1e-7, 0.3)
    quat[5] = _tilted(math.pi / 3 + 1e-7, 2.1)
    quat[6] = _tilted(2.5, -1.0)           # fallen over
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = rng.normal(size=(N, sys.nv))
    qvel[11, 6 + 3] = np.nan
    if nightmare:
        sd = np.zeros((N, sys.nsensor))
        sd[:, 0:6] = rng.uniform(0, 4, (N, 6)) * (rng.random((N, 6)) < 0.5)
        sd[:, 6:12] = rng.uniform(0, 150, (N, 6)) * (rng.random((N, 6)) < 0.6)
        sd[:, 12] = rng.uniform(0, 4, N) * (rng.random(N) < 0.5)
        sd[:20, 0:6], sd[:20, 12] = 0.0, 0.0   # the edge envs' own
        feet = sd[:, 6:12]
        limit = env.cfg.env.termination_contact_force
        sd[13, 12] = env.cfg.env.body_max_contact_force
        sd[14, 12] = np.nextafter(env.cfg.env.body_max_contact_force, np.inf)
        sd[15, 0:6], sd[15, 6:12] = env.cfg.env.tibia_max_contact_force, 0.0
        sd[16, 0], sd[16, 6:12] = 3.0, 0.0
    else:
        sd = rng.uniform(0, 300, (N, sys.nsensor)) * (rng.random((N, sys.nsensor)) < 0.6)
        feet = sd[:, :nf]
        limit = env.cfg.termination_contact_force
    feet[2, 1] = limit
    feet[3, 2] = np.nextafter(limit, np.inf)
    feet[12, 0], feet[12, 1] = np.nan, 2 * limit   # NaN wins amax: no reset
    feet[17, :] = 1.0                               # at the contact threshold
    feet[18, :] = np.nextafter(1.0, np.inf)

    phys = pipeline.make_state(sys, N).replace(
        qpos=t(qpos), qvel=t(qvel),
        cvel=t(rng.normal(size=(N, sys.nbody, 6))),
        xipos=t(rng.normal(size=(N, sys.nbody, 3)) * 0.1 + 0.1),
        sensordata=t(sd),
        qfrc_actuator=t(rng.normal(size=(N, sys.nv)) * 10))

    every = env.task_plan.ints["resample_every"]
    length = rng.integers(0, min(every, env.max_episode_length) - 2, N)
    length[0] = env.max_episode_length       # times out
    length[1] = env.max_episode_length - 1
    length[7:11] = every - 1                 # resample
    length[19] = 2 * every - 1
    state = env.init()
    fat = rng.uniform(0, 1.2, (N, nf)) * (rng.random((N, nf)) < 0.5)
    kw = dict(
        episode_length=t(length, torch.int32),
        commands=t(rng.uniform(-0.5, 0.5, (N, 3))),
        actions=t(rng.normal(size=(N, na))),
        dof_vel=t(rng.normal(size=(N, na))),
        feet_air_time=t(fat),
        last_contacts=t(rng.random((N, nf)) < 0.5, torch.bool),
        episode_sums=t(rng.normal(size=(N, len(env.active_rewards)))))
    if nightmare:
        kw.update(dof_pos=t(rng.normal(size=(N, na))),
                  last_contacts_filt=t(rng.random((N, nf)) < 0.5, torch.bool))
    state = state.replace(**kw)

    draws = [t(rng.random(N)) for _ in range(task.DRAWS[env.task_plan.robot])]
    if nightmare:
        # vx of the resample at the 0.02 cut (-0.5 + 1.0 u): under it,
        # over it, at the nearest double over it, at the negative one
        for k, u in zip((7, 8, 9, 10), (0.52 - 1e-12, 0.52 + 1e-12, 0.52,
                                        0.48)):
            draws[0][k] = u
        draws[2][5] = 0.52   # the reset's (env 5 resets)
    else:
        c = env.cfg
        # |(vx, vy)| at the 0.05 cut and at the 0.1 air-time cut
        for k, (norm, d) in zip((7, 8, 9, 10), ((0.05, -1e-12), (0.05, 1e-12),
                                                 (0.1, -1e-12), (0.1, 1e-12))):
            vx, vy = (norm + d) * 0.6, (norm + d) * 0.8
            draws[0][k] = (vx + c.max_lin_vel_x) / (2 * c.max_lin_vel_x)
            draws[1][k] = (vy + c.max_lin_vel_y) / (2 * c.max_lin_vel_y)
    noise = (t(rng.random((N, env.num_obs))) if getattr(
        getattr(env.cfg, "noise", None), "add_noise", False) else None)
    raw = t(rng.normal(size=(N, na)) * 3)
    actions = t(rng.normal(size=(N, na)))
    return state, phys, raw, actions, draws, noise


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    env = CONFIGS[request.param]()
    state, phys, raw, actions, draws, noise = _inputs(env, seed=7)
    ref = task.PLAIN_POST[env.task_plan.robot](env, state, actions, phys,
                                               draws, noise)
    got = {team: task.host_post(env, state, actions, phys, draws, noise,
                                team=team) for team in TEAMS}
    return request.param, env, (state, phys, raw, actions, draws, noise), ref, got


def _held(ref: task.PostOut, got: task.PostOut) -> None:
    for name in task.PostOut._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None:
            assert b is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not a.is_floating_point():
            assert torch.equal(a, b), name
            continue
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        ok = ~torch.isnan(a)
        if ok.any():
            scale = max(1.0, float(a[ok].abs().max()))
            assert float((a[ok] - b[ok]).abs().max()) <= TOL * scale, name


@pytest.mark.parametrize("team", TEAMS)
def test_post_matches_plain(case, team):
    _, _, _, ref, got = case
    _held(ref, got[team])


def test_post_is_the_same_at_every_team_size(case):
    _, _, _, _, got = case
    first = got[TEAMS[0]]
    for team in TEAMS[1:]:
        for a, b in zip(first, got[team]):
            if a is not None:
                assert torch.equal(a.isnan(), b.isnan())
                assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_edges_are_reached(case):
    """The inputs decide each edge both ways, as the plain version does."""
    name, env, _, ref, _ = case
    reset, time_out = ref.reset.tolist(), ref.time_out.tolist()
    assert time_out[0] and not time_out[1]
    assert reset[0] and reset[3] and reset[5] and reset[6]
    assert not reset[4] and not reset[12]
    if name.startswith("nightmare_v3"):
        assert not reset[2]
        if "tibia mode 2" in name:
            assert not reset[15] and reset[16]
        if "body mode 2" in name:
            assert not reset[13] and reset[14]
        vx = ref.commands[7:11, 0].tolist()
        assert vx[0] == 0.0 and vx[1] > 0.02 and vx[2] > 0.02 and vx[3] < -0.02
    else:
        moving = torch.linalg.vector_norm(ref.commands[7:11, :2], dim=1)
        assert float(moving[0]) == 0.0 and float(moving[1]) > 0.05
        assert 0.0 < float(moving[2]) <= 0.1 < float(moving[3])


@pytest.mark.parametrize("robot", ["nightmare_v3", "anymal_c"])
def test_pre_matches_plain(robot):
    env = CONFIGS[robot]()
    state, _, raw, _, _, _ = _inputs(env, seed=8)
    raw[0, 0], raw[1, 1] = np.nan, 1e3
    ref = task.PLAIN_PRE[env.task_plan.robot](env, state, raw)
    for team in TEAMS:
        got = task.host_pre(env, state, raw, team=team)
        for a, b in zip(ref, got):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("cfg_kw, why", [
    (dict(tibia_contact_mode=3), "tibia_contact_mode"),
    (dict(tibia_contact_mode=0, body_contact_mode=2), "body_contact_forces"),
    (dict(num_obs=65), "observations"),
    (dict(tracking_sigma=0.0), "division"),
])
def test_refuses_a_config_it_does_not_take(cfg_kw, why):
    """On every device, at the env's construction, never at a step."""
    with pytest.raises(ValueError, match=why):
        if "tracking_sigma" in cfg_kw:
            anymal_mod.AnymalCEnv(anymal_mod.AnymalCCfg(num_envs=N, **cfg_kw),
                                  device="cpu")
        else:
            _nightmare(**cfg_kw)


def test_counts_only_kernel_launches_and_refuses_other_devices():
    env = CONFIGS["anymal_c"]()
    state, phys, raw, actions, draws, _ = _inputs(env, seed=9)
    before = (task.pre.launches, task.post.launches)
    task.pre(env, state, raw)
    task.post(env, state, actions, phys, draws)
    assert (task.pre.launches, task.post.launches) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        task.pre(env, state, raw.to("meta"))
    with pytest.raises(ValueError, match="command draws"):
        task.host_post(env, state, actions, phys, draws[:4])


def test_plain_post_is_the_env_step():
    """The env's step is pre, pipeline.step and post: its StepOut carries
    post's outputs and the pipeline's pre-reset qpos and qvel."""
    env = CONFIGS["nightmare_v3"]()
    s, _ = env.reset(0)
    g = env.generator.get_state()
    act = torch.from_numpy(np.random.default_rng(3).normal(size=(N, 18)))
    out = env.step(s, act)
    env.generator.set_state(g)
    actions, ctrl = task.pre(env, s, act)
    phys = pipeline.step(env.sys, s.phys, ctrl, env.cfg.control.decimation)
    post = task.post(env, s, actions, phys, env._command_draws(N))
    assert torch.equal(out.record_qpos, phys.qpos)
    assert torch.equal(out.obs, post.obs) and torch.equal(out.done, post.reset)
    assert torch.equal(out.state.phys.qpos, post.qpos)
