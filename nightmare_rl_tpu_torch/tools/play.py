"""Run a trained policy in the port's env and, optionally, replay it in the
host-side MuJoCo viewer (port of ``nightmare_rl_tpu/tools/play.py``).

    python -m nightmare_rl_tpu_torch.tools.play --ckpt artifacts/model_3176.pt \\
        [--vx 0.3] [--wz 0.0] [--steps 500] [--stochastic] [--out traj.pkl] \\
        [--grid] [--view --xml path/to/mjmodel.xml] [--device cpu]

``--ckpt`` takes a ``.pt``: the reference's rsl_rl format or a checkpoint of
the port's trainer.  A JAX (orbax) checkpoint directory reaches the port
through the JAX package's exporter, ``python -m
nightmare_rl_tpu.tools.export_torch --ckpt DIR --out model.pt``.

The command is pinned before each step, as in the JAX tool; at a resampling
step the env still writes a freshly sampled command into that step's obs
(the reference's behaviour, mirrored).  Deterministic mode acts with the
policy mean (``act_inference``); ``--stochastic`` samples with a
``torch.Generator`` seeded 17.  ``--grid`` runs one env per command of the
command envelope, in lockstep.  Runs on the card unless ``--device cpu``;
there each step of the loop is the replay of a CUDA graph (``player``).
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg, PPOCfg
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import CapturedStep

# the command envelope of --grid: vx ±0.3, wz ±0.4, combined, zero
GRID = np.array([
    [+0.3, 0.0, 0.0],
    [-0.3, 0.0, 0.0],
    [0.0, 0.0, +0.4],
    [0.0, 0.0, -0.4],
    [+0.3, 0.0, +0.4],
    [+0.3, 0.0, -0.4],
    [0.0, 0.0, 0.0],
], np.float32)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default=None,
                   help="policy .pt (rsl_rl format or a checkpoint of the "
                        "port's trainer); random policy if unset.  A JAX "
                        "orbax directory must first be exported with "
                        "python -m nightmare_rl_tpu.tools.export_torch")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--vx", type=float, default=0.3)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--view", action="store_true",
                   help="replay in mujoco.viewer (needs a display and --xml)")
    p.add_argument("--live", action="store_true",
                   help="interactive viewer + keyboard teleop while the "
                        "policy runs (needs a display and --xml; keys è/à = "
                        "vx±, ò/ù = wz± like the reference play.py:36-47)")
    p.add_argument("--xml", type=str, default=None,
                   help="the robot's MJCF, for --view and --live")
    p.add_argument("--out", type=str, default=None,
                   help="save the trajectory to this .pkl or .npz")
    p.add_argument("--stochastic", action="store_true",
                   help="sample actions from the policy distribution like "
                        "the reference's play.py:122 does; default is the "
                        "deterministic mean")
    p.add_argument("--grid", action="store_true",
                   help="batched command-envelope eval: one env per command "
                        "over {vx±0.3, wz±0.4, combined, zero}")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def load_policy(path: Optional[str], env) -> ActorCritic:
    """The actor-critic of ``path`` (None: a random policy, seeded 0) on the
    env's device and dtype."""
    pol = PPOCfg().policy
    # the random init draws from a forked RNG: the caller's stays as it was
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = ActorCritic(env.num_obs, env.num_actions,
                          actor_hidden=pol.actor_hidden_dims,
                          critic_hidden=pol.critic_hidden_dims,
                          activation=pol.activation)
    if path is not None:
        if os.path.isdir(path):
            raise SystemExit(
                f"{path} is a directory (a JAX orbax checkpoint?); export it "
                "first: python -m nightmare_rl_tpu.tools.export_torch --ckpt "
                f"{path} --out model.pt")
        blob = torch.load(path, map_location="cpu", weights_only=True)
        net.load_state_dict(blob.get("model_state_dict", blob))
    return net.to(device=env.device, dtype=env.dtype).eval()


def hexapod_rows(out) -> dict:
    """The record rows of one nightmare_v3 step: qpos, qvel, obs, vel (the
    body-frame velocities the tracking rewards see), feet (foot touch
    forces), done and time_out."""
    return dict(
        # obs[0:3] is lin_vel * 2.0, obs[3:6] is ang_vel * 0.25 (obs scales,
        # reference nightmare_v3_config.py:67-72)
        vel=torch.cat([out.obs[:, :3] / 2.0, out.obs[:, 3:6] / 0.25], dim=1),
        # foot touch sensors (sensordata slots 6:12, mjmodel.xml:156-170)
        feet=out.state.phys.sensordata[:, 6:12],
        qpos=out.state.phys.qpos, qvel=out.state.phys.qvel, obs=out.obs,
        done=out.done, time_out=out.time_out)


class _Rows(NamedTuple):
    """The fields of a step's output that a record's rows read: a reset's
    state and observations stand in for a step's to size the record."""
    state: object
    obs: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor


def player(env, net, cmd, steps: int,
           generator: Optional[torch.Generator] = None,
           rows: Callable[..., dict] = hexapod_rows):
    """The play loop of ``steps`` steps of ``env`` under ``net`` with the
    command ``cmd`` (N, 3) pinned before each step, as a function
    ``run(state, obs) -> (state, obs, record)``.  One step (the pin, the
    policy, ``env.step`` and the step's record rows, written at an index
    kept on the device) is captured once as a CUDA graph on the card
    (``utils/graph.py``) and replayed; ``run`` may be called again, and
    the command tensor it reads is the one returned as ``run.cmd`` (write
    it with ``copy_``).  ``rows(out)`` gives a step's rows by name, each
    (N, ...) (default ``hexapod_rows``); the record holds them as host
    arrays (T, N, ...), copied once at the end of a call.  Deterministic
    without ``generator`` (``act_inference``), else ``mu + std · noise``
    drawn from it."""
    dev, dt = env.device, env.dtype
    cmd = torch.as_tensor(cmd, dtype=dt, device=dev).clone()
    rec = {}

    @torch.no_grad()
    def step(carry):
        state, obs, t = carry
        state = state.replace(commands=cmd)
        if generator is None:
            act = net.act_inference(obs)
        else:
            mu, std, _ = net(obs)
            act = mu + std * torch.randn(mu.shape, generator=generator,
                                         dtype=mu.dtype, device=mu.device)
        out = env.step(state, act)
        for k, x in rows(out).items():
            rec[k].index_copy_(0, t, x[None])
        return out.state, out.obs, t + 1

    t0 = torch.zeros(1, dtype=torch.long, device=dev)
    captured = None

    def run(state, obs):
        nonlocal captured
        if captured is None:  # the first call's state is the example
            done = torch.zeros(env.num_envs, dtype=torch.bool, device=dev)
            rec.update({k: torch.empty((steps,) + x.shape, dtype=x.dtype,
                                       device=dev)
                        for k, x in rows(_Rows(state, obs, done, done)).items()})
            captured = CapturedStep(step, (state, obs, t0),
                                    generators=(env.generator, generator))
        carry = (state, obs, t0)
        for _ in range(steps):
            carry = captured(carry)
        return carry[0], carry[1], {k: v.cpu().numpy() for k, v in rec.items()}

    run.cmd = cmd
    return run


def rollout(env, net, state, obs, cmd, steps: int,
            generator: Optional[torch.Generator] = None,
            rows: Callable[..., dict] = hexapod_rows):
    """Step ``env`` under ``net`` for ``steps`` steps with ``cmd`` (N, 3)
    pinned before each step (``player``).  Returns (state, obs, record)."""
    return player(env, net, cmd, steps, generator, rows)(state, obs)


def _settle(env, steps: int) -> int:
    """Steps skipped before averaging: the first second (reset transient)."""
    return min(int(1.0 / env.dt), steps // 2)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.grid:
        return grid_eval(args.ckpt, args.steps, args.stochastic, device)
    if args.live:
        live_teleop(args, device)
        return {}

    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=1)),
                         device=device)
    net = load_policy(args.ckpt, env)
    if args.ckpt:
        print(f"loaded {args.ckpt}")
    state, obs = env.reset(0)
    cmd = torch.tensor([[args.vx, 0.0, args.wz]])
    gen = (torch.Generator(device=device).manual_seed(17)
           if args.stochastic else None)
    state, obs, rec = rollout(env, net, state, obs, cmd, args.steps, gen)

    traj = [(k * env.dt, rec["qpos"][k, 0].astype(np.float64),
             rec["qvel"][k, 0].astype(np.float64), np.zeros(0))
            for k in range(args.steps)]
    done, time_out = rec["done"][:, 0], rec["time_out"][:, 0]
    falls, timeouts = int((done & ~time_out).sum()), int((done & time_out).sum())
    vels = rec["vel"][:, 0]
    settle = _settle(env, len(vels))
    vx_mean, wz_mean = vels[settle:, 0].mean(), vels[settle:, 5].mean()
    # the reward tracks the full ‖Δv_xy‖, so report body-frame vy error plus
    # the world-frame lateral drift and heading drift vx/wz can hide
    vy_mean = vels[settle:, 1].mean()
    qpos_final = rec["qpos"][-1, 0]
    w, x, y, z = qpos_final[3:7]
    yaw_final = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    print(f"rolled out {args.steps} steps ({args.steps * env.dt:.1f} s); "
          f"final base pos {qpos_final[:3].round(3)}")
    print(f"eval: cmd vx={args.vx:+.2f} wz={args.wz:+.2f} | achieved "
          f"vx={vx_mean:+.3f} vy={vy_mean:+.3f} wz={wz_mean:+.3f} "
          f"(mean after {settle} steps) | falls={falls} timeouts={timeouts}")
    print(f"drift: lateral y={qpos_final[1]:+.3f} m "
          f"(vy err {vy_mean:+.3f} m/s vs cmd 0) | "
          f"heading {np.degrees(yaw_final):+.1f} deg"
          + ("" if abs(args.wz) > 1e-6 else " (vs cmd 0)"))
    print_gait_metrics(rec["feet"][settle:, 0], rec["qpos"][settle:, 0, 2],
                       env.dt)

    if args.out:
        if args.out.endswith(".npz"):
            from nightmare_rl_tpu_torch.tools.replay import save_npz

            save_npz(args.out, traj)
        else:  # reference-compatible pkl (open_custom_play.py reads it)
            with open(args.out, "wb") as f:
                pickle.dump(traj, f)
        print(f"saved trajectory to {args.out}")
    if args.view:
        replay_in_viewer(traj, xml=args.xml)
    return {"traj": traj, "record": rec, "falls": falls, "timeouts": timeouts,
            "vx": float(vx_mean), "vy": float(vy_mean), "wz": float(wz_mean)}


def grid_eval(ckpt: Optional[str], steps: int, stochastic: bool = False,
              device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Command-envelope eval: one env per grid command, stepped in lockstep.
    This is the teleop envelope the reference demos by hand (play.py:36-47
    binds keys to vx AND ωz).  Prints achieved vx/vy/wz against the command,
    falls and base height per row; returns the rows and the record."""
    G = len(GRID)
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=G)),
                         dtype=dtype, device=device)
    net = load_policy(ckpt, env)
    print(f"grid eval: {ckpt or 'random policy'} | {G} commands x "
          f"{steps} steps ({steps * env.dt:.1f} s), "
          f"{'stochastic' if stochastic else 'deterministic mean'}")
    state, obs = env.reset(0)
    gen = (torch.Generator(device=env.device).manual_seed(17)
           if stochastic else None)
    _, _, rec = rollout(env, net, state, obs, torch.from_numpy(GRID), steps,
                        gen)
    falls = (rec["done"] & ~rec["time_out"]).sum(axis=0)
    settle = _settle(env, steps)
    v, zs = rec["vel"][settle:], rec["qpos"][settle:, :, 2]
    print(f"{'cmd vx':>7} {'wz':>6} | {'vx':>7} {'vy':>7} {'wz':>7} |"
          f" {'vx%':>5} {'wz%':>5} | {'falls':>5} {'base_z':>6}")
    rows = []
    for i, (cvx, _, cwz) in enumerate(GRID):
        ax, ay, az = v[:, i, 0].mean(), v[:, i, 1].mean(), v[:, i, 5].mean()
        pvx = 100 * ax / cvx if abs(cvx) > 1e-6 else float("nan")
        pwz = 100 * az / cwz if abs(cwz) > 1e-6 else float("nan")
        print(f"{cvx:+7.2f} {cwz:+6.2f} | {ax:+7.3f} {ay:+7.3f} {az:+7.3f} |"
              f" {pvx:5.0f} {pwz:5.0f} | {falls[i]:5d}"
              f" {zs[:, i].mean():6.3f}")
        rows.append(dict(cmd_vx=float(cvx), cmd_wz=float(cwz), vx=float(ax),
                         vy=float(ay), wz=float(az), vx_pct=float(pvx),
                         wz_pct=float(pwz), falls=int(falls[i]),
                         base_z=float(zs[:, i].mean())))
    return {"rows": rows, "record": rec, "settle": settle, "dt": env.dt}


def print_gait_metrics(feet_force, base_z, dt: float) -> str:
    """Gait-quality summary from foot touch forces + base height: a
    tracking-only eval cannot tell a gait from a crouching shuffle; these
    numbers can.  A healthy engine walk (tools/custom_play.py) shows duty
    ~0.5-0.8 per foot with regular swings, alternating tripods, base height
    ~0.09 m; a stander shows duty 1.0, zero swings, alternation ~0.

    feet_force: (T, 6) touch forces, base_z: (T,), both post-settle.
    Prints the summary line and returns it."""
    contact = feet_force > 1e-6                       # (T, 6)
    duty = contact.mean(axis=0)
    # swing (air-time) episodes per foot: runs of no-contact
    swing_counts, air_times = [], []
    for leg in range(contact.shape[1]):
        c = contact[:, leg]
        starts = np.flatnonzero(~c[1:] & c[:-1]) + 1  # contact -> air
        ends = np.flatnonzero(c[1:] & ~c[:-1]) + 1    # air -> contact
        swing_counts.append(len(starts))
        for s in starts:
            e = ends[ends > s]
            if len(e):
                air_times.append((e[0] - s) * dt)
    # tripod alternation: the gait engine's tripod groups are legs (1,3,5)
    # vs (2,4,6) (nikengine/engine.py:215, sensor order leg_1..6) —
    # anticorrelated support = alternating gait, 0 = static stance
    a = contact[:, [0, 2, 4]].mean(axis=1)
    b = contact[:, [1, 3, 5]].mean(axis=1)
    altern = float(np.mean(np.abs(a - b)))
    air = np.asarray(air_times) if air_times else np.zeros(1)
    line = (
        "gait: duty=" + "/".join(f"{d:.2f}" for d in duty)
        + f" | swings/foot={np.mean(swing_counts):.1f}"
        + f" | air_time mean={air.mean():.3f}s p90={np.quantile(air, 0.9):.3f}s"
        + f" | feet_down mean={contact.sum(axis=1).mean():.2f}"
        + f" | tripod_alternation={altern:.2f}"
        + f" | base_z mean={base_z.mean():.3f} min={base_z.min():.3f}"
    )
    print(line)
    return line


def draw_command_arrow(viewer, qpos, cmd) -> None:
    """Draw the commanded-velocity arrow in the viewer's user scene, like the
    reference does during policy play (play.py:143-156): world-frame vector =
    base_quat · [vx, −ωz, 0], white arrow anchored 0.5 m above the base."""
    import mujoco as mj

    vec = np.array([cmd[0], -cmd[2], 0.0])
    mj.mju_rotVecQuat(vec, vec, np.asarray(qpos[3:7], np.float64))
    scn = viewer.user_scn
    scn.ngeom = 0
    if np.linalg.norm(vec) < 1e-6:
        return
    base = np.array([qpos[0], qpos[1], qpos[2] + 0.5])
    g = scn.geoms[0]
    mj.mjv_initGeom(
        g, type=mj.mjtGeom.mjGEOM_ARROW,
        size=np.array([0.02, 0.02, 1.0]),
        pos=np.zeros(3), mat=np.eye(3).flatten(),
        rgba=np.array([1.0, 1.0, 1.0, 1.0], np.float32),
    )
    mj.mjv_connector(g, mj.mjtGeom.mjGEOM_ARROW, 0.02, base, base + vec)
    scn.ngeom = 1


def _require_xml(xml: Optional[str]) -> str:
    if xml is None:
        raise SystemExit("the viewer needs the robot's MJCF: pass --xml "
                         "path/to/mjmodel.xml")
    return xml


def live_teleop(args, device) -> None:
    """Interactive policy teleop: the policy steps the port's physics while
    a passive mujoco.viewer mirrors env 0 by state injection and pynput keys
    adjust the velocity command (reference play.py:36-47,141-171)."""
    import time as _time

    import mujoco as mj
    import mujoco.viewer as mjv
    from pynput import keyboard

    xml = _require_xml(args.xml)
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=1)),
                         device=device)
    net = load_policy(args.ckpt, env)
    cmd = np.array([0.0, 0.0, 0.0], np.float32)

    def on_press(key):
        try:
            c = key.char
        except AttributeError:
            return
        if c == "è":
            cmd[0] += 0.1
        elif c == "à":
            cmd[0] -= 0.1
        elif c == "ò":
            cmd[2] += 0.1
        elif c == "ù":
            cmd[2] -= 0.1

    keyboard.Listener(on_press=on_press).start()
    m = mj.MjModel.from_xml_path(xml)
    d = mj.MjData(m)
    state, obs = env.reset(0)
    run = player(env, net, torch.from_numpy(cmd[None].copy()), 1)
    with mjv.launch_passive(m, d) as viewer:
        frames, t0 = 0, _time.time()
        while viewer.is_running():
            run.cmd.copy_(torch.from_numpy(cmd[None].copy()))
            state, obs, rec = run(state, obs)
            d.qpos[:] = rec["qpos"][0, 0]
            d.qvel[:] = rec["qvel"][0, 0]
            mj.mj_forward(m, d)
            draw_command_arrow(viewer, d.qpos, cmd)
            viewer.cam.lookat = d.qpos[:3]
            viewer.sync()
            frames += 1
            if frames % 1000 == 0:
                print(f"fps {1000 / (_time.time() - t0):.1f} cmd {cmd}")
                t0 = _time.time()
            _time.sleep(max(0.0, env.dt - 0.001))


def replay_in_viewer(traj, xml: Optional[str], rate: float = 1.0) -> None:
    """Host-side visualization by state injection (open_custom_play.py:50-66)."""
    import time as _time

    import mujoco as mj
    import mujoco.viewer as mjv

    m = mj.MjModel.from_xml_path(_require_xml(xml))
    d = mj.MjData(m)
    with mjv.launch_passive(m, d) as viewer:
        t_prev = None
        for (t, qpos, qvel, _act) in traj:
            d.qpos[:] = qpos
            d.qvel[:] = qvel
            mj.mj_forward(m, d)
            viewer.sync()
            if t_prev is not None:
                _time.sleep(max(0.0, (t - t_prev) / rate))
            t_prev = t


if __name__ == "__main__":
    main()
