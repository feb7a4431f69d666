"""The port's MJCF compiler (``physics/loader.py``: ``system_from_mjmodel``,
``save_system``, ``load_system``; ``tools/compile_model.py``) against the
JAX package's, on inline MJCF models.

Field by field, the port's System equals the JAX one: static fields
exactly, integer and boolean arrays exactly, floats to 1e-12.  Both
packages' ``save_system`` write the same archive (keys in one order, dtypes
and values, the static JSON blob byte for byte), and an archive of either
loads equal in the other.  The models cover a plane with sphere, capsule,
cylinder and box geoms, inline meshes with a per-name
``max_points_per_geom`` dict and a foot site that takes priority, touch
sensors and synthesized ones, condim 3/4/6, pyramidal and elliptic cones,
PGS and Newton, self-collision pairs and a ``<contact><exclude>``,
actuators with ranges, and the Euler and implicitfast integrators.
"""

import dataclasses
import os
import subprocess
import sys

import mujoco as mj
import numpy as np
import pytest
import torch

from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu_torch.physics import loader
from nightmare_rl_tpu_torch.tools import compile_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_TOL = 1e-12

PRIMITIVES = """
<mujoco>
  <option solver="PGS" cone="pyramidal" iterations="7" noslip_iterations="3"
          impratio="3" timestep="0.004"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" friction="0.9 0.01 0.002"/>
    <body name="torso" pos="0 0 0.3">
      <freejoint/>
      <geom name="hull" type="box" size="0.2 0.1 0.05" mass="3"/>
      <body name="thigh" pos="0.2 0 0">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1 1"
               damping="0.3" armature="0.01" frictionloss="0.1"/>
        <geom name="shank" type="capsule" fromto="0 0 0 0.1 0 -0.2"
              size="0.03" condim="4" priority="1"
              friction="0.7 0.02 0.003"/>
        <body name="foot" pos="0.1 0 -0.2">
          <joint name="knee" type="slide" axis="0 0 1" range="-0.05 0.05"/>
          <geom name="toe" type="sphere" size="0.03" condim="6"
                solref="0.01 1" solimp="0.8 0.9 0.002 0.5 2"/>
          <site name="toe_site" type="sphere" size="0.04"/>
        </body>
      </body>
      <body name="arm" pos="-0.2 0 0">
        <joint name="shoulder" type="hinge" axis="1 0 0"/>
        <geom name="drum" type="cylinder" size="0.04 0.08"
              euler="0 90 0" condim="3"/>
        <site name="drum_site" type="box" size="0.1 0.1 0.1"/>
      </body>
    </body>
    <body name="ball" pos="1 0 0.2">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.05"/>
    </body>
    <body name="ball2" pos="1.2 0 0.2">
      <freejoint/>
      <geom name="ball2" type="sphere" size="0.05"/>
    </body>
  </worldbody>
  <contact>
    <exclude body1="ball" body2="ball2"/>
  </contact>
  <actuator>
    <position joint="hip" kp="20" ctrlrange="-0.5 0.5"/>
    <velocity joint="knee" kv="3" forcerange="-5 5"/>
    <motor joint="shoulder" gear="2" ctrllimited="false"/>
  </actuator>
  <sensor>
    <touch site="toe_site"/>
    <touch site="drum_site"/>
  </sensor>
</mujoco>
"""

_SHELL = ("0 0 0  0.2 0 0  0 0.1 0  0 0 0.05  0.2 0.1 0  0.2 0 0.05  "
          "0 0.1 0.05  0.2 0.1 0.05  0.1 0.05 -0.02")
MESHES = f"""
<mujoco>
  <option solver="Newton" cone="elliptic" iterations="20" ls_iterations="6"
          impratio="50" integrator="implicitfast"/>
  <asset>
    <mesh name="shell" vertex="{_SHELL}"/>
    <mesh name="tip" vertex="0 0 0  0.05 0 0  0 0.05 0  0 0 -0.1"/>
  </asset>
  <worldbody>
    <geom type="plane" size="0 0 1" condim="6"/>
    <body name="base" pos="0 0 0.4">
      <freejoint/>
      <geom name="base_shell" type="mesh" mesh="shell" pos="0.01 0 0"
            euler="0 0 30"/>
      <body name="leg" pos="0.1 0 -0.05">
        <joint type="hinge" axis="0 1 0" range="-0.7 0.7" limited="true"/>
        <geom name="leg_tip" type="mesh" mesh="tip" condim="4"/>
        <site name="tip_site" type="sphere" size="0.01" pos="0 0 -0.1"/>
        <body name="paw" pos="0 0 -0.12">
          <joint type="hinge" axis="1 0 0"/>
          <geom name="paw" type="sphere" size="0.02" condim="3"/>
        </body>
      </body>
      <body name="tail" pos="-0.1 0 0">
        <joint type="ball"/>
        <geom name="tail_shell" type="mesh" mesh="shell" condim="3"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

NEWTON_PYRAMIDAL = PRIMITIVES.replace(
    '<option solver="PGS" cone="pyramidal" iterations="7" noslip_iterations="3"',
    '<option solver="Newton" cone="pyramidal" iterations="9" '
    'noslip_iterations="2" ls_iterations="30"').replace(
    'timestep="0.004"/>',
    'timestep="0.004"><flag eulerdamp="disable"/></option>')

MODELS = {
    "primitives-pgs": (PRIMITIVES, 8),
    "meshes-newton-elliptic": (MESHES, {"base_shell": 5, "*": 3}),
    "meshes-int-cap": (MESHES, 4),
    "primitives-newton-pyramidal": (NEWTON_PYRAMIDAL, 8),
}


def _compile(name):
    xml, maxp = MODELS[name]
    m = mj.MjModel.from_xml_string(xml)
    return (m, jloader.system_from_mjmodel(m, max_points_per_geom=maxp),
            loader.system_from_mjmodel(m, max_points_per_geom=maxp,
                                       device="cpu"))


def _assert_same(jsys, tsys):
    for f in dataclasses.fields(jsys):
        a, b = getattr(jsys, f.name), getattr(tsys, f.name)
        if isinstance(b, torch.Tensor):
            a = np.asarray(a)
            b = b.numpy()
            assert a.shape == b.shape, (f.name, a.shape, b.shape)
            if np.issubdtype(a.dtype, np.floating):
                assert b.dtype == np.float64, f.name
                np.testing.assert_allclose(b, a, rtol=FLOAT_TOL,
                                           atol=FLOAT_TOL, err_msg=f.name)
            else:
                assert b.dtype == (bool if a.dtype == bool else np.int64), f.name
                np.testing.assert_array_equal(b, a, err_msg=f.name)
        elif a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(a, np.ndarray):  # an int the JAX loader read as 0-d
            assert a.shape == () and type(b) is int and int(a) == b, f.name
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)
            if isinstance(a, tuple):
                assert all(type(x) is int for x in a), f.name


def _assert_same_archive(path_a, path_b):
    A, B = np.load(path_a), np.load(path_b)
    assert A.files == B.files
    for k in A.files:
        assert A[k].dtype == B[k].dtype, k
        np.testing.assert_array_equal(A[k], B[k], err_msg=k)
    assert bytes(A["__static__"]) == bytes(B["__static__"])


@pytest.mark.parametrize("name", list(MODELS))
def test_compiler_matches_jax(name):
    m, jsys, tsys = _compile(name)
    _assert_same(jsys, tsys)
    assert tsys.ncp > 0 and tsys.device.type == "cpu"


def test_models_cover_the_features():
    _, _, prim = _compile("primitives-pgs")
    assert sorted(set(prim.cpoint_condim)) == [3, 4, 6]
    assert prim.solver_type == 0 and prim.cone == 0
    assert prim.nsensor == 2 and max(prim.cpoint_sensor) == 1
    assert len(prim.cpair_a) > 0          # self-collision candidates
    assert float(prim.actuator_forcelimited.sum()) == 1
    _, _, mesh = _compile("meshes-newton-elliptic")
    assert mesh.solver_type == 2 and mesh.cone == 1 and mesh.integrator == 1
    assert mesh.nsensor == 1              # synthesized for the sphere paw
    counts = {}
    for b in mesh.cpoint_bodyid:
        counts[b] = counts.get(b, 0) + 1
    assert list(counts.values()) == [5, 3, 1, 3]  # dict cap, paw, '*' cap
    _, _, capped = _compile("meshes-int-cap")
    assert capped.ncp == 4 + 4 + 1 + 4
    _, _, newton = _compile("primitives-newton-pyramidal")
    assert newton.solver_type == 2 and newton.cone == 0
    assert newton.eulerdamp is False and newton.ls_iterations == 30


@pytest.mark.parametrize("name", list(MODELS))
def test_archives_load_in_both_packages(name, tmp_path):
    _, jsys, tsys = _compile(name)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jloader.save_system(jsys, jpath)
    loader.save_system(tsys, tpath)
    _assert_same_archive(jpath, tpath)
    # the port's archive in the JAX loader, the JAX archive in the port's
    _assert_same(jloader.load_system(tpath),
                 loader.load_system(jpath, device="cpu"))
    _assert_same(jsys, loader.load_system(jpath, device="cpu"))
    # a float32 System saves float32 arrays, as the JAX package's does
    t32 = loader.load_system(tpath, dtype=torch.float32, device="cpu")
    loader.save_system(t32, str(tmp_path / "f32.npz"))
    assert np.load(str(tmp_path / "f32.npz"))["body_mass"].dtype == np.float32


def test_bundled_archives_round_trip(tmp_path):
    """The shipped archives saved by the port load equal in the JAX loader
    (their blobs predate ``ls_refine``, which both loaders default)."""
    for name in ("nightmare_v3", "anymal_c"):
        tsys = loader.load_system(name, device="cpu")
        path = str(tmp_path / f"{name}.npz")
        loader.save_system(tsys, path)
        _assert_same(jloader.load_system(path), tsys)
        _assert_same(jloader.load_system(name), tsys)


def test_compile_model_cli(tmp_path, capsys):
    """--xml/--out writes the archive the JAX compiler makes; without
    --out it goes beside the MJCF."""
    xml = tmp_path / "model.xml"
    xml.write_text(MODELS["meshes-newton-elliptic"][0])
    out = tmp_path / "out" / "explicit.npz"
    out.parent.mkdir()
    compile_model.main(["--xml", str(xml), "--out", str(out),
                        "--max-points", "5"])
    assert f"-> {out}" in capsys.readouterr().out
    m = mj.MjModel.from_xml_path(str(xml))
    jsys = jloader.system_from_mjmodel(m, max_points_per_geom=5)
    jloader.save_system(jsys, str(tmp_path / "jax.npz"))
    _assert_same_archive(str(tmp_path / "jax.npz"), str(out))
    _assert_same(jsys, loader.load_system(str(out), device="cpu"))

    compile_model.main(["--xml", str(xml)])          # --max-points 6
    beside = loader.load_system(str(tmp_path / "model.npz"), device="cpu")
    _assert_same(jloader.system_from_mjmodel(m, max_points_per_geom=6), beside)


@pytest.mark.parametrize("name", ["spheres_condim6", "hinge_dof_rows"])
def test_bundled_mjcf_assets_match_their_archives(name, tmp_path):
    """The port's MJCF assets (which chip_smoke.py steps on the card)
    compile, in both packages, to the archives committed beside them."""
    xml = os.path.join(REPO, "nightmare_rl_tpu_torch", "assets", name + ".xml")
    m = mj.MjModel.from_xml_path(xml)
    jloader.save_system(jloader.system_from_mjmodel(m, max_points_per_geom=6),
                        str(tmp_path / "jax.npz"))
    _assert_same_archive(str(tmp_path / "jax.npz"), xml[:-4] + ".npz")


def test_loader_imports_no_mujoco():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.physics.loader\n"
            "import nightmare_rl_tpu_torch.tools.compile_model\n"
            "assert 'mujoco' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
