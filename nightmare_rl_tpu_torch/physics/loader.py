"""MJCF → System compiler and System archives (port of
``nightmare_rl_tpu/physics/loader.py``).

The compiler uses the installed ``mujoco`` package as an MJCF front-end
(mass and inertia from meshes, joint/actuator/site tables,
``body_invweight0``) and derives the port's collision representation from
it: body-attached candidate contact points (support vertices of collision
meshes, sphere centres, capsule and cylinder axis ends), tested against the
ground plane at run time.  It runs on the host; ``mujoco`` is imported inside
the functions that need it, so the runtime never imports it.

An archive (``.npz``) holds a JSON ``__static__`` blob (sizes, topology,
options) and one array per numeric field.  ``save_system`` writes the same
keys, dtypes and blob as the JAX package's, so an archive of either package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import resolve_device

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")

# fields that the archive stores as arrays but the System keeps as ints
_INT_OPTIONS = ("max_pair_contacts",)
# integer arrays whose archive dtype is not int64 (the System holds int64)
_ARCHIVE_INTS = {"cpair_a": np.int32, "cpair_b": np.int32}
# fields written to the JSON blob (the JAX package's list, same order)
_STATIC_FIELDS = [
    "nq", "nv", "nu", "nbody", "njnt", "nsite", "nsensor", "ncp",
    "body_parent", "body_jntadr", "body_jntnum", "jnt_type", "jnt_bodyid",
    "jnt_qposadr", "jnt_dofadr", "dof_bodyid", "actuator_trnid",
    "site_bodyid", "cpoint_bodyid", "cpoint_sensor", "integrator",
    "solver_iterations", "noslip_iterations", "max_contacts", "eulerdamp",
    "cpoint_condim", "impratio", "solver_type", "cone", "ls_iterations",
    "ls_refine",
]

# Support-point directions for mesh → contact-point reduction, in priority
# order (earlier directions are kept first): the ±z extremes (resting
# contact), then cube corners, then the remaining axes.  Directions toward
# small touch-sensor sites (foot tips) are put before them per body, so the
# sensor-relevant vertices always survive the cap.
_DIRS = np.array(
    [
        [0, 0, -1], [0, 0, 1],
        # bottom-biased corners: the corners of a flat underside
        [1, 1, -3], [1, -1, -3], [-1, 1, -3], [-1, -1, -3],
        # top-biased corners (robot upside down)
        [1, 1, 3], [1, -1, 3], [-1, 1, 3], [-1, -1, 3],
        # balanced corners and axes
        [1, 1, -1], [1, -1, -1], [-1, 1, -1], [-1, -1, -1],
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
    ],
    dtype=np.float64,
)
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)

_JNT_MAP = {0: S.FREE, 1: S.BALL, 2: S.SLIDE, 3: S.HINGE}


def _quat_mat(q) -> np.ndarray:
    import mujoco as mj

    m = np.zeros(9)
    mj.mju_quat2Mat(m, q)
    return m.reshape(3, 3)


def _mesh_support_points(m, geom_id: int, max_points: int) -> np.ndarray:
    """Support vertices of a mesh geom, in the owning body's frame: the
    vertex furthest along each direction (toward the body's small sphere
    sites first, then ``_DIRS``), distinct picks kept up to max_points."""
    import mujoco as mj

    mesh_id = m.geom_dataid[geom_id]
    adr, num = m.mesh_vertadr[mesh_id], m.mesh_vertnum[mesh_id]
    verts = m.mesh_vert[adr:adr + num].astype(np.float64)
    verts = verts @ _quat_mat(m.geom_quat[geom_id]).T + m.geom_pos[geom_id]
    centroid = verts.mean(0)

    dirs: List[np.ndarray] = []
    body = int(m.geom_bodyid[geom_id])
    for s in range(m.nsite):
        if int(m.site_bodyid[s]) != body:
            continue
        if m.site_type[s] == mj.mjtGeom.mjGEOM_SPHERE and m.site_size[s, 0] < 0.05:
            d = m.site_pos[s] - centroid
            n = np.linalg.norm(d)
            if n > 1e-9:
                dirs.append(d / n)
    dirs.extend(_DIRS)

    picks: List[np.ndarray] = []
    for d in dirs:
        v = verts[np.argmax(verts @ d)]
        if not any(np.linalg.norm(v - p) < 1e-6 for p in picks):
            picks.append(v)
        if len(picks) >= max_points:
            break
    return np.array(picks)


def _collides_with_plane(m, geom_id: int, plane_id: int) -> bool:
    c1, a1 = m.geom_contype[geom_id], m.geom_conaffinity[geom_id]
    c2, a2 = m.geom_contype[plane_id], m.geom_conaffinity[plane_id]
    return bool((c1 & a2) or (c2 & a1))


def _max_points(spec, name: str) -> int:
    """max_points_per_geom: an int, or {geom name: int} with '*' the
    default (6 where neither is given)."""
    if isinstance(spec, dict):
        return int(spec.get(name, spec.get("*", 6)))
    return int(spec)


def _body_dof_mask(m) -> np.ndarray:
    """mask[b, d] = 1 iff dof d is on the path world → body b."""
    mask = np.zeros((m.nbody, m.nv))
    for b in range(m.nbody):
        # walk up the dof_parentid chain from the body's last dof
        d = (int(m.body_dofadr[b]) + int(m.body_dofnum[b]) - 1
             if m.body_dofnum[b] else -1)
        while d >= 0:
            mask[b, d] = 1
            d = int(m.dof_parentid[d])
    # bodies without dofs inherit their parent's mask
    for b in range(1, m.nbody):
        if m.body_dofnum[b] == 0:
            mask[b] = mask[int(m.body_parentid[b])]
    return mask


def _dof_ancestor_mask(m) -> np.ndarray:
    """mask[i, j] = 1 iff dof i is an ancestor of (or equal to) dof j."""
    mask = np.zeros((m.nv, m.nv))
    for j in range(m.nv):
        i = j
        while i >= 0:
            mask[i, j] = 1
            i = int(m.dof_parentid[i])
    return mask


def _contact_points(m, plane_id: int, max_points_per_geom) -> Dict[str, list]:
    """Candidate contact points of every geom that collides with the plane,
    with the pair parameters MuJoCo would mix for it, ordered by body (the
    order of MuJoCo's pair traversal against the plane)."""
    import mujoco as mj

    cols = {k: [] for k in ("body", "pos", "rad", "mu", "mu_rot", "condim",
                            "solref", "solimp", "geom")}
    for g in range(m.ngeom):
        if g == plane_id or not _collides_with_plane(m, g, plane_id):
            continue
        radius = 0.0
        gtype = m.geom_type[g]
        if gtype == mj.mjtGeom.mjGEOM_MESH:
            pts = _mesh_support_points(
                m, g, _max_points(max_points_per_geom, m.geom(g).name))
        elif gtype == mj.mjtGeom.mjGEOM_SPHERE:
            pts = m.geom_pos[g][None]
            radius = float(m.geom_size[g, 0])
        elif gtype in (mj.mjtGeom.mjGEOM_CAPSULE, mj.mjtGeom.mjGEOM_CYLINDER):
            # two spheres on the axis (local z), radius = cross-section: at
            # a capsule's axis ends (the spheres are its caps); inscribed at
            # ±(half - r) for a cylinder, so they never overhang its flat
            # caps (which would make self-collision contacts MuJoCo lacks)
            radius = float(m.geom_size[g, 0])
            h = float(m.geom_size[g, 1])
            if gtype == mj.mjtGeom.mjGEOM_CYLINDER:
                h = max(h - radius, 0.0)
            half = h * _quat_mat(m.geom_quat[g])[:, 2]
            pts = np.stack([m.geom_pos[g] - half, m.geom_pos[g] + half])
        else:
            pts = m.geom_pos[g][None]
        # pair parameters with the plane: the higher-priority geom's values
        # outright, else mixed (mean for equal solmix, max friction and condim)
        if m.geom_priority[g] != m.geom_priority[plane_id]:
            src = g if m.geom_priority[g] > m.geom_priority[plane_id] else plane_id
            fric3 = m.geom_friction[src].copy()
            condim = int(m.geom_condim[src])
            solref = m.geom_solref[src].copy()
            solimp = m.geom_solimp[src].copy()
        else:
            fric3 = np.maximum(m.geom_friction[g], m.geom_friction[plane_id])
            condim = int(max(m.geom_condim[g], m.geom_condim[plane_id]))
            solref = (m.geom_solref[g] + m.geom_solref[plane_id]) / 2
            solimp = (m.geom_solimp[g] + m.geom_solimp[plane_id]) / 2
        for p in pts:
            cols["body"].append(int(m.geom_bodyid[g]))
            cols["pos"].append(np.asarray(p, dtype=np.float64))
            cols["rad"].append(radius)
            cols["mu"].append(float(fric3[0]))
            cols["mu_rot"].append(
                np.array([fric3[1], fric3[2], fric3[2]], dtype=np.float64))
            cols["condim"].append(condim)
            cols["solref"].append(np.asarray(solref, dtype=np.float64))
            cols["solimp"].append(np.asarray(solimp, dtype=np.float64))
            cols["geom"].append(g)
    order = np.argsort(np.array(cols["body"]), kind="stable")
    return {k: [v[i] for i in order] for k, v in cols.items()}


def _pairs(m, cp) -> Tuple[list, list, list, list, list]:
    """Body-body candidate pairs (self-collision) of the contact points:
    points of two geoms on different bodies that are not parent and child,
    not excluded by ``<contact><exclude>``, and whose contype/conaffinity
    match."""
    excluded = {(int(sig) >> 16, int(sig) & 0xFFFF)
                for sig in m.exclude_signature}

    def geoms_collide(g1, g2):
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        if b1 == b2:
            return False
        if m.body_parentid[b1] == b2 or m.body_parentid[b2] == b1:
            return False
        if (b1, b2) in excluded or (b2, b1) in excluded:
            return False
        c1, a1 = m.geom_contype[g1], m.geom_conaffinity[g1]
        c2, a2 = m.geom_contype[g2], m.geom_conaffinity[g2]
        return bool((c1 & a2) or (c2 & a1))

    a, b, mu, solref, solimp = [], [], [], [], []
    ncp = len(cp["body"])
    for i in range(ncp):
        for j in range(i + 1, ncp):
            g1, g2 = cp["geom"][i], cp["geom"][j]
            if g1 == g2 or not geoms_collide(g1, g2):
                continue
            a.append(i)
            b.append(j)
            mu.append(max(cp["mu"][i], cp["mu"][j]))
            solref.append((cp["solref"][i] + cp["solref"][j]) / 2)
            solimp.append((cp["solimp"][i] + cp["solimp"][j]) / 2)
    return a, b, mu, solref, solimp


def _sensor_matrix(m, plane_id: int, cp) -> np.ndarray:
    """(nsensor, ncp) touch-sensor membership: a point feeds a touch sensor
    when it lies in the sensor's site volume (in the shared body frame).  A
    model without touch sensors gets one synthetic sensor per body with a
    plane-colliding sphere geom (the feet), fed by that body's spheres."""
    import mujoco as mj

    ncp = len(cp["body"])
    touch = [i for i in range(m.nsensor)
             if m.sensor_type[i] == mj.mjtSensor.mjSENS_TOUCH]
    if not touch and ncp:
        sphere_bodies = sorted({
            int(m.geom_bodyid[g]) for g in range(m.ngeom)
            if g != plane_id and m.geom_type[g] == mj.mjtGeom.mjGEOM_SPHERE
            and _collides_with_plane(m, g, plane_id)})
        mat = np.zeros((len(sphere_bodies), ncp))
        for si, body in enumerate(sphere_bodies):
            for k in range(ncp):
                if cp["body"][k] == body and cp["rad"][k] > 0:
                    mat[si, k] = 1.0
        return mat
    mat = np.zeros((m.nsensor, ncp))
    for si in touch:
        site = int(m.sensor_objid[si])
        size, pos = m.site_size[site], m.site_pos[site]
        for k in range(ncp):
            if cp["body"][k] != int(m.site_bodyid[site]):
                continue
            if m.site_type[site] == mj.mjtGeom.mjGEOM_SPHERE:
                inside = np.linalg.norm(cp["pos"][k] - pos) <= size[0]
            else:
                inside = np.all(np.abs(cp["pos"][k] - pos) <= size[:3])
            if inside:
                mat[si, k] = 1.0
    return mat


def _compile(m, max_points_per_geom) -> Tuple[dict, dict]:
    """An MjModel → (static, arrays): the archive's JSON blob and its
    numeric arrays, with the archive's dtypes (floats float64)."""
    import mujoco as mj

    plane_ids = [g for g in range(m.ngeom)
                 if m.geom_type[g] == mj.mjtGeom.mjGEOM_PLANE]
    assert len(plane_ids) == 1, "expected exactly one ground plane"
    plane_id = plane_ids[0]
    cp = _contact_points(m, plane_id, max_points_per_geom)
    ncp = len(cp["body"])
    pair_a, pair_b, pair_mu, pair_solref, pair_solimp = _pairs(m, cp)
    sensor_matrix = _sensor_matrix(m, plane_id, cp)

    integ = {
        mj.mjtIntegrator.mjINT_EULER: S.EULER,
        mj.mjtIntegrator.mjINT_IMPLICITFAST: S.IMPLICITFAST,
        mj.mjtIntegrator.mjINT_IMPLICIT: S.IMPLICITFAST,
        mj.mjtIntegrator.mjINT_RK4: S.EULER,
    }[m.opt.integrator]
    ints = lambda xs: [int(x) for x in xs]  # noqa: E731
    static = dict(
        nq=int(m.nq), nv=int(m.nv), nu=int(m.nu), nbody=int(m.nbody),
        njnt=int(m.njnt), nsite=int(m.nsite),
        nsensor=int(sensor_matrix.shape[0]), ncp=ncp,
        body_parent=ints(m.body_parentid), body_jntadr=ints(m.body_jntadr),
        body_jntnum=ints(m.body_jntnum),
        jnt_type=[_JNT_MAP[int(t)] for t in m.jnt_type],
        jnt_bodyid=ints(m.jnt_bodyid), jnt_qposadr=ints(m.jnt_qposadr),
        jnt_dofadr=ints(m.jnt_dofadr), dof_bodyid=ints(m.dof_bodyid),
        actuator_trnid=ints(m.actuator_trnid[:, 0]),
        site_bodyid=ints(m.site_bodyid), cpoint_bodyid=list(cp["body"]),
        cpoint_sensor=[int(np.argmax(sensor_matrix[:, k]))
                       if sensor_matrix[:, k].any() else -1
                       for k in range(ncp)],
        integrator=integ,
        solver_iterations=int(m.opt.iterations),
        noslip_iterations=int(m.opt.noslip_iterations),
        max_contacts=-1,
        eulerdamp=not bool(m.opt.disableflags & mj.mjtDisableBit.mjDSBL_EULERDAMP),
        cpoint_condim=list(cp["condim"]),
        impratio=float(m.opt.impratio),
        solver_type=int(m.opt.solver),
        cone=int(m.opt.cone),
        ls_iterations=int(m.opt.ls_iterations),
        ls_refine=8,
    )
    f = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    rows = lambda xs, w: f(np.array(xs)) if len(xs) else f(np.zeros((0, w)))  # noqa: E731
    arrays = dict(
        body_pos=f(m.body_pos), body_quat=f(m.body_quat),
        body_ipos=f(m.body_ipos), body_iquat=f(m.body_iquat),
        body_mass=f(m.body_mass), body_inertia=f(m.body_inertia),
        body_invweight=f(m.body_invweight0),
        jnt_axis=f(m.jnt_axis), jnt_pos=f(m.jnt_pos), jnt_range=f(m.jnt_range),
        jnt_limited=np.asarray(m.jnt_limited, dtype=bool),
        jnt_solref=f(m.jnt_solref), jnt_solimp=f(m.jnt_solimp),
        dof_solref=f(m.dof_solref), dof_solimp=f(m.dof_solimp),
        dof_damping=f(m.dof_damping), dof_armature=f(m.dof_armature),
        dof_frictionloss=f(m.dof_frictionloss),
        dof_invweight=f(m.dof_invweight0), qpos0=f(m.qpos0),
        actuator_gear=f(m.actuator_gear[:, 0]),
        actuator_gainprm=f(m.actuator_gainprm[:, 0]),
        actuator_biasprm=f(m.actuator_biasprm[:, :3]),
        actuator_ctrlrange=f(m.actuator_ctrlrange),
        actuator_ctrllimited=np.asarray(m.actuator_ctrllimited, dtype=bool),
        actuator_forcerange=f(m.actuator_forcerange),
        actuator_forcelimited=np.asarray(m.actuator_forcelimited, dtype=bool),
        site_pos=f(m.site_pos), site_quat=f(m.site_quat),
        cpoint_pos=rows(cp["pos"], 3),
        cpoint_radius=f(np.array(cp["rad"])),
        cpoint_friction=f(np.array(cp["mu"])),
        cpoint_solref=f(np.array(cp["solref"])),
        cpoint_solimp=f(np.array(cp["solimp"])),
        cpair_a=np.asarray(pair_a, dtype=np.int32),
        cpair_b=np.asarray(pair_b, dtype=np.int32),
        cpair_friction=f(np.array(pair_mu)),
        cpair_solref=rows(pair_solref, 2),
        cpair_solimp=rows(pair_solimp, 5),
        sensor_cpoint_matrix=f(sensor_matrix),
        gravity=f(m.opt.gravity), timestep=f(m.opt.timestep),
        dof_ancestor_mask=_dof_ancestor_mask(m),
        body_dof_mask=_body_dof_mask(m),
        max_pair_contacts=np.asarray(4),
        cpoint_friction_rot=rows(cp["mu_rot"], 3),
    )
    return static, arrays


def _system(static: dict, arrays: dict, dtype: torch.dtype, device) -> S.System:
    """A System from an archive's static blob and arrays: floats as dtype,
    other arrays as bool or int64 tensors on ``device``."""
    dev = resolve_device(device)
    kwargs = {}
    for k, v in static.items():
        kwargs[k] = v if isinstance(v, (int, float)) else tuple(v)
    for k, arr in arrays.items():
        if k in _INT_OPTIONS:
            kwargs[k] = int(arr)
        elif np.issubdtype(arr.dtype, np.floating):
            kwargs[k] = torch.as_tensor(arr, dtype=dtype, device=dev)
        elif arr.dtype == np.bool_:
            kwargs[k] = torch.as_tensor(arr, device=dev)
        else:
            kwargs[k] = torch.as_tensor(arr.astype(np.int64), device=dev)
    return S.System(**kwargs)


def system_from_mjmodel(m, max_points_per_geom=8,
                        dtype: torch.dtype = torch.float64,
                        device=None) -> S.System:
    """Compile an ``mujoco.MjModel`` into a System on ``device`` (the card
    unless ``"cpu"`` is asked for), floats as dtype.  max_points_per_geom:
    the cap on a mesh geom's support points, an int or {geom name: int}
    with an optional '*' default."""
    static, arrays = _compile(m, max_points_per_geom)
    return _system(static, arrays, dtype, device)


def system_from_mjcf(xml_path: str, max_points_per_geom=8,
                     dtype: torch.dtype = torch.float64,
                     device=None) -> S.System:
    """Compile an MJCF file (see ``system_from_mjmodel``)."""
    import mujoco as mj

    return system_from_mjmodel(mj.MjModel.from_xml_path(xml_path),
                               max_points_per_geom, dtype, device)


def save_system(sys: S.System, path: str) -> None:
    """Write ``sys`` as an archive that either package's ``load_system``
    reads: the static fields as the JSON blob, every other field that is
    set as an array (floats in the System's dtype)."""
    arrays = {}
    static = {}
    for fld in dataclasses.fields(sys):
        val = getattr(sys, fld.name)
        if fld.name in _STATIC_FIELDS:
            static[fld.name] = val if isinstance(val, (int, float)) else list(val)
        elif isinstance(val, torch.Tensor):
            arr = val.cpu().numpy()
            if fld.name in _ARCHIVE_INTS:
                arr = arr.astype(_ARCHIVE_INTS[fld.name])
            arrays[fld.name] = arr
        elif val is not None:
            arrays[fld.name] = np.asarray(val)
    arrays["__static__"] = np.frombuffer(json.dumps(static).encode(),
                                         dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load_system(path_or_name: str, dtype: torch.dtype = torch.float64,
                device=None) -> S.System:
    """Load a compiled System from npz (by path or bundled asset name) onto
    ``device`` (the card unless ``"cpu"`` is asked for), floats as dtype."""
    path = path_or_name
    if not os.path.exists(path):
        path = os.path.join(_ASSET_DIR, path_or_name + ".npz")
    with open(path, "rb") as fh:
        data = np.load(io.BytesIO(fh.read()))
    static = json.loads(bytes(data["__static__"]).decode())
    arrays = {k: data[k] for k in data.files if k != "__static__"}
    return _system(static, arrays, dtype, device)
