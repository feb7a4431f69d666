# A frozen copy of the port's ops/assemble.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/assemble.py``."""

from __future__ import annotations
from typing import NamedTuple, Optional
import torch
from benchmark.reference.plain.physics import arrow, collision, kinematics
from benchmark.reference.plain.physics import solver
from benchmark.reference.plain.physics import system as S


class AssembleOut(NamedTuple):
    con: collision.Contacts   # pos, dist, active, centers; no Jacobians
    sel3: Optional[torch.Tensor]      # (N, K) selected condim-3 points
    pair_sel: Optional[torch.Tensor]  # (N, Kp) selected pairs
    pair_a: Optional[torch.Tensor]    # (N, Kp) their points a and b
    pair_b: Optional[torch.Tensor]
    rows: Optional[solver.Rows]       # None where nothing constrains


def _kin(xpos, xquat, subtree_com, cdof) -> kinematics.KinOut:
    return kinematics.KinOut(xpos, xquat, None, None, None, None, subtree_com,
                             None, cdof)


def plain(sys: S.System, lay: Optional[arrow.ArrowLayout], xpos, xquat,
          subtree_com, cdof, qpos, qvel, qacc_smooth,
          legs: bool = False) -> AssembleOut:
    """The plain version: ``collision.find_contacts``,
    ``find_pair_contacts`` and ``solver.assembled_rows`` (``assemble``,
    ``_legmeta`` where ``legs``, b)."""
    kin = _kin(xpos, xquat, subtree_com, cdof)
    con = collision.find_contacts(sys, kin)
    pair = None
    if sys.max_pair_contacts > 0 and len(sys.cpair_a) > 0:
        pair = collision.find_pair_contacts(sys, kin, con)
    rows = solver.assembled_rows(sys, con, qpos, qvel, qacc_smooth, pair=pair,
                                 lay=lay, legs=legs)
    c3, _ = solver._condim_groups(sys)
    sel3 = (rows.groups[0][0] if rows is not None and
            0 < sys.max_contacts < len(c3) else None)
    con = con._replace(jac=None, jac_rot=None)
    if pair is None:
        return AssembleOut(con, sel3, None, None, None, rows)
    return AssembleOut(con, sel3, pair.sel, pair.a, pair.b, rows)


def rows(sys: S.System, lay: Optional[arrow.ArrowLayout], xpos, xquat,
         subtree_com, cdof, qpos, qvel, qacc_smooth) -> AssembleOut:
    """The plain version, with the leg slots where the legs form solves."""
    return plain(sys, lay, xpos, xquat, subtree_com, cdof, qpos, qvel,
                 qacc_smooth, legs=solver.legs_form(sys, lay, qvel.dtype,
                                                    qvel.device))
