# A frozen copy of the port's ops/solve_out.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/solve_out.py``."""

from __future__ import annotations
from typing import NamedTuple, Optional, Sequence, Tuple
import torch
from benchmark.reference.plain.physics import system as S


LEGS, DENSE, NEWTON = range(3)   # solve_out_env.cuh Form


class Solved(NamedTuple):
    """The solve's force and what its form leaves for the output stage."""

    form: int                            # LEGS, DENSE or NEWTON
    force: torch.Tensor                  # (N, nefc)
    J: Optional[torch.Tensor] = None     # (N, nefc, nv): LEGS, DENSE
    dq: Optional[torch.Tensor] = None    # (N, nv) M⁻¹Jᵀf: LEGS
    Minv: Optional[torch.Tensor] = None  # (N, nv, nv): DENSE
    qfrc: Optional[torch.Tensor] = None  # (N, nv): NEWTON
    qacc: Optional[torch.Tensor] = None  # (N, nv): NEWTON


class Out(NamedTuple):
    nforce: torch.Tensor           # (N, ncp)
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv)
    sensordata: torch.Tensor       # (N, nsensor)


def plain(sys: S.System, groups: Sequence[Tuple[torch.Tensor, int]],
          pair_ab: Optional[Tuple[torch.Tensor, torch.Tensor]],
          ns_offset: int, solved: Solved, qacc_smooth: torch.Tensor,
          elliptic: bool) -> Out:
    """The plain version: the products, the scatter and the sensors."""
    f, form = solved.force, solved.form
    if form == LEGS:
        qfrc = torch.einsum("nkv,nk->nv", solved.J, f)
        qacc = qacc_smooth + solved.dq
    elif form == DENSE:
        qfrc = torch.einsum("nkv,nk->nv", solved.J, f)
        qacc = qacc_smooth + torch.einsum("nij,nj->ni", solved.Minv, qfrc)
    else:
        qfrc, qacc = solved.qfrc, solved.qacc
    N = qacc_smooth.shape[0]
    nforce = f.new_zeros(N, sys.ncp)
    off = ns_offset
    for idx, nf in groups:
        n = idx.shape[1]
        blk = f[:, off:off + n * nf].reshape(N, n, nf)
        nforce = nforce.scatter(1, idx, blk[..., 0] if elliptic else blk.sum(dim=-1))
        off += n * nf
    if pair_ab is not None:
        # pair normal force feeds the touch sensors of BOTH bodies; duplicate
        # indices accumulate (scatter_add, the batched index_add_)
        pa, pb = pair_ab
        blk = f[:, off:].reshape(N, -1, 3 if elliptic else 4)
        nf_pair = blk[..., 0] if elliptic else blk.sum(dim=-1)
        nforce = nforce.scatter_add(1, pa, nf_pair).scatter_add(1, pb, nf_pair)
    # touch sensors: per-contact normal force (Σ pyramid facet forces, or
    # the normal row of an elliptic cone)
    sensordata = nforce @ sys.sensor_cpoint_matrix.T
    return Out(nforce, qfrc, qacc, sensordata)


outputs = plain
