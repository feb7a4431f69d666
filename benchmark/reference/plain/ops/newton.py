"""The Newton solve's entry, as the port's ``ops/newton.py`` calls it on
the CPU: ``physics/newton.py::solve``."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.plain.physics import newton
from benchmark.reference.plain.physics.newton import NewtonEfc, NewtonOut


def newton_solve(efc: NewtonEfc, M: torch.Tensor, qacc_smooth: torch.Tensor,
                 iterations: int, ls_refine: int,
                 x0: Optional[torch.Tensor] = None) -> NewtonOut:
    return newton.solve(efc, M, qacc_smooth, iterations, ls_refine, x0=x0)
