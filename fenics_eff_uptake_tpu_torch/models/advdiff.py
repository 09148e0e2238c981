"""Steady advection-diffusion concentration solves with Robin uptake
(counterpart of ``models/advdiff.py``):

  weak form: D grad(c) . grad(phi) dx + (u . grad c) phi dx
             + mu(x) c phi ds_4
  BCs:       c = 1 left (marker 1), c = 0 right (marker 2); plain Galerkin,
             no stabilisation.

Nonsymmetric: batched f32 BiCGStab inside f64 defect correction at B = 1
(``parallel/sweep.py``), or restarted GMRES on the f64 operator.  The
clamps after the solve are those of ``models/diffusion.py``.
"""

from __future__ import annotations

from ..fem.space import Function
from ..meshing.mesh_data import MeshData
from .diffusion import _transport_solve

__all__ = ["advdiff_solve"]


def advdiff_solve(mesh: MeshData, u: Function, device, D, mu, element="P2",
                  rtol=1e-13, maxiter=50000, solver="auto",
                  solver_options=None, coarse_mesh=None) -> Function:
    """The advection-diffusion concentration on ``device``; ``u`` the
    velocity Function (numpy values on the P2 vector space).

    solver: None (BiCGStab through the batched engine), "gmres", or
    "auto" (GMRES when Pe = 1/D > 25); ``maxiter`` caps GMRES's steps (the
    batched engine's passes have their own caps).  ``solver_options``,
    ``coarse_mesh`` and the result as in ``pure_diffusion_solve``; a GMRES
    result carries ``solver_info["method"] == "gmres"``."""
    return _transport_solve(mesh, device, D, mu, element, rtol,
                            maxiter=maxiter, u=u, solver=solver,
                            solver_options=solver_options,
                            coarse_mesh=coarse_mesh)
