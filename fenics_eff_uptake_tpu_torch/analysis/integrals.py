"""Domain integrals and error norms (counterpart of
``analysis/integrals.py``): quadrature reductions over the cells, in f64
on the values' device (numpy values: the CPU)."""

from __future__ import annotations

import numpy as np
import torch

from ..fem.assembly import cell_geometry
from ..fem.elements import tabulate
from ..fem.quadrature import triangle_rule
from ..fem.space import FunctionSpace
from .facets import as_values

__all__ = ["integrate_scalar", "l2_error", "integrate_cells"]


def _cell_quad(space: FunctionSpace, degree, device):
    """(quadrature weights, basis values (Q, nd), quadrature points
    (T, Q, 2) host, detJ (T,)), the tensors on ``device``."""
    mesh = space.mesh
    qp, qw = triangle_rule(degree)
    lam = np.concatenate([1 - qp.sum(1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,tva->tqa", lam, mesh.vertices[mesh.cells])
    detJ, _ = cell_geometry(
        torch.as_tensor(mesh.vertices, dtype=torch.float64, device=device),
        torch.as_tensor(mesh.cells, dtype=torch.long, device=device))
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.as_tensor(qw, **f64),
            torch.as_tensor(tabulate(space.element, qp), **f64), xq, detJ)


def _at_quad(space, values, phi):
    ce = values[torch.as_tensor(np.asarray(space.cell_dofs),
                                dtype=torch.long, device=values.device)]
    return torch.einsum("qi,ti->tq", phi, ce)


def integrate_cells(fn, degree=4, cell_mask=None):
    """Per-cell integral of a scalar Function: (T,) f64 tensor on its
    values' device."""
    v = as_values(fn.values)
    qw, phi, _, detJ = _cell_quad(fn.space, degree, v.device)
    per_cell = torch.einsum("q,tq,t->t", qw, _at_quad(fn.space, v, phi),
                            detJ)
    if cell_mask is not None:
        per_cell = torch.where(torch.as_tensor(cell_mask, device=v.device),
                               per_cell, 0.0)
    return per_cell


def integrate_scalar(fn, degree=4, cell_mask=None):
    """int fn dx over the (optionally masked) domain."""
    return float(integrate_cells(fn, degree, cell_mask).sum())


def l2_error(space: FunctionSpace, values, exact, degree=6):
    """||u_h - u_exact||_L2 by quadrature of the given degree; ``exact`` a
    vectorised callable exact(x, y)."""
    v = as_values(values)
    qw, phi, xq, detJ = _cell_quad(space, degree, v.device)
    ue = torch.as_tensor(np.asarray(exact(xq[..., 0], xq[..., 1]),
                                    dtype=np.float64), device=v.device)
    err2 = torch.einsum("q,tq,t->", qw, (_at_quad(space, v, phi) - ue) ** 2,
                        detJ)
    return float(torch.sqrt(err2))
