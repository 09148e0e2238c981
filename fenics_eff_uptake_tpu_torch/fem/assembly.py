"""Batched element assembly in PyTorch (counterpart of ``fem/assembly.py``).

Each weak-form term of the studies is a vectorised quadrature einsum in
float64 that emits per-entity dense matrices ``A_e (N, nd, nd)`` with their
entity -> dof map ``(N, nd)`` (``parallel.sweep`` renumbers the dofs and
builds the operator block from the pair):

  stiffness (P2 x P2 grads)         quadrature degree 2
  mass (phi phi)                    degree 4
  advection (u . grad phi_j) phi_i  degree 5, u a P2 vector field
  Robin facet mu phi phi            degree 4 (1-D Gauss) for unit mu, at
                                    least 6 for a callable mu(x)
  divergence -psi_k d_b phi_j       degree 3, rectangular (P1 x vector P2)
  vector stiffness kron(K, I_2)     degree 2, interleaved (N, 12, 12) (host
                                    use and tests: the Stokes solves apply
                                    the scalar K on (ns, 2) columns)
  load vector int f phi_i           degree 4 (the MMS tests)

``make_bc``, ``constrained_operator`` and ``constrained_rhs`` are the
Dirichlet elimination of the JAX package: identity rows on the constrained
dofs, their values lifted into the right-hand side.

Meshes, dof maps, quadrature rules and basis tables come from the port's
copies of the JAX package's host modules.  Unlike the JAX assembly,
nothing is padded to shape buckets: those only kept TPU compile keys stable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .elements import _EDGE_VERTS, _REF_VERTS, tabulate, tabulate_grad
from .quadrature import interval_rule, triangle_rule
from .space import FunctionSpace

__all__ = ["cell_geometry", "stiffness_block", "vector_stiffness_block",
           "mass_block", "advection_block", "divergence_block",
           "robin_facet_block", "load_vector", "BCData", "make_bc",
           "constrained_operator", "constrained_rhs"]

_F64 = torch.float64


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=_F64, device=device)


def cell_geometry(vertices, cells):
    """Per-cell affine map data: detJ (T,), invJT (T, 2, 2)."""
    p = vertices[cells]                               # (T, 3, 2)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = torch.stack([
        torch.stack([d2[:, 1], -d2[:, 0]], dim=-1),
        torch.stack([-d1[:, 1], d1[:, 0]], dim=-1),
    ], dim=1) / detJ[:, None, None]                   # inv(J), rows
    return detJ, inv.transpose(1, 2)


def _stiffness_dev(verts, cells, qw, gref):
    detJ, invJT = cell_geometry(verts, cells)
    G = torch.einsum("tab,qib->tqia", invJT, gref)
    return torch.einsum("q,tqia,tqja,t->tij", qw, G, G, detJ)


def _mass_dev(verts, cells, qw, phi):
    detJ, _ = cell_geometry(verts, cells)
    return torch.einsum("q,qi,qj,t->tij", qw, phi, phi, detJ)


def _advection_dev(verts, cells, qw, phi, gref, phi_u, u_flat, ucd):
    detJ, invJT = cell_geometry(verts, cells)
    G = torch.einsum("tab,qib->tqia", invJT, gref)
    u_cell = u_flat[ucd].reshape(ucd.shape[0], -1, 2)
    u_q = torch.einsum("qk,tka->tqa", phi_u, u_cell)
    return torch.einsum("q,qi,tqa,tqja,t->tij", qw, phi, u_q, G, detJ)


def _divergence_dev(verts, cells, qw, psi, gref):
    detJ, invJT = cell_geometry(verts, cells)
    G = torch.einsum("tab,qib->tqia", invJT, gref)
    Bd = torch.einsum("q,qk,tqjb,t->tkjb", qw, psi, G, detJ)
    T, npp, ndu, _ = Bd.shape
    return -Bd.reshape(T, npp, 2 * ndu)


def _robin_dev(w, mu_q, tabs, le, lens):
    phi_f = tabs[le]
    if mu_q is None:                                   # unit mu
        return torch.einsum("q,fqi,fqj,f->fij", w, phi_f, phi_f, lens)
    return torch.einsum("q,fq,fqi,fqj,f->fij", w, mu_q, phi_f, phi_f, lens)


def stiffness_block(space: FunctionSpace, device):
    """Unit stiffness K_e[i,j] = int grad(phi_i) . grad(phi_j) dx.

    Returns (A_e (T, nd, nd) f64 tensor, cell dofs (T, nd) numpy)."""
    qp, qw = triangle_rule(2)
    K = _stiffness_dev(*_cell_args(space.mesh, device), _t(qw, device),
                       _t(tabulate_grad(space.element, qp), device))
    return K, np.asarray(space.cell_dofs)


def vector_stiffness_block(vspace: FunctionSpace, device, coeff=1.0):
    """The vector Laplacian int grad(u) : grad(v) dx on a vector space in
    the interleaved layout (dof 2 j + b): A_e = kron(K_e, I_2) * coeff.

    Returns (A_e (T, 2 nd, 2 nd) f64 tensor, interleaved cell dofs (T, 2 nd)
    numpy)."""
    qp, qw = triangle_rule(2)
    K = _stiffness_dev(*_cell_args(vspace.mesh, device), _t(qw, device),
                       _t(tabulate_grad(vspace.element, qp), device))
    K = K * float(coeff)
    T, nd, _ = K.shape
    A = torch.zeros((T, 2 * nd, 2 * nd), dtype=K.dtype, device=K.device)
    A[:, 0::2, 0::2] = K
    A[:, 1::2, 1::2] = K
    return A, np.asarray(vspace.cell_dofs)


def load_vector(space: FunctionSpace, f_callable, device, degree=4):
    """b_i = int f(x, y) phi_i dx, f a vectorised callable of the
    coordinates: (ndofs,) f64 tensor."""
    mesh = space.mesh
    verts, cells = _cell_args(mesh, device)
    detJ, _ = cell_geometry(verts, cells)
    qp, qw = triangle_rule(degree)
    lam = np.concatenate([1 - qp.sum(1, keepdims=True), qp], axis=1)
    xq = np.einsum("qv,tva->tqa", lam, mesh.vertices[mesh.cells])
    fq = _t(np.asarray(f_callable(xq[..., 0], xq[..., 1]),
                       dtype=np.float64), device)
    be = torch.einsum("q,tq,qi,t->ti", _t(qw, device), fq,
                      _t(tabulate(space.element, qp), device), detJ)
    b = torch.zeros(space.ndofs, dtype=_F64, device=device)
    idx = torch.as_tensor(np.asarray(space.cell_dofs).reshape(-1),
                          dtype=torch.long, device=device)
    return b.index_add_(0, idx, be.reshape(-1))


def _cell_args(mesh, device):
    return (_t(mesh.vertices, device),
            torch.as_tensor(np.asarray(mesh.cells), dtype=torch.long,
                            device=device))


def mass_block(space: FunctionSpace, device):
    """Unit mass M_e[i,j] = int phi_i phi_j dx.

    Returns (A_e (T, nd, nd) f64 tensor, cell dofs (T, nd) numpy)."""
    qp, qw = triangle_rule(4)
    M = _mass_dev(*_cell_args(space.mesh, device), _t(qw, device),
                  _t(tabulate(space.element, qp), device))
    return M, np.asarray(space.cell_dofs)


def advection_block(space: FunctionSpace, u_values, u_space: FunctionSpace,
                    device):
    """Advection A_e[i,j] = int (u . grad phi_j) phi_i dx, nonsymmetric.

    ``u_values`` are the interleaved vector dofs of ``u_space`` (a P2
    vector space on the same mesh).  Returns (A_e (T, nd, nd) f64 tensor,
    cell dofs (T, nd) numpy)."""
    qp, qw = triangle_rule(5)
    A = _advection_dev(
        *_cell_args(space.mesh, device), _t(qw, device),
        _t(tabulate(space.element, qp), device),
        _t(tabulate_grad(space.element, qp), device),
        _t(tabulate(u_space.element, qp), device),
        _t(np.asarray(u_values).ravel(), device),
        torch.as_tensor(np.asarray(u_space.cell_dofs), dtype=torch.long,
                        device=device))
    return A, np.asarray(space.cell_dofs)


def divergence_block(pspace: FunctionSpace, vspace: FunctionSpace, device):
    """Coupling B_e[k, 2j+b] = -int psi_k d_b(phi_j) dx, so that the saddle
    matrix [[A, B^T], [B, 0]] is the Stokes form grad u : grad v - p div v
    - q div u.  Columns follow the interleaved velocity layout.

    Returns (B_e (T, np, 2*nd) f64 tensor, pressure cell dofs (T, np),
    interleaved velocity cell dofs (T, 2*nd), both numpy)."""
    qp, qw = triangle_rule(3)
    B = _divergence_dev(*_cell_args(vspace.mesh, device), _t(qw, device),
                        _t(tabulate(pspace.element, qp), device),
                        _t(tabulate_grad(vspace.element, qp), device))
    return B, np.asarray(pspace.cell_dofs), np.asarray(vspace.cell_dofs)


def _facet_data(space: FunctionSpace, facet_mask):
    """Per-selected-facet owning cells, local edge ids and endpoints."""
    mesh = space.mesh
    fs = mesh.boundary
    sel = np.flatnonzero(facet_mask)
    cells_f = fs.cell[sel]
    le = fs.local_edge[sel]
    lv = _EDGE_VERTS_ARR[le]
    ga = mesh.cells[cells_f, lv[:, 0]]
    gb = mesh.cells[cells_f, lv[:, 1]]
    return sel, cells_f, le, ga, gb


_EDGE_VERTS_ARR = np.array([_EDGE_VERTS[i] for i in range(3)])


def _edge_tables(element, t):
    """Basis values along each of the 3 local edges at params t: (3,Q,nd)."""
    tabs = []
    for le in range(3):
        a, b = _EDGE_VERTS[le]
        pts = ((1.0 - t)[:, None] * _REF_VERTS[a]
               + t[:, None] * _REF_VERTS[b])
        tabs.append(tabulate(element, pts))
    return np.stack(tabs, axis=0)


def robin_facet_block(space: FunctionSpace, facet_mask, device, mu=None):
    """Robin R_f[i,j] = int_f mu(x) phi_i phi_j ds.

    ``mu`` is None (unit mu: the block the sweep scales per column) or a
    vectorised callable of the x-coordinates (e.g. ``StepUptakeOpen``),
    evaluated at all facet quadrature points at once, clamped at 0, and
    integrated with degree 6 (unit mu: degree 4).

    Returns (A_f (F, nd, nd) f64 tensor, owner-cell dofs (F, nd) numpy)."""
    mesh = space.mesh
    t, w = interval_rule(4 if mu is None else 6)
    _, cells_f, le, ga, gb = _facet_data(space, facet_mask)
    va, vb = mesh.vertices[ga], mesh.vertices[gb]
    lens = np.linalg.norm(vb - va, axis=1)
    mu_q = None
    if mu is not None:
        xq = ((1.0 - t)[None, :] * va[:, None, 0]
              + t[None, :] * vb[:, None, 0])               # (F, Q)
        mu_q = _t(np.maximum(np.asarray(mu(xq), dtype=np.float64), 0.0),
                  device)
    R = _robin_dev(_t(w, device), mu_q,
                   _t(_edge_tables(space.element, t), device),
                   torch.as_tensor(le, dtype=torch.long, device=device),
                   _t(lens, device))
    return R, np.asarray(space.cell_dofs)[cells_f]


class BCData(NamedTuple):
    free: np.ndarray        # (ndofs,) bool
    values: np.ndarray      # (ndofs,) bc value where constrained, else 0


def make_bc(space: FunctionSpace, marker_value_pairs,
            marker_array=None) -> BCData:
    """Dirichlet data from (marker_id, value) pairs on the bc markers
    (``marker_array``: other facet markers in their place).  A value is a
    number, or a vectorised callable value(x, y) of the dof coordinates
    giving (len(dofs),) on a scalar space and (len(dofs), 2) on a vector
    one; a vector space constrains both components of each dof (interleaved
    2 j + b)."""
    mesh = space.mesh
    marker = mesh.bc_marker if marker_array is None else marker_array
    free = np.ones(space.ndofs, dtype=bool)
    vals = np.zeros(space.ndofs)
    for marker_id, value in marker_value_pairs:
        dofs = space.boundary_scalar_dofs(marker == marker_id)
        gdofs = (dofs if space.vs == 1
                 else np.concatenate([2 * dofs, 2 * dofs + 1]))
        free[gdofs] = False
        if np.isscalar(value):
            vals[gdofs] = float(value)
            continue
        coords = space.dof_coords[dofs]
        v = np.asarray(value(coords[:, 0], coords[:, 1]))
        if space.vs == 1:
            vals[gdofs] = v
        else:
            vals[2 * dofs] = v[:, 0]
            vals[2 * dofs + 1] = v[:, 1]
    return BCData(free=free, values=vals)


def constrained_operator(op, bc: BCData):
    """x -> A x on the free dofs, identity on the constrained ones; ``op``
    a callable on (ndofs,) tensors (or an object with ``apply``)."""
    apply = getattr(op, "apply", op)
    free_on = {}                 # the mask, copied once per device

    def constrained(x):
        free = free_on.get(x.device)
        if free is None:
            free = free_on[x.device] = torch.as_tensor(bc.free,
                                                       device=x.device)
        y = apply(torch.where(free, x, 0.0))
        return torch.where(free, y, x)

    return constrained


def constrained_rhs(op, bc: BCData, b=None, device="cpu"):
    """Right-hand side of the eliminated system: b - A g on the free dofs,
    g (the boundary values) on the constrained ones, as an f64 tensor on
    ``b``'s device (else ``device``)."""
    apply = getattr(op, "apply", op)
    dev = b.device if b is not None else torch.device(device)
    g = torch.as_tensor(bc.values, dtype=_F64, device=dev)
    Ag = apply(g)
    if b is None:
        b = torch.zeros_like(g)
    return torch.where(torch.as_tensor(bc.free, device=dev), b - Ag, g)
