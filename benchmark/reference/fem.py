"""Plain P2 / Taylor-Hood finite elements for the benchmark's reference.

Written from the equations alone, in NumPy (mesh topology) and PyTorch on
the CPU (element arrays and applies, float64, or float32 for the
control): no kernel, plan, band or table of the package under test.

Conventions the check relies on (the package documents the same ones, and
its outputs are read in them):

* P2 dofs: the V vertices first, then one dof per edge, the edges sorted by
  (lower vertex, higher vertex); a cell's local dofs are
  [v0, v1, v2, e(v1, v2), e(v0, v2), e(v0, v1)].
* Vector P2 fields are interleaved: dof 2 j + component.
* P1 (the Stokes pressure) lives on the vertices.

Every integral is evaluated exactly for the polynomial degree it has, by a
collapsed (Duffy) Gauss-Legendre rule on the triangle and a Gauss-Legendre
rule on edges, so that the result differs from any other exact evaluation
by rounding alone.  The one integrand that is not a polynomial, |q| in the
mouth exchange E_L1, is taken with the three-point Gauss-Legendre rule the
upstream study's degree-4 facet measure uses.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["P2Mesh", "apply", "dirichlet", "facet_tables"]

_EDGES = np.array([[1, 2], [0, 2], [0, 1]])       # local edge k opposite k


def _gauss01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def triangle_rule():
    """(points (Q, 2), weights (Q,)) on the reference triangle, exact to
    degree 5: x = s, y = t (1 - s) with 4 x 3 Gauss-Legendre points."""
    s, ws = _gauss01(4)
    t, wt = _gauss01(3)
    S, T = np.meshgrid(s, t, indexing="ij")
    W = np.outer(ws, wt) * (1.0 - S)
    return np.stack([S.ravel(), (T * (1.0 - S)).ravel()], 1), W.ravel()


def p2_tab(xi):
    """P2 basis values (Q, 6) and reference gradients (Q, 6, 2) at xi."""
    x, y = xi[:, 0], xi[:, 1]
    l0, l1, l2 = 1.0 - x - y, x, y
    phi = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                    4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1], 1)
    # d(lambda_i)/d(x, y)
    dl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    L = [l0, l1, l2]
    g = np.zeros((len(x), 6, 2))
    for i in range(3):
        g[:, i] = ((4 * L[i] - 1)[:, None]) * dl[i]
    for k, (a, b) in enumerate(_EDGES):
        g[:, 3 + k] = 4 * (L[b][:, None] * dl[a] + L[a][:, None] * dl[b])
    return phi, g


def p1_tab(xi):
    x, y = xi[:, 0], xi[:, 1]
    return np.stack([1.0 - x - y, x, y], 1)


class P2Mesh:
    """A mesh's P2 numbering and affine maps (from vertices and cells)."""

    def __init__(self, vertices, cells):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int64)
        V = len(self.vertices)
        a = self.cells[:, _EDGES[:, 0]]
        b = self.cells[:, _EDGES[:, 1]]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        keys = lo * (V + 1) + hi
        uniq, inv = np.unique(keys, return_inverse=True)
        self.edges = np.stack([uniq // (V + 1), uniq % (V + 1)], 1)
        self.cell_dofs = np.concatenate(
            [self.cells, V + inv.reshape(-1, 3)], 1)
        self.ndofs = V + len(uniq)
        self.dof_xy = np.concatenate(
            [self.vertices, 0.5 * (self.vertices[self.edges[:, 0]]
                                   + self.vertices[self.edges[:, 1]])])
        p = self.vertices[self.cells]
        J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 2)   # (T,2,2)
        self.detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        self.invJ = np.linalg.inv(J)                               # (T,2,2)

    # -- element matrices -------------------------------------------------
    def _grads(self, g_ref):
        """Physical gradients (T, Q, 6, 2) of reference ones (Q, 6, 2)."""
        return np.einsum("qia,tab->tqib", g_ref, self.invJ)

    def stiffness(self):
        """(T, 6, 6): int grad phi_i . grad phi_j."""
        xi, w = triangle_rule()
        G = self._grads(p2_tab(xi)[1])
        return np.einsum("q,tqia,tqja,t->tij", w, G, G, np.abs(self.detJ))

    def advection(self, u):
        """(T, 6, 6): int (u . grad phi_j) phi_i, u (ndofs, 2) P2 values."""
        xi, w = triangle_rule()
        phi, g = p2_tab(xi)
        uq = np.einsum("qk,tka->tqa", phi, u[self.cell_dofs])
        G = self._grads(g)
        return np.einsum("q,qi,tqa,tqja,t->tij", w, phi, uq, G,
                         np.abs(self.detJ))

    def divergence(self):
        """(T, 3, 12): -int psi_k d(phi_j)/d(x_b), column 2 j + b."""
        xi, w = triangle_rule()
        G = self._grads(p2_tab(xi)[1])
        Bd = np.einsum("q,qk,tqjb,t->tkjb", w, p1_tab(xi), G,
                       np.abs(self.detJ))
        return -Bd.reshape(len(self.cells), 3, 12)

    def cell_integral(self, X):
        """Per-cell integrals (B, T) of the columns X (B, ndofs)."""
        xi, w = triangle_rule()
        phi = torch.as_tensor(p2_tab(xi)[0], dtype=X.dtype)
        cd = torch.as_tensor(self.cell_dofs)
        cq = torch.einsum("qi,bti->btq", phi, X[:, cd])
        return torch.einsum("q,btq,t->bt", torch.as_tensor(w, dtype=X.dtype),
                            cq, torch.as_tensor(np.abs(self.detJ),
                                                dtype=X.dtype))


def facet_tables(mesh: P2Mesh, cells_f, local_edges):
    """Facets given as (cell, local edge): Gauss-Legendre points on each
    (three: exact to degree 5), the cell's P2 basis and physical gradients
    there, the cell's outward unit normal, the length and the dofs.
    Returns a dict of NumPy arrays."""
    cells_f = np.asarray(cells_f, dtype=np.int64)
    le = np.asarray(local_edges, dtype=np.int64)
    s, w = _gauss01(3)
    ref = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    a, b = ref[_EDGES[le, 0]], ref[_EDGES[le, 1]]           # (F, 2)
    xi = (1 - s)[None, :, None] * a[:, None] + s[None, :, None] * b[:, None]
    F, Q = xi.shape[:2]
    phi, g = p2_tab(xi.reshape(-1, 2))
    phi = phi.reshape(F, Q, 6)
    grad = np.einsum("fqia,fab->fqib", g.reshape(F, Q, 6, 2),
                     mesh.invJ[cells_f])
    verts = mesh.vertices[mesh.cells[cells_f]]               # (F, 3, 2)
    pa = verts[np.arange(F), _EDGES[le, 0]]
    pb = verts[np.arange(F), _EDGES[le, 1]]
    opp = verts[np.arange(F), le]
    d = pb - pa
    length = np.hypot(d[:, 0], d[:, 1])
    n = np.stack([d[:, 1], -d[:, 0]], 1) / length[:, None]
    n = np.where((np.einsum("fa,fa->f", n, opp - pa) > 0)[:, None], -n, n)
    x = (1 - s)[None, :, None] * pa[:, None] + s[None, :, None] * pb[:, None]
    return {"phi": phi, "grad": grad, "normal": n, "length": length,
            "w": w, "dofs": mesh.cell_dofs[cells_f], "x": x}


def apply(Ae, rows, cols, X, nrows, coef=None):
    """Y (nrows, B): the entity matrices Ae (N, r, c) applied to X (n, B)
    through each entity's column dofs ``cols`` (N, c) and summed into its
    row dofs ``rows`` (N, r); each column's part scaled by ``coef`` (B,)
    when given."""
    A = torch.as_tensor(Ae, dtype=X.dtype)
    Ye = torch.einsum("nij,njb->nib", A, X[torch.as_tensor(cols)])
    if coef is not None:
        Ye = Ye * coef
    Y = torch.zeros((nrows, X.shape[1]), dtype=X.dtype)
    Y.index_add_(0, torch.as_tensor(rows).reshape(-1),
                 Ye.reshape(-1, X.shape[1]))
    return Y


def dirichlet(mesh: P2Mesh, facet_cells, facet_local, facet_marker, values):
    """(dof ids, values) of P2 Dirichlet conditions: every dof of each
    boundary facet whose marker is a key of ``values`` (the facet's two
    vertices and its edge), given in the order of ``values`` (a later
    marker overwrites)."""
    out = {}
    for marker, value in values.items():
        sel = np.flatnonzero(facet_marker == marker)
        c, k = facet_cells[sel], facet_local[sel]
        d = mesh.cell_dofs[c]
        ids = np.concatenate([d[np.arange(len(c)), _EDGES[k, 0]],
                              d[np.arange(len(c)), _EDGES[k, 1]],
                              d[np.arange(len(c)), 3 + k]])
        for i in np.unique(ids):
            out[int(i)] = value(mesh.dof_xy[i]) if callable(value) else value
    ids = np.array(sorted(out), dtype=np.int64)
    return ids, np.array([out[i] for i in ids])
