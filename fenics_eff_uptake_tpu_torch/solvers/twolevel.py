"""Two-level (coarse-grid) preconditioner for the transport systems
(counterpart of ``solvers/twolevel.py``):

    M^{-1} = theta * D^{-1}  +  P A_c^{-1} P^T

  - the coarse space is P1 on an independently generated coarse mesh of the
    same geometry (a rediscretised coarse operator, not Galerkin), numbered
    by the coarse mesh's vertices: nothing is padded or reordered;
  - P is barycentric interpolation at the fine dof coordinates located in
    the coarse mesh: three coarse vertices and weights per fine dof, built
    on the host once per mesh pair (a point outside the coarse mesh takes
    its nearest vertex; constrained and padding rows take no correction);
  - A_c^{-1} is dense: one f32 inverse per sweep column, made on the host
    (numpy: the densification, the constraint rows, a 1e-6 mean |diag|
    shift and ``np.linalg.inv`` on f32, as the JAX package makes them), or,
    with ``woodbury=True`` where D is one value, no per-sample Robin
    matrices are given and a Robin block exists, one shared inverse of
    A0 = D K_c (+ Adv_c sym) and per-column capacitance inverses of the
    Robin block's factor W (R_c = W W^T): A_b^{-1} by the Woodbury identity.

The apply works in f32 whatever the Krylov precision: the residual is
rounded to f32, and the result returned in the residual's dtype.  The
restriction P^T is a sorted segment sum (entries in coarse-vertex order,
each segment added in entry order on every device), the coarse product a
batched f32 matrix-vector product with TF32 off, and the interpolation
three gathers.  These are plain PyTorch ops: the JAX package runs them in
XLA, not in a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..analysis.locate import PointLocator
from ..device import setup
from ..fem.assembly import (advection_block, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS

__all__ = ["TwoLevelData", "build_twolevel", "make_preconditioner",
           "coarse_inverses", "interpolation"]


class TwoLevelData(NamedTuple):
    cols: torch.Tensor          # (n_fine, 3) int64 coarse vertex ids
    weights: torch.Tensor       # (n_fine, 3) f64 barycentric weights
    perm: torch.Tensor          # (M,) int64 flat (row, k) entries of P^T
                                #   with a nonzero weight, stably sorted
                                #   by coarse id
    lengths: torch.Tensor       # (n_coarse,) int64 entries per coarse id
    n_coarse: int
    # per-sample explicit inverses (B, nc, nc) f32; or the Woodbury path:
    # A_b = A0 + mu_b W W^T with the shared A0inv (nc, nc), Z = A0inv W
    # (nc, r) and per-sample capacitance inverses C_b = (I/mu_b + W^T Z)^-1
    # (B, r, r), all f32
    Ainv: Optional[torch.Tensor]
    A0inv: Optional[torch.Tensor]
    Z: Optional[torch.Tensor]
    W: Optional[torch.Tensor]
    Cinv: Optional[torch.Tensor]
    theta: float


def _dense_of(A_e, dofs, nc):
    """The assembled (nc, nc) f64 matrix of entity matrices ``A_e`` on the
    dof map ``dofs``, summed by ``np.add.at`` in the JAX package's order."""
    M = np.zeros((nc, nc))
    dofs = np.asarray(dofs)
    A_e = np.asarray(A_e)
    for local in range(dofs.shape[1]):
        rows = dofs[:, local]
        for lj in range(dofs.shape[1]):
            np.add.at(M, (rows, dofs[:, lj]), A_e[:, local, lj])
    return M


def coarse_inverses(K, free_c, D_values, mu_values=None, Adv=None, R=None,
                    robin_matrices_coarse=None, woodbury=False):
    """The coarse inverses on the host.  ``K``, ``Adv``, ``R``: (entity
    matrices (N, nd, nd) f64, dof map (N, nd)) of the coarse unit
    stiffness, advection and unit Robin blocks in the coarse space's
    numbering; ``free_c`` (nc,) bool; ``robin_matrices_coarse`` (B, F, nd,
    nd) per-sample Robin matrices on R's facets, in place of mu_b R.

    Returns {"Ainv": (B, nc, nc)} or, on the Woodbury path, {"A0inv",
    "Z", "W", "Cinv"}: numpy f32 arrays."""
    free_c = np.asarray(free_c, dtype=bool)
    nc = free_c.shape[0]
    D_vec = np.asarray(D_values, dtype=np.float64)
    B = len(D_vec)
    mu_vec = (np.zeros(B) if mu_values is None
              else np.asarray(mu_values, dtype=np.float64))

    def constrain(A):
        A[~free_c, :] = 0.0
        A[:, ~free_c] = 0.0
        idx = np.flatnonzero(~free_c)
        A[idx, idx] = 1.0
        return A

    K_c = constrain(_dense_of(*K, nc))
    Advsym = None
    if Adv is not None:
        Adv_c = _dense_of(*Adv, nc)
        Advsym = constrain(0.5 * (Adv_c + Adv_c.T))
    R_c = None if R is None else constrain(_dense_of(*R, nc))

    if (woodbury and np.allclose(D_vec, D_vec[0])
            and robin_matrices_coarse is None and R_c is not None):
        # A_b = A0 + mu_b R_c: one nc^3 inverse in all; R_c = W W^T on its
        # (small) support by eigh
        sup = np.flatnonzero(np.abs(R_c).sum(0) > 0)
        evals, evecs = np.linalg.eigh(R_c[np.ix_(sup, sup)])
        keep = evals > max(evals.max(), 0) * 1e-10
        Wd = np.zeros((nc, int(keep.sum())))
        Wd[sup] = evecs[:, keep] * np.sqrt(evals[keep])[None, :]
        A0 = D_vec[0] * K_c
        if Advsym is not None:
            A0 = A0 + Advsym
        A0 = A0 + 1e-6 * np.abs(np.diag(A0)).mean() * np.eye(nc)
        A0inv = np.linalg.inv(A0.astype(np.float32)).astype(np.float64)
        Zd = A0inv @ Wd
        WtZ = Wd.T @ Zd
        r = Wd.shape[1]
        Cinv = [np.zeros((r, r)) if max(mu, 0.0) == 0.0
                else np.linalg.inv(np.eye(r) / max(mu, 0.0) + WtZ)
                for mu in mu_vec]
        return {"A0inv": A0inv.astype(np.float32),
                "Z": Zd.astype(np.float32), "W": Wd.astype(np.float32),
                "Cinv": np.stack(Cinv).astype(np.float32)}
    Ainv = []
    for b in range(B):
        A = D_vec[b] * K_c
        if Advsym is not None:
            A = A + Advsym
        if R_c is not None:
            if robin_matrices_coarse is not None:
                A = A + constrain(_dense_of(robin_matrices_coarse[b], R[1],
                                            nc))
            else:
                A = A + mu_vec[b] * R_c
        A = A + 1e-6 * np.abs(np.diag(A)).mean() * np.eye(nc)
        Ainv.append(np.linalg.inv(A.astype(np.float32)))
    return {"Ainv": np.stack(Ainv)}


def interpolation(fine_coords, coarse_mesh, free_fine):
    """(cols (n, 3) int64 coarse vertex ids, weights (n, 3) f64) of the
    fine points in the coarse mesh (host): barycentric in the cell that
    holds the point, else the nearest vertex with weight 1; 0 on the
    constrained rows (``free_fine`` False)."""
    loc = PointLocator(coarse_mesh, k=12, tol=1e-8)
    cells, ref = loc.locate(fine_coords)
    bad = cells < 0
    lam = np.concatenate([1 - ref.sum(1, keepdims=True), ref], axis=1)
    lam = np.clip(lam, 0.0, 1.0)
    lam /= np.maximum(lam.sum(1, keepdims=True), 1e-300)
    cols = coarse_mesh.cells[np.where(bad, 0, cells)]
    if bad.any():
        from scipy.spatial import cKDTree
        _, nearest = cKDTree(coarse_mesh.vertices).query(fine_coords[bad])
        cols[bad] = np.stack([nearest] * 3, axis=1)
        lam[bad] = np.array([1.0, 0.0, 0.0])
    lam[~np.asarray(free_fine)] = 0.0
    return cols.astype(np.int64), lam


def _coarse_blocks(coarse_mesh, u_coarse):
    """The coarse P1 blocks on the host, unpadded, in the coarse space's
    numbering (the vertices'): ({"K": (A_e, dofs), "Adv": ..., "R": ...},
    free (nc,) bool)."""
    space = FunctionSpace(coarse_mesh, "P1")
    if not np.array_equal(space.cell_dofs, coarse_mesh.cells):
        raise ValueError("the coarse P1 dofs are not the mesh's vertices")
    blocks = {"K": stiffness_block(space, "cpu")}
    if u_coarse is not None:
        blocks["Adv"] = advection_block(space, u_coarse[0], u_coarse[1],
                                        "cpu")
    bottom = coarse_mesh.bc_marker == MARKERS["bottom"]
    if bottom.any():
        blocks["R"] = robin_facet_block(space, bottom, "cpu")
    bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
    return ({k: (A_e.numpy(), np.asarray(d)) for k, (A_e, d)
             in blocks.items()}, np.asarray(bc.free, dtype=bool))


def build_twolevel(sys, coarse_mesh, D_values, mu_values=None,
                   robin_matrices_coarse=None, u_coarse=None, theta=0.6,
                   woodbury=False) -> TwoLevelData:
    """Two-level data of a transport sweep (``parallel.sweep``) on the
    fine system's device.

    sys: the fine TransportSystem; coarse_mesh: a MeshData of the same
    geometry at a coarser h; D_values / mu_values: the sweep coefficients
    (one coarse inverse per column); robin_matrices_coarse: (B, F, nd, nd)
    per-sample Robin matrices on the coarse mesh's bottom facets;
    u_coarse: optional (values, space) velocity on the coarse mesh, whose
    advection enters symmetrised; woodbury: the Woodbury coarse solve
    where it applies (one D, scalar mu, a Robin block)."""
    blocks, free_c = _coarse_blocks(coarse_mesh, u_coarse)
    inv = coarse_inverses(blocks["K"], free_c, D_values, mu_values,
                          Adv=blocks.get("Adv"), R=blocks.get("R"),
                          robin_matrices_coarse=robin_matrices_coarse,
                          woodbury=woodbury)
    # the fine rows in system numbering: the bandwidth orderings keep the
    # padding dofs at the tail
    n_true = sys.space.ndofs
    fine_coords = np.asarray(sys.space.dof_coords)
    if sys.perm is not None:
        order = np.asarray(sys.perm)[:n_true]
        if (order >= n_true).any():
            raise ValueError("padding dofs among the system's first "
                             f"{n_true} rows")
        fine_coords = fine_coords[order]
    free = sys.free.cpu().numpy()
    cols, lam = interpolation(fine_coords, coarse_mesh, free[:n_true])
    pad = sys.ndofs - n_true
    cols = np.concatenate([cols, np.zeros((pad, 3), np.int64)])
    lam = np.concatenate([lam, np.zeros((pad, 3))])
    # P^T's plan: entries of zero weight (constrained and padding rows)
    # add exact zeros, and are left out
    ids = cols.ravel()
    live = np.flatnonzero(lam.ravel() != 0)
    perm = live[np.argsort(ids[live], kind="stable")]
    nc = free_c.shape[0]
    dev = sys.free.device

    def t(a, dtype):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=dev)
    return TwoLevelData(
        cols=t(cols, torch.int64), weights=t(lam, torch.float64),
        perm=t(perm, torch.int64),
        lengths=t(np.bincount(ids[perm], minlength=nc), torch.int64),
        n_coarse=nc, theta=float(theta),
        **{k: t(inv.get(k), torch.float32)
           for k in ("Ainv", "A0inv", "Z", "W", "Cinv")})


def make_preconditioner(tl: TwoLevelData, dinv):
    """M^{-1}: (n, B) -> (n, B) in the residual's dtype, additive Jacobi
    (``dinv`` (n, B), the inverse diagonal, any float dtype) plus the
    coarse correction, computed in f32."""
    setup(dinv.device)                # TF32 off for the coarse products
    theta = tl.theta
    dinv32 = dinv.float()
    w32 = tl.weights.float()
    w_entry = w32.reshape(-1)[tl.perm][:, None]      # (M, 1)
    rows = tl.perm // 3
    c0, c1, c2 = tl.cols.unbind(1)
    w0, w1, w2 = (w32[:, k:k + 1] for k in range(3))

    def restrict(Rw):
        return torch.segment_reduce(w_entry * Rw[rows], "sum",
                                    lengths=tl.lengths, axis=0)

    def batched(Minv, V):
        """(B, m, m) @ each column of V (m, B) -> (m, B)."""
        return torch.bmm(Minv, V.t().unsqueeze(2)).squeeze(2).t()

    if tl.Ainv is None:
        def coarse_solve(rc):
            y = tl.A0inv @ rc
            u = batched(tl.Cinv, tl.W.t() @ y)
            return y - tl.Z @ u
    else:
        def coarse_solve(rc):
            return batched(tl.Ainv, rc)

    def apply(R):
        Rw = R.float()
        xc = coarse_solve(restrict(Rw))
        fine = w0 * xc[c0] + w1 * xc[c1] + w2 * xc[c2]
        return (theta * dinv32 * Rw + fine).to(R.dtype)

    return apply
