"""Batched geometric multigrid preconditioner (counterpart of
``solvers/multilevel.py``), hybrid and multiplicative cycles.

Hierarchy for a P2 fine system on mesh h:

    fine P2 (h) -> P1 on the same mesh -> P1 at 3h -> P1 at 9h (dense)

Every level operator is A_l = D * K_l + Adv_l + mu * R_l in the batch-minor
(n_l, B) layout (in a step-mu sweep R_l is a per-sample batch of Robin
matrices assembled from the columns' mu_b(x) on the level's own mesh, and
the coarsest inverses take theirs); Adv_l advects by the fine velocity interpolated onto the
level mesh (``level_velocities``).  Transfers are barycentric interpolation
(exact embedding for the nested same-mesh level) stored as windowed bands,
so restriction and prolongation run through kernel B; the levels' K and
Adv applies run through kernel A and their Robin applies through kernel C.
The coarsest level is a batch of dense f32 inverses, built on the host
(LAPACK) and shipped once; its advection enters symmetrised,
constrain(0.5 (Adv + Adv^T)), as in the JAX package.

Two cycles (``make_ml_preconditioner``), both from the JAX package:

  hybrid  additive at the fine level (scaled Jacobi plus the prolongated
          coarse correction, no fine operator apply), multiplicative below;
          symmetric positive definite, so CG applies (symmetric sweeps)
  mult    the V(1,1) cycle with weighted-Jacobi smoothing on every level
          (nonsymmetric sweeps, the Stokes velocity block)

Level systems are assembled on the host (CPU tensors) and shipped to the
fine system's device, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.space import FunctionSpace
from ..meshing.generator import generate_mesh
from ..ops.band_plans import aligned_transfer_plans
from ..ops.banded import (band_apply, band_spans, rect_band_apply,
                          rect_band_values)
from ..fem.assembly import robin_facet_block
from ..meshing.mesh_data import MARKERS
from ..parallel.sweep import (TransportSystem, _Block,
                              build_transport_system, fine_dinv, system_to)

__all__ = ["Transfer", "TransferBands", "Level", "MultilevelData",
           "level_meshes_for", "level_velocities", "level_robin_matrices",
           "build_multilevel",
           "build_multilevel_for", "make_ml_preconditioner"]

LEVEL_FACTORS = (3.0, 9.0)   # coarse level mesh sizes, in fine h
LEVEL_CAP = 0.45             # largest level h, in channel heights
H_THRESHOLD = 0.08           # no hierarchy at or above this fine h
OMEGA = 0.65                 # weighted-Jacobi smoothing weight


class Transfer(NamedTuple):
    """Barycentric transfer to the next coarser level (host numpy)."""
    cols: np.ndarray          # (n_fine, 3) coarse dof ids
    weights: np.ndarray       # (n_fine, 3) f32 barycentric weights
    n_coarse: int


class TransferBands(NamedTuple):
    """Windowed-band form of one transfer, on the device."""
    p: torch.Tensor           # prolongation band (T, R, W) f32
    po: torch.Tensor          # its window starts (T,) int32
    r: torch.Tensor           # restriction band
    ro: torch.Tensor
    sig: torch.Tensor         # (nc,) coarse alignment order
    isig: torch.Tensor        # its inverse
    pad_p: int                # prolongation input rows (zero-padded)
    pad_r: int                # restriction input rows
    ps: torch.Tensor          # band_spans of p
    rs: torch.Tensor          # band_spans of r


class Level(NamedTuple):
    sys: TransportSystem
    dinv: torch.Tensor        # (n_l, B) f32 inverse diagonal (or (n_l, 1)
                              # broadcast over the columns)
    free: torch.Tensor        # (n_l,) bool
    transfer: Transfer
    bands: TransferBands
    R_batch: Optional[_Block] = None   # per-sample Robin (step-mu sweeps),
                                       #   in place of mu * sys.R


class MultilevelData(NamedTuple):
    levels: tuple             # fine -> last smoothed level
    Ainv: torch.Tensor        # (B, nc, nc) f32 coarsest inverses (or
                              # (1, nc, nc) broadcast)
    free_c: torch.Tensor      # (nc,) bool
    omega: float
    D_vec: torch.Tensor       # (B,) f64
    mu_vec: torch.Tensor


def level_meshes_for(mesh):
    """The fine mesh itself (nested P1 level) followed by coarser meshes of
    the same geometry at h * LEVEL_FACTORS, capped at LEVEL_CAP * height."""
    g = mesh.geom
    out = [mesh]
    for f in LEVEL_FACTORS:
        out.append(generate_mesh(
            width=g.width, height=g.height, sulcus_depth=g.sulcus_depth,
            sulcus_width=g.sulcus_width,
            mesh_size=min(g.mesh_size * f, LEVEL_CAP * g.height),
            refinement_factor=1, domain_type=mesh.domain_type))
    return out


def _interp(fine_coords, coarse_mesh, free_fine, n_fine_out, n_coarse_out,
            coarse_old2new, hint_cells=None) -> Transfer:
    """Barycentric transfer data from fine points into a P1 coarse mesh.

    hint_cells: the owning coarse cell of every fine point, known for the
    nested same-mesh level (skips point location).  Rows of constrained
    fine dofs and padding rows get zero weights; columns are mapped into
    the coarse system's numbering."""
    from scipy.spatial import cKDTree

    from ..analysis.locate import PointLocator
    fine_coords = np.asarray(fine_coords)
    free_np = np.asarray(free_fine)
    if hint_cells is not None:
        cells = np.asarray(hint_cells)
        tri = coarse_mesh.cells[cells]
        v = coarse_mesh.vertices
        a = v[tri[:, 0]]
        e1 = v[tri[:, 1]] - a
        e2 = v[tri[:, 2]] - a
        rhs = fine_coords - a
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        det = np.where(det == 0, 1.0, det)
        x = (e2[:, 1] * rhs[:, 0] - e2[:, 0] * rhs[:, 1]) / det
        y = (-e1[:, 1] * rhs[:, 0] + e1[:, 0] * rhs[:, 1]) / det
        ref = np.stack([x, y], axis=1)
    else:
        cells, ref = PointLocator(coarse_mesh, k=12, tol=1e-8).locate(
            fine_coords)
    bad = cells < 0
    lam = np.concatenate([1 - ref.sum(1, keepdims=True), ref], axis=1)
    lam = np.clip(lam, 0.0, 1.0)
    lam /= np.maximum(lam.sum(1, keepdims=True), 1e-300)
    cols = coarse_mesh.cells[np.where(bad, 0, cells)]
    if bad.any():
        _, nearest = cKDTree(coarse_mesh.vertices).query(fine_coords[bad],
                                                         workers=-1)
        cols[bad] = np.stack([nearest] * 3, axis=1)
        lam[bad] = np.array([1.0, 0.0, 0.0])
    nf = len(fine_coords)
    lam[~free_np[:nf]] = 0.0
    if n_fine_out > nf:
        cols = np.concatenate(
            [cols, np.zeros((n_fine_out - nf, 3), cols.dtype)])
        lam = np.concatenate([lam, np.zeros((n_fine_out - nf, 3))])
    cols = np.asarray(coarse_old2new)[cols]
    return Transfer(cols=cols.astype(np.int32),
                    weights=lam.astype(np.float32),
                    n_coarse=int(n_coarse_out))


def _np(t):
    return t.detach().cpu().numpy()


def _coarse_inverses(csys: TransportSystem, D_vec, mu_vec,
                     robin_matrices=None):
    """(B, nc, nc) f32 inverses of the constrained dense coarsest operators
    (host f64 assembly, LAPACK inverse in f32), as the JAX CPU path; the
    advection enters symmetrised, constrain(0.5 (Adv + Adv^T)), and every
    operator gets a 1e-6 mean-|diagonal| shift, both as in JAX.
    robin_matrices: (B, F, nd, nd) numpy per-sample Robin matrices on
    csys.R's facets, in place of mu_b * R."""
    nc = csys.ndofs

    def dense_of(block, Ae=None):
        M = np.zeros((nc, nc))
        dofs = _np(block.dofs)
        Ae = _np(block.A64) if Ae is None else Ae
        for li in range(dofs.shape[1]):
            rows = dofs[:, li]
            for lj in range(dofs.shape[1]):
                np.add.at(M, (rows, dofs[:, lj]), Ae[:, li, lj])
        return M

    free_c = _np(csys.free)

    def constrain(A):
        A[~free_c, :] = 0.0
        A[:, ~free_c] = 0.0
        idx = np.flatnonzero(~free_c)
        A[idx, idx] = 1.0
        return A

    K_c = constrain(dense_of(csys.K))
    Adv_c = None
    if csys.Adv is not None:
        Adv_c = dense_of(csys.Adv)
        Adv_c = constrain(0.5 * (Adv_c + Adv_c.T))
    R_c = constrain(dense_of(csys.R)) if csys.R is not None else None
    out = []
    for b in range(len(D_vec)):
        A = D_vec[b] * K_c
        if Adv_c is not None:
            A = A + Adv_c
        if R_c is not None:
            if robin_matrices is not None:
                A = A + constrain(dense_of(csys.R, robin_matrices[b]))
            else:
                A = A + mu_vec[b] * R_c
        A = A + 1e-6 * np.abs(np.diag(A)).mean() * np.eye(nc)
        out.append(np.linalg.inv(A.astype(np.float32)))
    return np.stack(out)


def build_multilevel(sys: TransportSystem, level_meshes, D_values,
                     mu_values=None, u_levels=None, dirichlet=None,
                     with_robin=True, robin_matrices_levels=None,
                     robin_matrices_fine=None) -> MultilevelData:
    """MG hierarchy for a fine TransportSystem sweep.

    level_meshes: MeshData list fine -> coarse; the first may be the fine
    mesh itself (nested P1 level), the last is solved densely.  u_levels:
    one (values, vector space) velocity per level mesh (advective systems,
    ``level_velocities``).  dirichlet / with_robin: the fine system's
    boundary structure, mirrored on every level (e.g. the Stokes velocity
    Laplacian: Dirichlet walls, no Robin).  robin_matrices_levels: per
    level mesh, the (B, F_l, nd, nd) f64 per-sample Robin matrices of a
    step-mu sweep on that level's bottom facets (numpy), and
    robin_matrices_fine the fine system's (numpy or tensor); they take the place of
    mu_values (then zeros) in every level operator, inverse diagonal and
    coarsest inverse."""
    dev = sys.free.device
    D = np.asarray(D_values, dtype=np.float64)
    mu = (np.zeros(len(D)) if mu_values is None
          else np.asarray(mu_values, dtype=np.float64))
    n_levels = len(level_meshes)
    Rb_levels = ([None] * n_levels if robin_matrices_levels is None
                 else [np.asarray(r, dtype=np.float64)
                       for r in robin_matrices_levels])
    u_levels = u_levels or [(None, None)] * n_levels
    lsys = [build_transport_system(m, "cpu", element="P1", u_values=uv,
                                   u_space=us, dirichlet=dirichlet,
                                   with_robin=with_robin)
            for m, (uv, us) in zip(level_meshes, u_levels)]

    def coords_of(s, verts=None):
        c = np.asarray(s.space.dof_coords if verts is None else verts)
        return c[s.perm[:len(c)]]

    hint0 = None
    if level_meshes[0] is sys.space.mesh:
        cd = np.asarray(sys.space.scalar_dofmap.cell_dofs)
        hint0 = np.zeros(sys.space.ndofs_scalar, dtype=np.int64)
        hint0[cd.ravel()] = np.repeat(np.arange(len(cd)), cd.shape[1])
        hint0 = hint0[sys.perm[:len(hint0)]]
    transfers = [_interp(coords_of(sys), level_meshes[0], _np(sys.free),
                         sys.ndofs, lsys[0].ndofs, lsys[0].iperm,
                         hint_cells=hint0)]
    for i in range(n_levels - 1):
        transfers.append(_interp(
            coords_of(lsys[i], level_meshes[i].vertices),
            level_meshes[i + 1], _np(lsys[i].free), lsys[i].ndofs,
            lsys[i + 1].ndofs, lsys[i + 1].iperm))

    level_sys = [sys] + [system_to(s, dev) for s in lsys[:-1]]
    # levels[0] smooths with the fine batch, levels[l + 1] with level mesh
    # l's; the last level mesh's batch enters the coarsest inverses
    Rb_smooth = [robin_matrices_fine] + Rb_levels[:-1]
    dinvs = [fine_dinv(s, D, mu, robin_matrices=rb).to(dev)
             for s, rb in zip([sys] + lsys[:-1], Rb_smooth)]
    levels = []
    for l, tr in enumerate(transfers):
        plans = aligned_transfer_plans(tr.cols, tr.weights,
                                       level_sys[l].ndofs, tr.n_coarse)
        if plans is None:
            raise ValueError(f"level {l} transfer has no index locality; "
                             "the windowed-band form does not apply")
        p_p, p_r, sig, isig = plans
        w = torch.as_tensor(tr.weights, device=dev)
        p, r = rect_band_values(p_p, w), rect_band_values(p_r, w)
        bands = TransferBands(
            p=p, po=torch.as_tensor(p_p.offs, device=dev),
            r=r, ro=torch.as_tensor(p_r.offs, device=dev),
            sig=torch.as_tensor(sig, dtype=torch.long, device=dev),
            isig=torch.as_tensor(isig, dtype=torch.long, device=dev),
            pad_p=p_p.n_cols_pad, pad_r=p_r.n_cols_pad,
            ps=band_spans(p), rs=band_spans(r))
        rb = Rb_smooth[l]
        levels.append(Level(
            sys=level_sys[l], dinv=dinvs[l], free=level_sys[l].free,
            transfer=tr, bands=bands,
            R_batch=None if rb is None else level_sys[l].R.per_sample(rb)))
    Ainv = torch.as_tensor(
        _coarse_inverses(lsys[-1], D, mu, robin_matrices=Rb_levels[-1]),
        device=dev)
    return MultilevelData(levels=tuple(levels), Ainv=Ainv,
                          free_c=lsys[-1].free.to(dev), omega=OMEGA,
                          D_vec=torch.as_tensor(D, device=dev),
                          mu_vec=torch.as_tensor(mu, device=dev))


def level_velocities(u_fine, level_meshes):
    """The fine velocity Function on each level mesh's P2 vector space:
    the same-mesh level reuses the fine field, the others interpolate it
    at their dof coordinates (zero where a point falls outside the fine
    mesh).  Returns a list of (interleaved values, vector space)."""
    from ..analysis.profiles import eval_function
    out = []
    for m in level_meshes:
        if m is u_fine.space.mesh:
            out.append((np.asarray(u_fine.values), u_fine.space))
            continue
        Vl = FunctionSpace(m, "P2", vs=2)
        vals, ok = eval_function(u_fine, Vl.dof_coords)
        vals = np.where(ok[:, None], vals, 0.0)
        inter = np.zeros(Vl.ndofs)
        inter[0::2] = vals[:, 0]
        inter[1::2] = vals[:, 1]
        out.append((inter, Vl))
    return out


def level_robin_matrices(level_meshes, mu_callables):
    """Per level mesh, the (B, F_l, 3, 3) f64 numpy Robin matrices of the
    columns' mu_b(x) callables on that mesh's P1 bottom facets."""
    out = []
    for m in level_meshes:
        sp = FunctionSpace(m, "P1")
        bottom = m.bc_marker == MARKERS["bottom"]
        out.append(np.stack([
            _np(robin_facet_block(sp, bottom, "cpu", mu=mc)[0])
            for mc in mu_callables]))
    return out


def build_multilevel_for(sys, mesh, D_values, mu_values=None, u_fine=None,
                         mu_callables=None, robin_matrices_fine=None
                         ) -> Optional[MultilevelData]:
    """The study hierarchy, or None when the mesh is coarse enough
    (h >= H_THRESHOLD) that Jacobi alone converges quickly.  u_fine: the
    fine velocity Function of an advective sweep, carried to every level.
    mu_callables: the columns' spatially varying mu_b(x) of a step-mu
    sweep (the level Robin matrices are assembled from them on each level
    mesh), with robin_matrices_fine the fine system's batch."""
    g = mesh.geom
    if g is None or g.mesh_size >= H_THRESHOLD:
        return None
    meshes = level_meshes_for(mesh)
    u_levels = (None if u_fine is None
                else level_velocities(u_fine, meshes))
    robin_levels = (None if mu_callables is None
                    else level_robin_matrices(meshes, mu_callables))
    return build_multilevel(sys, meshes, D_values, mu_values,
                            u_levels=u_levels,
                            robin_matrices_levels=robin_levels,
                            robin_matrices_fine=robin_matrices_fine)


def make_ml_preconditioner(ml: MultilevelData, cycle="hybrid"):
    """M^{-1}: (n, B) f32 -> (n, B) f32, one ``cycle`` ("hybrid" or
    "mult") of the hierarchy."""
    if cycle not in ("hybrid", "mult"):
        raise ValueError(f"unknown cycle {cycle!r}")
    D32 = ml.D_vec.float()
    mu32 = ml.mu_vec.float()
    omega = ml.omega
    levels = ml.levels
    n_mid = len(levels)

    def A_masked(la: Level, X):
        # A_l on free rows, zero on constrained ones
        free = la.free[:, None]
        Xm = torch.where(free, X, 0.0)
        Y = band_apply(la.sys.Kband, Xm, coef=D32, spans=la.sys.Kspans)
        if la.sys.Advband is not None:
            Y = Y + band_apply(la.sys.Advband, Xm, spans=la.sys.Advspans)
        if la.R_batch is not None:
            Y = la.R_batch.apply_batched(Xm, out=Y)
        elif la.sys.R is not None:
            Y = la.sys.R.apply_batched(Xm, coef=mu32, out=Y)
        return torch.where(free, Y, Xm)

    def restrict(la: Level, R):
        tb = la.bands
        Xq = F.pad(R, (0, 0, 0, tb.pad_r - R.shape[0]))
        Ys = rect_band_apply(tb.r, tb.ro, Xq, tb.rs)[:la.transfer.n_coarse]
        return Ys[tb.isig]

    def prolong(la: Level, Xc):
        tb = la.bands
        Xs = Xc[tb.sig]
        Xq = F.pad(Xs, (0, 0, 0, tb.pad_p - Xs.shape[0]))
        return rect_band_apply(tb.p, tb.po, Xq, tb.ps)[:la.free.shape[0]]

    def coarse(rc):
        rc = torch.where(ml.free_c[:, None], rc, 0.0)
        return torch.matmul(ml.Ainv, rc.t().unsqueeze(-1)).squeeze(-1).t()

    def vcycle(l, r):
        la = levels[l]
        x = omega * la.dinv * r                 # first step from zero
        rc = restrict(la, r - A_masked(la, x))
        if l + 1 < n_mid:
            rc = torch.where(levels[l + 1].free[:, None], rc, 0.0)
            xc = vcycle(l + 1, rc)
        else:
            xc = coarse(rc)
        x = x + prolong(la, xc)
        # mirrored post-smooth keeps M symmetric (CG-safe)
        return x + omega * la.dinv * (r - A_masked(la, x))

    if cycle == "mult":
        return lambda R: vcycle(0, R)

    def hybrid(R):
        la = levels[0]
        rc = restrict(la, R)
        if n_mid > 1:
            rc = torch.where(levels[1].free[:, None], rc, 0.0)
            xc = vcycle(1, rc)
        else:
            xc = coarse(rc)
        return omega * la.dinv * R + prolong(la, xc)

    return hybrid
