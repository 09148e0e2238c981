"""Batched geometric multigrid preconditioner (counterpart of
``solvers/multilevel.py``): hybrid, multiplicative and additive cycles in
f32, bf16 or f64.

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
The coarsest level is a batch of dense f32 inverses, assembled on the host
and inverted there (LAPACK, the default) or on the system's device by a
batched Newton-Schulz iteration (``coarse_inverse="newton_schulz"``); its
advection enters symmetrised, constrain(0.5 (Adv + Adv^T)), as in the JAX
package.

Three cycles (``make_ml_preconditioner``), all from the JAX package:

  hybrid  additive at the fine level (scaled Jacobi plus the prolongated
          coarse correction, no fine operator apply), multiplicative below;
          symmetric positive definite, so CG applies (symmetric sweeps)
  mult    the V(nu,nu) cycle with weighted-Jacobi smoothing on every level
          (nonsymmetric sweeps, the Stokes velocity block); nu = n_smooth
  add     additive (BPX-like): scaled Jacobi on every level plus the
          coarsest solve, summed; no operator apply inside M

and three working dtypes.  f32 is the default.  bf16 (``dtype``) runs every
vector and array of the cycle in bf16 through the kernels' bf16 forms, with
f32 sums inside them and the coarsest solve in f32; ``transfer_dtype=bf16``
alone keeps the f32 cycle and stores only the transfer bands in bf16
(kernel B reads the f32 vector rounded to bf16).  f64 runs the level
applies through the element blocks (kernel C in f64) and the transfers by
gather and planned segment sum: the bands are f32.  What a cycle needs in
another dtype than the hierarchy's f32 (bf16 bands and Robin blocks, the
f64 cycle's gather plans and coarsest inverses) is made once, at the first
``make_ml_preconditioner`` call that asks for it, and kept with the
hierarchy (``MultilevelData.lowp``); that is the only way to these copies.

Level systems are assembled on the host (CPU tensors) and shipped to the
fine system's device, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.space import FunctionSpace
from ..meshing.generator import MESH_TAG, generate_mesh
from ..ops.band_plans import RectBandPlan, aligned_transfer_plans
from ..ops.banded import (band_apply, band_spans, rect_band_apply,
                          rect_band_values)
from ..ops.elemspmv import make_segment_plan, planned_segment_sum
from ..fem.assembly import robin_facet_block
from ..meshing.mesh_data import MARKERS
from ..parallel.sweep import (TransportSystem, _Block, _np,
                              build_transport_system, fine_dinv, system_to)
from ..utils.diskcache import Memo, cache_key_of, cached_arrays, count

__all__ = ["Transfer", "TransferBands", "Level", "MultilevelData",
           "coarse_level_meshes", "level_meshes_for", "level_velocities",
           "level_robin_matrices",
           "build_multilevel", "build_multilevel_for",
           "make_ml_preconditioner", "newton_schulz_inverse",
           "gather_transfer", "CYCLES"]

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
    bands: Optional[TransferBands]     # None: gather transfers only (a
                                       #   hierarchy carried in for the f64
                                       #   cycle)
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
    A_c: Optional[np.ndarray] = None   # (B, nc, nc) f64 coarsest operators
                              # on the host: the f64 cycle inverts them at its
                              # first use.  A hierarchy carried over from the
                              # JAX package has none and takes what that
                              # package takes: Ainv upcast
    info: Optional[dict] = None   # coarse_inverse: the method, and for
                              # Newton-Schulz the worst max|I - A X|
    lowp: Optional[dict] = None   # copies in other dtypes, made at first use
                              # (_level_arrays, _coarse_f64): per level the
                              # bf16 bands and Robin blocks and the f64
                              # cycle's gather plans, none of which depends on
                              # the columns, and ("Ainv64", B), which does


def coarse_level_meshes(mesh_kwargs, mesh_size, factors=LEVEL_FACTORS):
    """Meshes of one geometry at ``mesh_size * f`` for each of ``factors``
    (fine -> coarse); ``mesh_kwargs``: ``generate_mesh``'s keyword
    arguments other than ``mesh_size``."""
    return [generate_mesh(mesh_size=mesh_size * f, **mesh_kwargs)
            for f in factors]


_LEVEL_MESH_MEMO = Memo(MESH_TAG, cap=64)


def level_meshes_for(mesh):
    """The fine mesh itself (nested P1 level) followed by coarser meshes of
    the same geometry at h * LEVEL_FACTORS, capped at LEVEL_CAP * height;
    each coarser mesh is memoised in this process by its generation
    arguments (the JAX package's ``_LEVEL_MESH_CACHE``), so a rebuild gets
    the same MeshData objects."""
    g = mesh.geom
    out = [mesh]
    for f in LEVEL_FACTORS:
        kw = dict(width=g.width, height=g.height,
                  sulcus_depth=g.sulcus_depth, sulcus_width=g.sulcus_width,
                  mesh_size=min(g.mesh_size * f, LEVEL_CAP * g.height),
                  refinement_factor=1, domain_type=mesh.domain_type)
        key = tuple(sorted(kw.items()))
        m = _LEVEL_MESH_MEMO.get(key)
        out.append(m if m is not None
                   else _LEVEL_MESH_MEMO.put(key, generate_mesh(**kw)))
    return out


TRANSFER_TAG = "port-mltransfer"
_INTERP_MEMO = Memo(TRANSFER_TAG, cap=12)   # ~5-15 MB per fine entry


def _interp(fine_coords, coarse_mesh, free_fine, n_fine_out, n_coarse_out,
            coarse_old2new, hint_cells=None) -> Transfer:
    """Barycentric transfer data from fine points into a P1 coarse mesh.

    hint_cells: the owning coarse cell of every fine point, known for the
    nested same-mesh level (skips point location).  Rows of constrained
    fine dofs and padding rows get zero weights; columns are mapped into
    the coarse system's numbering.

    Pure in its inputs, so content-memoised in this process and kept in
    the setup cache (tag ``port-mltransfer``), keyed as the JAX package
    keys it, and by the hint too (a point on an edge shared by two cells
    may take either)."""
    fine_coords = np.asarray(fine_coords)
    free_np = np.asarray(free_fine)
    o2n = np.asarray(coarse_old2new)
    hint = None if hint_cells is None else np.asarray(hint_cells)
    key = cache_key_of("mltransfer-v1", fine_coords,
                       np.asarray(coarse_mesh.vertices),
                       np.asarray(coarse_mesh.cells), free_np,
                       int(n_fine_out), int(n_coarse_out), o2n, hint)
    hit = _INTERP_MEMO.get(key)
    if hit is not None:
        return hit

    def build():
        cols, lam = _locate_transfer(fine_coords, coarse_mesh, free_np,
                                     n_fine_out, o2n, hint)
        return {"cols": cols, "weights": lam}

    d, _ = cached_arrays(TRANSFER_TAG, key, build)
    return _INTERP_MEMO.put(key, Transfer(
        cols=np.asarray(d["cols"], dtype=np.int32),
        weights=np.asarray(d["weights"], dtype=np.float32),
        n_coarse=int(n_coarse_out)))


def _locate_transfer(fine_coords, coarse_mesh, free_np, n_fine_out, o2n,
                     hint_cells):
    """(cols (n_fine_out, 3) int32, weights f32) of ``_interp``."""
    from scipy.spatial import cKDTree

    from ..analysis.locate import PointLocator
    if hint_cells is not None:
        cells = hint_cells
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
    return o2n[cols].astype(np.int32), lam.astype(np.float32)


TBANDPLAN_TAG = "port-tbandplan"
_TBAND_PLAN_MEMO = Memo(TBANDPLAN_TAG, cap=12)


def _transfer_plans(cols, weights, n_fine, n_coarse):
    """``aligned_transfer_plans`` of one transfer, content-memoised in this
    process and kept in the setup cache (tag ``port-tbandplan``): pure in
    (cols, weights, sizes), and ~0.05-0.1 s of host argsorts per level."""
    cols, weights = np.asarray(cols), np.asarray(weights)
    # v2: a transfer past the width menu has a (widened) plan, where a v1
    # entry holds "none"
    key = cache_key_of("tbandplan-v2", cols, weights, int(n_fine),
                       int(n_coarse))
    hit = _TBAND_PLAN_MEMO.get(key)
    if hit is not None:
        return hit or None     # False: a transfer without locality

    def build():
        plans = aligned_transfer_plans(cols, weights, n_fine, n_coarse)
        if plans is None:
            return {"none": np.asarray([1])}
        p_p, p_r, sig, isig = plans
        out = {"sig": sig, "isig": isig}
        for t, pl in (("p", p_p), ("r", p_r)):
            out.update({f"{t}_offs": pl.offs, f"{t}_ids": pl.ids,
                        f"{t}_perm": pl.perm, f"{t}_dims": np.asarray(
                            [pl.tiles, pl.tile, pl.width, pl.n_rows_pad,
                             pl.n_cols_pad])})
        return out

    d, _ = cached_arrays(TBANDPLAN_TAG, key, build)
    if "none" in d:
        plans = None
    else:
        def plan(t):
            tiles, tile, width, nrp, ncp = (int(v) for v in d[f"{t}_dims"])
            return RectBandPlan(offs=np.asarray(d[f"{t}_offs"]),
                                ids=np.asarray(d[f"{t}_ids"]),
                                perm=np.asarray(d[f"{t}_perm"]), tiles=tiles,
                                tile=tile, width=width, n_rows_pad=nrp,
                                n_cols_pad=ncp)
        plans = (plan("p"), plan("r"), np.asarray(d["sig"]),
                 np.asarray(d["isig"]))
    _TBAND_PLAN_MEMO.put(key, plans or False)
    return plans


NS_ITERS = 35                # Newton-Schulz doublings (the JAX package's)
NS_DEGRADED = 1e-2           # max|I - A X| above which a warning is raised


def newton_schulz_inverse(A, iters=NS_ITERS):
    """Batched inverse of A (B, n, n) on A's device by the Newton-Schulz
    iteration X <- X (2 I - A X) from X0 = A^T / (|A|_1 |A|_inf), which
    contracts for any nonsingular A; ``iters`` doublings reach f32 accuracy
    for the coarsest operators (cond <~ 1e4).  Plain batched matmuls (the
    JAX package runs it outside any hand kernel too), TF32 off.  Returns
    (X, res) with res (B,) = max|I - A X| per matrix."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n1 = A.abs().sum(dim=1).amax(dim=1)
        ninf = A.abs().sum(dim=2).amax(dim=1)
        X = A.transpose(1, 2) / (n1 * ninf)[:, None, None]
        I2 = 2.0 * torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
        for _ in range(iters):
            X = torch.bmm(X, I2 - torch.bmm(A, X))
        E = 0.5 * I2 - torch.bmm(A, X)
        return X, E.abs().amax(dim=(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


AINV_TAG = "port-ainv"
# (B, nc, nc) f32 inverses on the device and their f64 operators on the
# host, a few MB each (the JAX package's _AINV_DEV_MEMO cap)
_AINV_MEMO = Memo(AINV_TAG, cap=4)


def _coarse_inverses(csys: TransportSystem, D_vec, mu_vec,
                     robin_matrices=None, method="lapack", device="cpu"):
    """(Ainv (B, nc, nc) f32 on ``device``, the operators themselves
    (B, nc, nc) f64 numpy, info) for the constrained dense coarsest
    operators, assembled on the host in f64; the
    advection enters symmetrised, constrain(0.5 (Adv + Adv^T)), and every
    operator gets a 1e-6 mean-|diagonal| shift, both as in JAX.
    ``method``: "lapack" inverts in f32 on the host (the JAX CPU path),
    "newton_schulz" on ``device`` in f32 (the JAX accelerator path); its
    worst max|I - A X| goes into info (read synchronously; above
    NS_DEGRADED a RuntimeWarning says so).
    robin_matrices: (B, F, nd, nd) numpy per-sample Robin matrices on
    csys.R's facets, in place of mu_b * R.

    Content-memoised in this process (the JAX package's
    ``_AINV_DEV_MEMO``): keyed by the coarse blocks, the Robin batch,
    ``free``, D, mu, the method (and its iterations) and the device; a hit
    returns the same tensors, which no cycle writes."""
    if method not in ("lapack", "newton_schulz"):
        raise ValueError(f"unknown coarse_inverse {method!r}")
    blocks = [a for b in (csys.K, csys.Adv, csys.R)
              for a in ((None, None) if b is None
                        else (_np(b.A64), _np(b.dofs)))]
    key = cache_key_of(
        "ainv-v1", *blocks,
        None if robin_matrices is None else np.asarray(robin_matrices,
                                                      np.float64),
        _np(csys.free), np.asarray(D_vec, np.float64),
        np.asarray(mu_vec, np.float64), method,
        NS_ITERS if method == "newton_schulz" else None, str(device))
    hit = _AINV_MEMO.get(key)
    if hit is not None:
        return hit
    count(AINV_TAG, "miss")
    return _AINV_MEMO.put(key, _coarse_inverses_of(
        csys, D_vec, mu_vec, robin_matrices, method, device))


def _coarse_inverses_of(csys, D_vec, mu_vec, robin_matrices, method,
                        device):
    """``_coarse_inverses``' build on a memo miss."""
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
        out.append(A + 1e-6 * np.abs(np.diag(A)).mean() * np.eye(nc))
    A64 = np.stack(out)
    info = {"method": method, "worst_residual": None}
    if method == "lapack":
        Ainv = torch.as_tensor(np.linalg.inv(A64.astype(np.float32)),
                               device=device)
    else:
        Ainv, res = newton_schulz_inverse(
            torch.as_tensor(A64.astype(np.float32), device=device),
            iters=NS_ITERS)
        worst = float(res.max())
        info.update(worst_residual=worst, iters=NS_ITERS)
        if not worst <= NS_DEGRADED:
            import warnings
            warnings.warn(
                f"coarse Newton-Schulz inverse degraded: max|I - A X| = "
                f"{worst:.2e} over the batch (conditioned beyond the ~1e4 "
                f"design point?); expect extra Krylov iterations",
                RuntimeWarning)
    return Ainv, A64, info


def build_multilevel(sys: TransportSystem, level_meshes, D_values,
                     mu_values=None, u_levels=None, dirichlet=None,
                     with_robin=True, robin_matrices_levels=None,
                     robin_matrices_fine=None,
                     coarse_inverse="lapack") -> MultilevelData:
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
    coarsest inverse.  coarse_inverse: "lapack" (host) or "newton_schulz"
    (batched, on the system's device)."""
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
        plans = _transfer_plans(tr.cols, tr.weights, level_sys[l].ndofs,
                                tr.n_coarse)
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
    Ainv, A_c, cinfo = _coarse_inverses(
        lsys[-1], D, mu, robin_matrices=Rb_levels[-1],
        method=coarse_inverse, device=dev)
    return MultilevelData(levels=tuple(levels), Ainv=Ainv,
                          free_c=lsys[-1].free.to(dev), omega=OMEGA,
                          D_vec=torch.as_tensor(D, device=dev),
                          mu_vec=torch.as_tensor(mu, device=dev),
                          A_c=A_c, info={"coarse_inverse": cinfo}, lowp={})


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
                         mu_callables=None, robin_matrices_fine=None,
                         coarse_inverse="lapack") -> Optional[MultilevelData]:
    """The study hierarchy, or None when the mesh is coarse enough
    (h >= H_THRESHOLD) that Jacobi alone converges quickly.  u_fine: the
    fine velocity Function of an advective sweep, carried to every level.
    mu_callables: the columns' spatially varying mu_b(x) of a step-mu
    sweep (the level Robin matrices are assembled from them on each level
    mesh), with robin_matrices_fine the fine system's batch.
    coarse_inverse: as ``build_multilevel`` takes it."""
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
                            robin_matrices_fine=robin_matrices_fine,
                            coarse_inverse=coarse_inverse)


_BF16 = torch.bfloat16
CYCLES = ("hybrid", "mult", "add")
CYCLE_DTYPES = (None, torch.float32, torch.bfloat16, torch.float64)


class _LevelArrays(NamedTuple):
    """One level's arrays in a cycle's working dtype (``_level_arrays``)."""
    Kband: Optional[torch.Tensor]      # level bands (None: the f64 cycle
    Advband: Optional[torch.Tensor]    #   applies the element blocks)
    R: Optional[_Block]
    R_batch: Optional[_Block]
    p: Optional[torch.Tensor]          # transfer bands (None: gather path)
    r: Optional[torch.Tensor]
    gather: Optional[tuple]            # (cols (n, 3) long, weights (n, 3),
                                       #   segment plan of the restriction)


def gather_transfer(tr: Transfer, device):
    """The gather form of a transfer on ``device``: (cols (n, 3) long,
    weights (n, 3) f64, the segment plan of the restriction's sum into the
    coarse rows); the f64 cycle's and the sharded cycle's transfers.

    The plan leaves out the entries of zero weight (constrained and
    padding rows, whose columns all point at one coarse dof): they add
    exact zeros, and would set the plan's depth, one gather per entry of
    the fullest coarse row (~12,000 at the h = 0.02 mu sweep's fine level,
    ~25 without them).  The other entries keep their order, so the sums
    are the same."""
    cols = torch.as_tensor(np.asarray(tr.cols), dtype=torch.long,
                           device=device)
    w = torch.as_tensor(np.asarray(tr.weights), dtype=torch.float64,
                        device=device)
    keep = torch.nonzero(w.reshape(-1) != 0).reshape(-1)
    ids, order = torch.sort(cols.reshape(-1)[keep], stable=True)
    return cols, w, make_segment_plan(ids, tr.n_coarse, device,
                                      order=keep[order])


def _level_arrays(ml: MultilevelData, l: int, dtype, transfer_dtype):
    """Level ``l``'s column-independent arrays for a cycle in ``dtype``
    with transfer bands in ``transfer_dtype``, from ``ml.lowp`` where they
    were made before (a hierarchy without that dict gets them anew)."""
    la = ml.levels[l]
    cache = ml.lowp if ml.lowp is not None else {}

    def cached(key, make):
        if key not in cache:
            cache[key] = make()
        return cache[key]

    if dtype == torch.float64:
        return _LevelArrays(None, None, la.sys.R, la.R_batch, None, None,
                            cached(("gather", l), lambda: gather_transfer(
                                la.transfer, la.free.device)))
    if la.bands is None:
        raise ValueError(f"level {l} has no transfer bands: only the f64 "
                         "cycle runs without them")
    tb = la.bands
    if dtype == _BF16 or transfer_dtype == _BF16:
        # the f32 bands' spans serve their bf16 copies (ops/banded.py)
        p, r = cached(("tb16", l),
                      lambda: (tb.p.to(_BF16), tb.r.to(_BF16)))
    else:
        p, r = tb.p, tb.r
    if dtype != _BF16:
        return _LevelArrays(la.sys.Kband, la.sys.Advband, la.sys.R,
                            la.R_batch, p, r, None)
    Kb, Ab = cached(("bands16", l), lambda: (
        la.sys.Kband.to(_BF16),
        None if la.sys.Advband is None else la.sys.Advband.to(_BF16)))
    R = (None if la.sys.R is None
         else cached(("R16", l), la.sys.R.with_bf16))
    Rb = (None if la.R_batch is None
          else cached(("Rb16", l), la.R_batch.with_bf16))
    return _LevelArrays(Kb, Ab, R, Rb, p, r, None)


def _coarse_f64(ml: MultilevelData):
    """The f64 cycle's coarsest inverses: the f64 LAPACK inverses of the
    hierarchy's coarsest operators, made once and kept in ``ml.lowp`` (by
    the number of operators: the Stokes setup's widened copy of a hierarchy
    shares the dict and holds only the first); the f32 inverses upcast
    where the hierarchy holds no operators."""
    if ml.A_c is None:
        return ml.Ainv.double()
    cache = ml.lowp if ml.lowp is not None else {}
    key = ("Ainv64", len(ml.A_c))
    if key not in cache:
        cache[key] = torch.as_tensor(np.linalg.inv(ml.A_c),
                                     device=ml.Ainv.device)
    return cache[key]


def _check_cycle_dtypes(dtype, transfer_dtype):
    if dtype not in CYCLE_DTYPES:
        raise ValueError(f"cycle dtype {dtype} not in f32, bf16, f64")
    if transfer_dtype not in (None, torch.float32, _BF16):
        raise ValueError(f"transfer_dtype {transfer_dtype} not in f32, bf16")


def make_ml_preconditioner(ml: MultilevelData, cycle="hybrid", dtype=None,
                           transfer_dtype=None, n_smooth=1):
    """M^{-1}: (n, B) -> (n, B) in the argument's dtype, one ``cycle``
    ("hybrid", "mult" or "add") of the hierarchy.

    dtype: the cycle's working dtype, f32 (None), bf16 or f64; the
    argument is cast to it on entry and the result cast back.  In bf16,
    the inverse diagonals, D, mu, omega, the level bands, the Robin blocks
    and the transfer bands are bf16 and every apply takes its kernel's bf16
    form; the coarsest solve is Ainv f32 times the bf16 vector upcast,
    rounded to bf16.  In f64, the level operators apply their element
    blocks, the transfers gather, and the coarsest solve takes the f64
    inverses of ``ml.A_c`` (``_coarse_f64``).  transfer_dtype=bf16 with the
    f32 cycle stores only the transfer bands in bf16 (the f64 cycle has no
    bands and ignores it).  The copies a dtype needs are made at the first
    call that asks for them and kept in ``ml.lowp``.
    n_smooth: smoothing steps before and after each coarse correction of
    the multiplicative part."""
    if cycle not in CYCLES:
        raise ValueError(f"unknown cycle {cycle!r}")
    _check_cycle_dtypes(dtype, transfer_dtype)
    n_smooth = int(n_smooth)
    if n_smooth < 1:
        raise ValueError(f"n_smooth={n_smooth}: at least one step")
    wd = torch.float32 if dtype is None else dtype
    f64 = wd == torch.float64
    levels = ml.levels
    n_mid = len(levels)
    arrs = [_level_arrays(ml, l, wd, transfer_dtype) for l in range(n_mid)]
    Dw = ml.D_vec.to(wd)
    muw = ml.mu_vec.to(wd)
    dinvs = [la.dinv.to(wd) for la in levels]
    # a tensor, so that bf16 takes omega rounded to bf16 as JAX does
    omega = torch.as_tensor(ml.omega, dtype=wd, device=Dw.device)
    Ainv = _coarse_f64(ml) if f64 else ml.Ainv

    def A_masked(l, X):
        # A_l on free rows, zero on constrained ones
        la, ar = levels[l], arrs[l]
        free = la.free[:, None]
        Xm = torch.where(free, X, 0.0)
        if f64:
            Y = la.sys.K.apply_batched(Xm, coef=Dw)
            if la.sys.Adv is not None:
                Y = Y + la.sys.Adv.apply_batched(Xm)
        else:
            Y = band_apply(ar.Kband, Xm, coef=Dw, spans=la.sys.Kspans)
            if ar.Advband is not None:
                Y = Y + band_apply(ar.Advband, Xm, spans=la.sys.Advspans)
        if ar.R_batch is not None:
            Y = ar.R_batch.apply_batched(Xm, out=Y)
        elif ar.R is not None:
            Y = ar.R.apply_batched(Xm, coef=muw, out=Y)
        return torch.where(free, Y, Xm)

    def restrict(l, R):
        la, ar = levels[l], arrs[l]
        if ar.gather is not None:
            _, w, plan = ar.gather
            contrib = w[:, :, None] * R[:, None, :]
            return planned_segment_sum(
                contrib.reshape(-1, R.shape[1]), plan)
        tb = la.bands
        Xq = F.pad(R, (0, 0, 0, tb.pad_r - R.shape[0]))
        Ys = rect_band_apply(ar.r, tb.ro, Xq, tb.rs)[:la.transfer.n_coarse]
        return Ys[tb.isig]

    def prolong(l, Xc):
        la, ar = levels[l], arrs[l]
        if ar.gather is not None:
            cols, w, _ = ar.gather
            return torch.einsum("nk,nkb->nb", w, Xc[cols])
        tb = la.bands
        Xs = Xc[tb.sig]
        Xq = F.pad(Xs, (0, 0, 0, tb.pad_p - Xs.shape[0]))
        return rect_band_apply(ar.p, tb.po, Xq, tb.ps)[:la.free.shape[0]]

    def coarse(rc):
        rc = torch.where(ml.free_c[:, None], rc, 0.0)
        xc = torch.matmul(Ainv, rc.to(Ainv.dtype).t().unsqueeze(-1))
        return xc.squeeze(-1).t().to(wd)

    def smooth(l, x, r):
        return x + omega * dinvs[l] * (r - A_masked(l, x))

    def vcycle(l, r):
        x = omega * dinvs[l] * r                # first step from zero
        for _ in range(n_smooth - 1):
            x = smooth(l, x, r)
        rc = restrict(l, r - A_masked(l, x))
        if l + 1 < n_mid:
            rc = torch.where(levels[l + 1].free[:, None], rc, 0.0)
            xc = vcycle(l + 1, rc)
        else:
            xc = coarse(rc)
        x = x + prolong(l, xc)
        # mirrored post-smooth keeps M symmetric (CG-safe)
        for _ in range(n_smooth):
            x = smooth(l, x, r)
        return x

    def hybrid(R):
        rc = restrict(0, R)
        if n_mid > 1:
            rc = torch.where(levels[1].free[:, None], rc, 0.0)
            xc = vcycle(1, rc)
        else:
            xc = coarse(rc)
        return omega * dinvs[0] * R + prolong(0, xc)

    def additive(R):
        # restrict the residual down the hierarchy, scaled Jacobi on every
        # smoothing level and the dense inverse at the coarsest, prolong
        # and accumulate back up
        rs = [R]
        for l in range(n_mid):
            rc = restrict(l, rs[-1])
            if l + 1 < n_mid:
                rc = torch.where(levels[l + 1].free[:, None], rc, 0.0)
            rs.append(rc)
        c = coarse(rs[-1])
        for l in range(n_mid - 1, -1, -1):
            c = omega * dinvs[l] * rs[l] + prolong(l, c)
        return c

    body = {"hybrid": hybrid, "add": additive,
            "mult": lambda R: vcycle(0, R)}[cycle]
    return lambda R: body(R.to(wd)).to(R.dtype)
