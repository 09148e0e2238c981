"""Stokes flow in the channel (counterpart of ``models/stokes_flow.py``).

Taylor-Hood (vector P2 velocity, P1 pressure), Poiseuille inflow
u = (4 y (H - y), 0) on the left wall, no slip on top and bottom, natural
(do-nothing) outflow on the right, which also fixes the pressure level.

The saddle system [[A, B^T], [B, 0]] is solved whole by block-
preconditioned MINRES, in the configuration the JAX package runs on a TPU:

* A = kron(K_scalar, I_2) runs as the scalar transport operator with the two
  velocity components as B = 2 columns: the banded K (kernel A) in the f32
  MINRES passes, the element K (kernel C, f64) in the defect residuals;
* the preconditioner is diag(MG(A), lumped pressure mass^-1 + deflation):
  the multiplicative V(1,1) cycle of ``solvers.multilevel`` on the velocity
  Laplacian, and a coarse-pressure correction Z (Z^T S~ Z)^-1 Z^T that lifts
  the elongated channel's small inf-sup modes (``_coarse_pressure_basis``);
  S~ = B MG(A) B^T is built by sending all 2 * KZ = 96 mode images through
  the f32 cycle in one wide apply;
* f32 MINRES passes (pass rtol 2e-5, chunks of 80 steps) inside f64 defect
  correction (at most 8 passes, outer rtol 1e-9 on the true f64 residual).

The divergence applies are an einsum and a segment sum in plain PyTorch, as
they are XLA ops in the JAX package; the segment sums are the deterministic
``planned_segment_sum``.  Shape buckets are not ported; the disk checkpoint
of the solved field and the Schur (Uzawa) fallback are not ported yet.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..fem.assembly import divergence_block, mass_block
from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.elemspmv import (SegmentPlan, make_segment_plan,
                            planned_segment_sum)
from ..parallel.sweep import (apply_operator, build_transport_system,
                              operator_args, operator_rhs)
from ..solvers.minres import minres_tree
from ..solvers.multilevel import (build_multilevel, level_meshes_for,
                                  make_ml_preconditioner)

__all__ = ["taylor_hood_spaces", "StokesSetup", "stokes_setup",
           "saddle_solve", "stokes_solve_mg"]

# velocity walls: the inflow values ride in the lift G, so every Dirichlet
# value of the velocity system is zero
VELOCITY_DIRICHLET = [(MARKERS["left"], 0.0), (MARKERS["top"], 0.0),
                      (MARKERS["bottom"], 0.0)]
KZ = 48             # coarse-pressure basis width (zero columns unused)
COARSE_SCALE = 0.3  # places corrected modes just above the bulk's centre
CHUNK = 80          # MINRES steps per host check
PASS_RTOL = 2e-5    # f32 MINRES stagnates below ~1e-5 on this saddle
MAX_PASSES = 8
OUTER_RTOL = 1e-9   # the JAX ``stokes_solve`` default


def taylor_hood_spaces(mesh: MeshData):
    return FunctionSpace(mesh, "P2", vs=2), FunctionSpace(mesh, "P1")


class _Divergence(NamedTuple):
    """B (pressure rows, interleaved velocity columns in the velocity
    system's numbering) with its segment-sum plans."""
    B64: torch.Tensor         # (NB, np_e, 2 nd) f64
    B32: torch.Tensor
    rdofs: torch.Tensor       # (NB, np_e) pressure dofs
    cdofs: torch.Tensor       # (NB, 2 nd) 2 * velocity dof + component
    rplan: SegmentPlan        # entries -> pressure dofs
    cplan: SegmentPlan        # entries -> 2 * ns velocity slots

    def apply(self, U):
        """B U: (ns, 2) -> (np,) in U's dtype."""
        Be = self.B64 if U.dtype == torch.float64 else self.B32
        ye = torch.einsum("nij,nj->ni", Be, U.reshape(-1)[self.cdofs])
        return planned_segment_sum(ye.reshape(-1), self.rplan)

    def apply_t(self, p):
        """B^T p: (np, ...) -> (2 ns, ...) interleaved, in p's dtype."""
        Be = self.B64 if p.dtype == torch.float64 else self.B32
        ye = torch.einsum("nij,ni...->nj...", Be, p[self.rdofs])
        return planned_segment_sum(ye.reshape((-1,) + tuple(p.shape[1:])),
                                   self.cplan)


def _saddle(a, div: _Divergence, free_p):
    """The saddle operator (U, p) -> (A U + B^T p, B U) of one precision's
    operator view ``a``: identity on constrained velocity rows, as JAX's
    ``_saddle_program``."""
    free = a.free[:, None]

    def S(x):
        U, p = x
        Um = torch.where(free, U, 0.0)
        pm = torch.where(free_p, p, 0.0)
        Btp = div.apply_t(pm).reshape(U.shape)
        opU = apply_operator(a, U) + torch.where(free, Btp, 0.0)
        Bu = torch.where(free_p, div.apply(Um), p)
        return opU, Bu
    return S


def _coarse_pressure_basis(Q, H, np_true, free_p_np, mp_lump):
    """Coarse pressure space for the Schur-side deflation (the JAX
    ``_coarse_pressure_basis``, unpadded rows): cosines along the channel,
    a depth ladder and x-enrichment in the sulcus cavity, and four corner
    bumps, Mp-orthonormalised.  Returns (np_true, KZ), zero columns beyond
    the kept rank."""
    pc = np.asarray(Q.dof_coords)[:np_true]
    x, y = pc[:, 0], pc[:, 1]
    W = max(float(np.ptp(x)), 1e-30)
    xn = (x - x.min()) / W
    AR = W / max(H, 1e-30)
    K = int(np.clip(np.ceil(1.2 * AR) + 3, 6, 20))
    cols = [np.cos(k * np.pi * xn) for k in range(K)]
    sul = y < -1e-12
    if sul.any():
        ind = sul.astype(float)
        depth = max(float(-y.min()), 1e-30)
        xs = x[sul]
        wid = max(float(np.ptp(xs)) if xs.size else 0.0, 1e-30)
        xc = float(xs.mean()) if xs.size else 0.0
        yn = np.clip(-y / depth, 0.0, 1.0)
        xh = (x - xc) / wid
        K_cav = int(np.clip(np.ceil(1.2 * depth / wid) + 3, 3, KZ - K - 7))
        for k in range(K_cav):
            cols.append(ind * np.cos(k * np.pi * yn))
        for k in range(min(3, K_cav)):
            cols.append(ind * xh * np.cos(k * np.pi * yn))
    sig = 0.15 * H
    for cx in (x.min(), x.max()):
        for cy in (0.0, H):
            r2 = (x - cx) ** 2 + (y - cy) ** 2
            cols.append(np.exp(-r2 / (2.0 * sig * sig)))
    Z0 = np.stack(cols, axis=1)
    Z0[~free_p_np[:np_true]] = 0.0
    w = np.sqrt(np.clip(mp_lump, 1e-300, None))
    Qm, Rm = np.linalg.qr(Z0 * w[:, None])
    d = np.abs(np.diag(Rm))
    keep = d > 1e-10 * d.max()
    Zq = Qm[:, keep] / w[:, None]
    Z = np.zeros((np_true, KZ))
    Z[:, :Zq.shape[1]] = Zq
    return Z


class StokesSetup(NamedTuple):
    S64: object               # f64 saddle operator (defect residuals)
    S32: object               # f32 saddle operator (MINRES passes)
    M32: object               # block preconditioner
    b: tuple                  # (rU (ns, 2), rp (np,)) f64 right-hand side
    G: torch.Tensor           # (ns, 2) Poiseuille lift
    sysV: object              # velocity TransportSystem (B = 2 columns)
    V: FunctionSpace
    Q: FunctionSpace


def _widened(ml, ncols):
    """The hierarchy of a unit-D, mu = 0 sweep applied to ``ncols``
    columns at once: inverse diagonals and the coarsest inverse of column
    0 broadcast over all of them."""
    dev = ml.D_vec.device
    return ml._replace(
        levels=tuple(la._replace(dinv=la.dinv[:, :1]) for la in ml.levels),
        Ainv=ml.Ainv[:1],
        D_vec=torch.ones(ncols, dtype=torch.float64, device=dev),
        mu_vec=torch.zeros(ncols, dtype=torch.float64, device=dev))


def stokes_setup(mesh: MeshData, H: float, device) -> StokesSetup:
    """Operators, preconditioner and right-hand side of the saddle
    system (the JAX ``_stokes_mg_setup``)."""
    device = torch.device(device)
    sysV = build_transport_system(mesh, device, "P2",
                                  dirichlet=VELOCITY_DIRICHLET,
                                  with_robin=False)
    ns = sysV.ndofs
    iperm_v = sysV.iperm
    V, Q = taylor_hood_spaces(mesh)
    np_ = Q.ndofs
    B_e, rd, cd = divergence_block(Q, V, device)
    cd = iperm_v[cd // 2].astype(np.int64) * 2 + cd % 2
    div = _Divergence(B64=B_e, B32=B_e.float(),
                      rdofs=torch.as_tensor(rd, device=device),
                      cdofs=torch.as_tensor(cd, device=device),
                      rplan=make_segment_plan(rd, np_, device),
                      cplan=make_segment_plan(cd, 2 * ns, device))

    # Poiseuille lift on the x-component of the left-wall dofs
    left = sysV.space.boundary_scalar_dofs(mesh.bc_marker == MARKERS["left"])
    yv = sysV.space.dof_coords[left][:, 1]
    Gn = np.zeros((ns, 2))
    Gn[iperm_v[left], 0] = 4.0 * yv * (H - yv)
    G = torch.as_tensor(Gn, device=device)

    # lumped pressure mass (host)
    M_e, md = mass_block(Q, "cpu")
    mp_lump = np.zeros(np_)
    np.add.at(mp_lump, md.ravel(), M_e.numpy().sum(axis=2).ravel())
    mp_inv = torch.as_tensor(1.0 / np.clip(mp_lump, 1e-300, None),
                             device=device)

    ml = build_multilevel(sysV, level_meshes_for(mesh), np.ones(2),
                          np.zeros(2), dirichlet=VELOCITY_DIRICHLET,
                          with_robin=False)
    a64 = operator_args(sysV, np.ones(2), np.zeros(2), f32=False)
    a32 = operator_args(sysV, np.ones(2), np.zeros(2), f32=True)
    free_p_np = np.ones(np_, dtype=bool)
    free_p = torch.as_tensor(free_p_np, device=device)
    free = sysV.free[:, None]
    rU = torch.where(free, operator_rhs(a64, G), 0.0)
    rp = torch.where(free_p, -div.apply(G), 0.0)

    # coarse Schur correction: S~ = B MG(A) B^T projected on Z, with every
    # mode image V_k = mask_free(B^T z_k) through the f32 cycle in ONE
    # (ns, 2 KZ) apply (kernels A and B at B = 96)
    Z_np = _coarse_pressure_basis(Q, H, np_, free_p_np, mp_lump)
    Z = torch.as_tensor(Z_np, device=device)
    VT = div.apply_t(Z).reshape(ns, 2, KZ)
    VT = torch.where(free[:, :, None], VT, 0.0)
    wide = make_ml_preconditioner(_widened(ml, 2 * KZ), cycle="mult")
    W = wide(VT.float().permute(0, 2, 1).reshape(ns, 2 * KZ).contiguous())
    Wm = W.reshape(ns, KZ, 2).permute(0, 2, 1)
    S_Z = torch.einsum("nik,niz->kz", VT, Wm.double()).cpu().numpy()
    S_Z = 0.5 * (S_Z + S_Z.T)
    # zero (rank-dropped) columns: identity diagonal so the inverse exists;
    # their Z columns are zero, so they add nothing to the correction
    zero_cols = ~np.any(np.abs(Z_np) > 0.0, axis=0)
    S_Z[zero_cols, :] = 0.0
    S_Z[:, zero_cols] = 0.0
    S_Z[zero_cols, zero_cols] = 1.0
    ws, Vs = np.linalg.eigh(S_Z)
    ws = np.clip(ws, 1e-10 * max(ws.max(), 1e-30), None)
    Cinv = torch.as_tensor(COARSE_SCALE * (Vs / ws) @ Vs.T, device=device)

    Mv = make_ml_preconditioner(ml, cycle="mult")
    Z32, Cinv32, mp32 = Z.float(), Cinv.float(), mp_inv.float()

    def M32(x):
        U, p = x
        corr = Z32 @ (Cinv32 @ (Z32.T @ p))
        return Mv(U), mp32 * p + corr

    return StokesSetup(S64=_saddle(a64, div, free_p),
                       S32=_saddle(a32, div, free_p), M32=M32, b=(rU, rp),
                       G=G, sysV=sysV, V=V, Q=Q)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def _norm(x):
    return float(torch.sqrt(sum(torch.sum(t * t) for t in x)))


def saddle_solve(st: StokesSetup, rtol=OUTER_RTOL):
    """f32 MINRES passes inside f64 defect correction on a set-up saddle
    system.  Returns ((U (ns, 2), p) f64 without the lift, info) with info
    outer_iters (MINRES iterations, all passes), passes, resnorm and
    rel_resnorm (the true f64 saddle residual that stopped the loop) and
    converged."""
    b = st.b
    bnorm = _norm(b)
    x = tuple(torch.zeros_like(t) for t in b)
    total_iters = passes = 0
    for _ in range(MAX_PASSES):
        SU, Sp = st.S64(x)
        r = (b[0] - SU, b[1] - Sp)
        rn = _norm(r)
        if rn <= rtol * max(bnorm, 1e-300):
            break
        res = minres_tree(st.S32, tuple(t.float() for t in r), st.M32,
                          rtol=PASS_RTOL, maxiter=3000, chunk_iters=CHUNK)
        total_iters += res.iters
        passes += 1
        x = tuple(xi + di.double() for xi, di in zip(x, res.x))
    else:
        SU, Sp = st.S64(x)
        rn = _norm((b[0] - SU, b[1] - Sp))
    return x, {"outer_iters": int(total_iters), "passes": passes,
               "resnorm": rn, "rel_resnorm": rn / max(bnorm, 1e-300),
               "converged": bool(rn <= rtol * max(bnorm, 1e-300))}


def stokes_solve_mg(mesh: MeshData, H: float, device, rtol=OUTER_RTOL):
    """Velocity and pressure Functions (numpy values in FunctionSpace
    numbering): ``stokes_setup`` then ``saddle_solve``.  Both carry
    ``solver_info``: the ``saddle_solve`` report plus method, setup_s and
    solve_s (each ending in a device sync)."""
    device = torch.device(device)
    t0 = time.time()
    st = stokes_setup(mesh, H, device)
    t1 = _sync(device)
    x, info = saddle_solve(st, rtol)
    t2 = _sync(device)
    U = (st.G + x[0]).cpu().numpy()[st.sysV.iperm[:st.sysV.space.ndofs]]
    u = Function(st.V, U.reshape(-1))
    p = Function(st.Q, x[1].cpu().numpy())
    info.update(method="minres+mg", setup_s=t1 - t0, solve_s=t2 - t1)
    u.solver_info = info
    p.solver_info = info
    return u, p
