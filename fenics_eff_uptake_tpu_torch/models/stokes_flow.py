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

``stokes_solve_mg(precision="f64")`` is the JAX package's f64 branch (its
CPU default): one f64 MINRES on the f64 saddle, preconditioned by the f64
mult cycle (every velocity apply in kernel C, f64, B = 2) with the same
pressure block in f64.  ``pin_outlet_pressure=True`` pins p = 0 at the
pressure dof nearest the outlet's bottom corner (the reference's
``OutletPoint``); off by default, since the do-nothing outflow already
fixes the level.

``stokes_solve_schur`` is the Uzawa fallback: flexible CG on the pressure
Schur complement (``solvers/stokes.py``) with Jacobi-CG inner velocity
solves (f32 passes in f64 refinement under ``precision="mixed"``).  Its
velocity Laplacian is the scalar stiffness K applied to the (ns, 2)
layout, the two components as B = 2 columns, as ``stokes_setup`` applies
it: kernel C at nd = 6, not an nd = 12 instantiation of kron(K, I_2)
(``fem.assembly.vector_stiffness_block`` builds that one for host use and
tests).

The divergence applies are an einsum and a segment sum in plain PyTorch, as
they are XLA ops in the JAX package; the segment sums are the deterministic
``planned_segment_sum``.  Shape buckets are not ported.

``stokes_solve`` (``method="mg"`` or ``"schur"``, the JAX package's
``FEU_STOKES``) keeps the solved field in the setup cache (tag
``port-stokes``), as the JAX package's ``stokes_solve`` does: a converged
field is stored, and a hit reloads it in place of the setup and solve.

Tracing (``utils.profiling``): spans ``stokes.setup`` (``stokes_setup``
in ``stokes_solve_mg``), ``stokes.pass`` (one per MINRES pass) and
``stokes.certify`` (the f64 defect residuals); each ``saddle_solve``
counts one in ``stokes_solves``, its MINRES iterations in
``minres_steps`` and its host reads in ``stokes_host_syncs``, never in
the transport solves' counters.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..fem.assembly import (divergence_block, make_bc, mass_block,
                            stiffness_block)
from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.elemspmv import (SegmentPlan, make_segment_plan,
                            planned_segment_sum)
from ..parallel.sweep import (_Block, apply_operator,
                              build_transport_system, operator_args,
                              operator_rhs)
from ..solvers.minres import minres_tree
from ..solvers.stokes import stokes_schur_cg
from ..solvers.multilevel import (build_multilevel, level_meshes_for,
                                  make_ml_preconditioner)
from ..utils import profiling
from ..utils.diskcache import cache_key_of, count, load_arrays, store_arrays
from ..utils.profiling import span, stokes_read

__all__ = ["taylor_hood_spaces", "stokes_zero_fields", "StokesSetup",
           "stokes_setup", "saddle_solve", "stokes_solve_mg",
           "stokes_solve_schur", "stokes_solve", "cached_field",
           "STOKES_TAG"]

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
PRECISIONS = ("mixed", "f64")


def taylor_hood_spaces(mesh: MeshData):
    return FunctionSpace(mesh, "P2", vs=2), FunctionSpace(mesh, "P1")


def stokes_zero_fields(mesh: MeshData):
    """Zero velocity and pressure (numpy values), the no-adv mode's."""
    V, Q = taylor_hood_spaces(mesh)
    return V.new_function(), Q.new_function()


def _outlet_pin(Q: FunctionSpace):
    """The pressure dof nearest the outlet's bottom corner (max x, y = 0)."""
    pc = Q.dof_coords
    corner = np.array([pc[:, 0].max(), 0.0])
    return int(np.argmin(((pc - corner) ** 2).sum(1)))


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
    M64: object               # the same in f64 (precision "f64"; or None)
    b: tuple                  # (rU (ns, 2), rp (np,)) f64 right-hand side
    G: torch.Tensor           # (ns, 2) Poiseuille lift
    sysV: object              # velocity TransportSystem (B = 2 columns)
    V: FunctionSpace
    Q: FunctionSpace
    # the parts the operators close over, which the sharded saddle solve
    # splits or copies (``parallel/sharded_solve.stokes_host``)
    div: Optional[_Divergence] = None
    ml: object = None         # the velocity hierarchy (B = 2 columns)
    free_p: Optional[torch.Tensor] = None
    mp_inv: Optional[torch.Tensor] = None   # lumped pressure mass^-1 (f64)
    Z: Optional[torch.Tensor] = None        # coarse pressure basis (np, KZ)
    Cinv: Optional[torch.Tensor] = None     # its correction (KZ, KZ) f64


def _widened(ml, ncols):
    """The hierarchy of a unit-D, mu = 0 sweep applied to ``ncols``
    columns at once: inverse diagonals and the coarsest inverse of column
    0 broadcast over all of them.  It shares the hierarchy's copies in
    other dtypes (``lowp``)."""
    dev = ml.D_vec.device
    return ml._replace(
        levels=tuple(la._replace(dinv=la.dinv[:, :1]) for la in ml.levels),
        Ainv=ml.Ainv[:1],
        A_c=None if ml.A_c is None else ml.A_c[:1],
        D_vec=torch.ones(ncols, dtype=torch.float64, device=dev),
        mu_vec=torch.zeros(ncols, dtype=torch.float64, device=dev))


def stokes_setup(mesh: MeshData, H: float, device, ml_dtype=None,
                 transfer_dtype=None, n_smooth=1,
                 coarse_inverse="lapack", precision="mixed",
                 pin_outlet_pressure=False) -> StokesSetup:
    """Operators, preconditioner and right-hand side of the saddle
    system (the JAX ``_stokes_mg_setup``).  ml_dtype, transfer_dtype and
    n_smooth: the velocity block's mult cycle, as
    ``make_ml_preconditioner`` takes them; coarse_inverse: its hierarchy's,
    as ``build_multilevel`` does.  precision "f64" adds the f64
    preconditioner (``M64``: the f64 cycle); pin_outlet_pressure pins the
    pressure at the outlet's bottom corner."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown Stokes precision {precision!r}")
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
                          with_robin=False, coarse_inverse=coarse_inverse)
    cyc = dict(cycle="mult", dtype=ml_dtype, transfer_dtype=transfer_dtype,
               n_smooth=n_smooth)
    a64 = operator_args(sysV, np.ones(2), np.zeros(2), f32=False)
    a32 = operator_args(sysV, np.ones(2), np.zeros(2), f32=True)
    free_p_np = np.ones(np_, dtype=bool)
    if pin_outlet_pressure:
        free_p_np[_outlet_pin(Q)] = False
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
    wide = make_ml_preconditioner(_widened(ml, 2 * KZ), **cyc)
    W = wide(VT.float().permute(0, 2, 1).reshape(ns, 2 * KZ).contiguous())
    Wm = W.reshape(ns, KZ, 2).permute(0, 2, 1)
    S_Z = stokes_read(torch.einsum("nik,niz->kz", VT, Wm.double()))
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

    Mv = make_ml_preconditioner(ml, **cyc)
    Z32, Cinv32, mp32 = Z.float(), Cinv.float(), mp_inv.float()

    def block_M(Mvel, Zd, Cinvd, mpd):
        def M(x):
            U, p = x
            corr = Zd @ (Cinvd @ (Zd.T @ p))
            return Mvel(U), mpd * p + corr
        return M

    M64 = None
    if precision == "f64":
        Mv64 = make_ml_preconditioner(ml, cycle="mult", dtype=torch.float64,
                                      n_smooth=n_smooth)
        M64 = block_M(Mv64, Z, Cinv, mp_inv)
    return StokesSetup(S64=_saddle(a64, div, free_p),
                       S32=_saddle(a32, div, free_p),
                       M32=block_M(Mv, Z32, Cinv32, mp32), M64=M64,
                       b=(rU, rp), G=G, sysV=sysV, V=V, Q=Q, div=div,
                       ml=ml, free_p=free_p, mp_inv=mp_inv, Z=Z, Cinv=Cinv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def _norm(x):
    return float(stokes_read(torch.sqrt(sum(torch.sum(t * t) for t in x))))


def _defect(st, x):
    """The f64 saddle residual b - S x and its norm."""
    with span("stokes.certify"):
        SU, Sp = st.S64(x)
        r = (st.b[0] - SU, st.b[1] - Sp)
        return r, _norm(r)


def saddle_solve(st: StokesSetup, rtol=OUTER_RTOL, precision="mixed"):
    """f32 MINRES passes inside f64 defect correction on a set-up saddle
    system (``precision="f64"``: one f64 MINRES with the f64
    preconditioner, converged by MINRES's own preconditioned-residual
    test, as the JAX f64 branch).  Returns ((U (ns, 2), p) f64 without the
    lift, info) with info outer_iters (MINRES iterations, all passes),
    passes, resnorm and rel_resnorm (the true f64 saddle residual of the
    result) and converged."""
    b = st.b
    bnorm = _norm(b)
    profiling.stokes_solves += 1
    if precision == "f64":
        if st.M64 is None:
            raise ValueError("this setup has no f64 preconditioner")
        with span("stokes.pass"):
            res = minres_tree(st.S64, b, st.M64, rtol=rtol, maxiter=3000,
                              chunk_iters=CHUNK)
        _, rn = _defect(st, res.x)
        return res.x, {"outer_iters": int(res.iters), "passes": 1,
                       "resnorm": rn, "rel_resnorm": rn / max(bnorm, 1e-300),
                       "converged": bool(res.converged)}
    x = tuple(torch.zeros_like(t) for t in b)
    total_iters = passes = 0
    for _ in range(MAX_PASSES):
        r, rn = _defect(st, x)
        if rn <= rtol * max(bnorm, 1e-300):
            break
        with span("stokes.pass"):
            res = minres_tree(st.S32, tuple(t.float() for t in r), st.M32,
                              rtol=PASS_RTOL, maxiter=3000,
                              chunk_iters=CHUNK)
        total_iters += res.iters
        passes += 1
        x = tuple(xi + di.double() for xi, di in zip(x, res.x))
    else:
        _, rn = _defect(st, x)
    return x, {"outer_iters": int(total_iters), "passes": passes,
               "resnorm": rn, "rel_resnorm": rn / max(bnorm, 1e-300),
               "converged": bool(rn <= rtol * max(bnorm, 1e-300))}


def stokes_solve_mg(mesh: MeshData, H: float, device, rtol=OUTER_RTOL,
                    precision="mixed", pin_outlet_pressure=False,
                    **cycle_options):
    """Velocity and pressure Functions (numpy values in FunctionSpace
    numbering): ``stokes_setup`` then ``saddle_solve``, in ``precision``
    "mixed" (f32 MINRES passes in f64 defect correction) or "f64" (one f64
    MINRES).  Both carry ``solver_info``: the ``saddle_solve`` report plus
    inner_iters (0), method, setup_s and solve_s (each ending in a device
    sync)."""
    device = torch.device(device)
    t0 = time.time()
    with span("stokes.setup"):
        st = stokes_setup(mesh, H, device, precision=precision,
                          pin_outlet_pressure=pin_outlet_pressure,
                          **cycle_options)
    t1 = _sync(device)
    x, info = saddle_solve(st, rtol, precision)
    t2 = _sync(device)
    U = stokes_read(st.G + x[0])[st.sysV.iperm[:st.sysV.space.ndofs]]
    u = Function(st.V, U.reshape(-1))
    p = Function(st.Q, stokes_read(x[1]))
    info.update(inner_iters=0, method="minres+mg", setup_s=t1 - t0,
                solve_s=t2 - t1)
    u.solver_info = info
    p.solver_info = info
    return u, p


def stokes_solve_schur(mesh: MeshData, H: float, device, inner_rtol=5e-13,
                       outer_rtol=1e-11, outer_maxiter=400,
                       precision="mixed"):
    """The Uzawa fallback: flexible CG on the pressure Schur complement
    (``solvers/stokes.stokes_schur_cg``), the velocity solves by Jacobi CG
    in f64, or (``precision="mixed"``) in f32 passes inside f64
    refinement.  Returns (u, p) as ``stokes_solve_mg``; ``solver_info``:
    outer_iters, inner_iters, resnorm (the Schur residual), converged,
    method "schur", setup_s, solve_s."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown Stokes precision {precision!r}")
    device = torch.device(device)
    t0 = time.time()
    V, Q = taylor_hood_spaces(mesh)
    # the scalar P2 stiffness on V's scalar dofs (its own numbering);
    # A(X): the vector Laplacian on interleaved (2 ns, 1) columns, applied
    # as K on (ns, 2) in X's dtype
    S = FunctionSpace(mesh, V.element)
    K_e, dofs = stiffness_block(S, device)
    K = _Block.build(K_e, dofs, S.ndofs)

    def A(X):
        return K.apply_batched(X.reshape(-1, 2)).reshape(-1, 1)

    B_e, rd, cd = divergence_block(Q, V, device)
    div = _Divergence(B64=B_e, B32=B_e.float(),
                      rdofs=torch.as_tensor(rd, device=device),
                      cdofs=torch.as_tensor(cd, device=device),
                      rplan=make_segment_plan(rd, Q.ndofs, device),
                      cplan=make_segment_plan(cd, V.ndofs, device))

    def inflow(x, y):
        return np.stack([4.0 * y * (H - y), np.zeros_like(y)], axis=1)

    bc = make_bc(V, [(MARKERS["left"], inflow), (MARKERS["bottom"], 0.0),
                     (MARKERS["top"], 0.0)])
    M_e, md = mass_block(Q, device)
    mp_lump = planned_segment_sum(M_e.sum(dim=2).reshape(-1),
                                  make_segment_plan(md, Q.ndofs, device))
    mp_inv = 1.0 / torch.where(mp_lump > 0, mp_lump, 1.0)
    t1 = _sync(device)
    res = stokes_schur_cg(
        A, div, bc, Mp_inv=lambda r: mp_inv.to(r.dtype) * r,
        A_diag=K.diagonal().repeat_interleave(2), A_apply32=A,
        inner_rtol=inner_rtol, outer_rtol=outer_rtol,
        outer_maxiter=outer_maxiter, precision=precision)
    t2 = _sync(device)
    u = Function(V, res.u.cpu().numpy())
    p = Function(Q, res.p.cpu().numpy())
    info = {"outer_iters": int(res.outer_iters),
            "inner_iters": int(res.inner_iters),
            "resnorm": float(res.resnorm), "converged": bool(res.converged),
            "method": "schur", "setup_s": t1 - t0, "solve_s": t2 - t1}
    u.solver_info = info
    p.solver_info = info
    return u, p


STOKES_TAG = "port-stokes"
# the cycle options of stokes_setup, in the order they join the key
_CYCLE_OPTIONS = ("ml_dtype", "transfer_dtype", "n_smooth", "coarse_inverse")
METHODS = ("mg", "schur")


def stokes_solve(mesh: MeshData, H: float, device, rtol=OUTER_RTOL,
                 method="mg", precision="mixed", inner_rtol=5e-13,
                 outer_maxiter=400, **cycle_options):
    """``stokes_solve_mg`` (``method="mg"``) or ``stokes_solve_schur``
    (``"schur"``, with ``inner_rtol`` and ``outer_maxiter``; ``rtol`` is
    its outer rtol) behind the setup cache (``cached_field``, the JAX
    package's ``stokes_solve`` checkpoint): keyed by the mesh, H, rtol,
    the precision ("mixed" or "f64"), the velocity hierarchy's cycle
    options and, for the Schur method, the method and its two options."""
    device = torch.device(device)
    if method not in METHODS:
        raise ValueError(f"unknown Stokes method {method!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown Stokes precision {precision!r}")
    unknown = set(cycle_options) - set(_CYCLE_OPTIONS)
    if unknown:
        raise TypeError(f"unknown Stokes cycle options {sorted(unknown)}")
    if method == "schur" and cycle_options:
        raise TypeError(f"the Schur method has no cycle: "
                        f"{sorted(cycle_options)}")
    opts = {"ml_dtype": None, "transfer_dtype": None, "n_smooth": 1,
            "coarse_inverse": "lapack", **cycle_options}
    # the Schur method's accuracy also rides on its inner rtol and outer
    # cap; they stay out of the mg key, which is as it was
    extra = (("schur", float(inner_rtol), int(outer_maxiter))
             if method == "schur" else ())
    key = cache_key_of(
        "stokes-v1", np.asarray(mesh.vertices), np.asarray(mesh.cells),
        np.asarray(mesh.bc_marker), float(H), float(rtol), precision,
        *[str(opts[k]) for k in _CYCLE_OPTIONS], *extra)
    if method == "mg":
        return cached_field(key, mesh, lambda: stokes_solve_mg(
            mesh, H, device, rtol=rtol, precision=precision,
            **cycle_options))
    return cached_field(key, mesh, lambda: stokes_solve_schur(
        mesh, H, device, inner_rtol=inner_rtol, outer_rtol=rtol,
        outer_maxiter=outer_maxiter, precision=precision))


def cached_field(key, mesh: MeshData, solve):
    """The field (u, p) of ``solve()`` behind the setup cache under
    ``key`` (tag ``port-stokes``): a converged field is stored with its
    report; one that did not converge never is.  A hit returns the stored
    values with the stored report, its method marked ``+cache``, setup_s
    the seconds of the load and solve_s 0."""
    t0 = time.time()
    hit = load_arrays(STOKES_TAG, key)
    if hit is not None:
        V, Q = taylor_hood_spaces(mesh)
        info = {"outer_iters": int(hit["outer_iters"]),
                "inner_iters": int(hit.get("inner_iters", 0)),
                "passes": int(hit["passes"]),
                "resnorm": float(hit["resnorm"]),
                "rel_resnorm": float(hit["rel_resnorm"]),
                "converged": bool(hit["converged"]),
                "method": str(hit["method"]) + "+cache",
                "setup_s": time.time() - t0, "solve_s": 0.0}
        u = Function(V, np.asarray(hit["u"], dtype=np.float64))
        p = Function(Q, np.asarray(hit["p"], dtype=np.float64))
        u.solver_info = p.solver_info = info
        return u, p
    count(STOKES_TAG, "miss")
    u, p = solve()
    info = u.solver_info
    # a stored field is replayed for ever: only a converged one is kept
    if info["converged"]:
        store_arrays(STOKES_TAG, key, {
            "u": np.asarray(u.values), "p": np.asarray(p.values),
            "passes": info.get("passes", 0),
            "rel_resnorm": info.get("rel_resnorm", float("nan")),
            **{k: info[k] for k in ("outer_iters", "inner_iters", "resnorm",
                                    "converged", "method")}})
    return u, p
