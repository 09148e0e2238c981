"""Batched parameter sweeps (counterpart of ``parallel/sweep.py``).

A sweep shares one mesh and operator sparsity; the coefficients are
factored out,

    A(D, mu) = D * K + R(mu),    R(mu) = mu * R_unit,

and all B sweep columns are solved at once in the batch-minor ``(n, B)``
layout.  The solve is the JAX package's fused mixed-precision program:
an f64 defect-correction loop whose passes are f32 preconditioned CG with a
per-column ``active`` mask, the first pass started from the Dirichlet lift
and one cheap pass that carries the inner recurrence residual.  Only this
configuration is ported; f64 CG, BiCGStab and advection come later.

Operator applies by precision:

  f64 (defect residuals, right-hand side)  K and R through kernel C
  f32 (inner CG)                            K through kernel A (the band),
                                            R through kernel C

Convergence of the inner CG is tested on the host once per iteration
(``any(|r_b| > tol_b)``), one device sync each; the ``active`` masks make
any extra iteration a no-op for converged columns, as in the JAX program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fenics_eff_uptake_tpu.fem.space import FunctionSpace
from fenics_eff_uptake_tpu.meshing.mesh_data import MARKERS, MeshData

from ..fem.assembly import make_bc, robin_facet_block, stiffness_block
from ..ops.band_plans import best_bandwidth_permutation, build_band_plan
from ..ops.banded import band_apply, band_from_elements
from ..ops.elemspmv import (Scatter, element_apply, make_scatter,
                            sorted_segment_sum)

__all__ = ["TransportSystem", "build_transport_system", "system_to",
           "unpermute_columns", "OperatorArgs", "operator_args",
           "apply_operator", "operator_rhs", "fine_dinv", "solve_sweep",
           "BAND_TILE"]

# rows per band tile; systems are padded to a multiple of it (and to
# nothing else)
BAND_TILE = 256
# the JAX package's mixed-solve settings: inner f32 CG steps per pass, f64
# passes, inner residual reduction per pass, cheap passes after the first
N_INNER = 300
MAX_PASSES = 10
INNER_RTOL = 1e-4
CHEAP_PASSES = 1


class _Block(NamedTuple):
    """One element block: f64 and f32 entity matrices + scatter plan."""
    A64: torch.Tensor
    A32: torch.Tensor
    dofs: torch.Tensor        # (N, nd) int32
    scatter: Scatter

    @classmethod
    def build(cls, A64, dofs, ndofs: int):
        """From f64 entity matrices on their device and an (N, nd) numpy
        dof map in the system's numbering of ``ndofs`` rows."""
        dev = A64.device
        return cls(A64=A64, A32=A64.float(),
                   dofs=torch.as_tensor(np.asarray(dofs), dtype=torch.int32,
                                        device=dev),
                   scatter=make_scatter(dofs, ndofs, dev))

    @property
    def ndofs(self):
        return self.scatter.ndofs

    def apply_batched(self, X, coef=None):
        """(n, B) -> (n, B) in X's dtype, ``coef`` (B,) fused per column."""
        A = self.A64 if X.dtype == torch.float64 else self.A32
        return element_apply(A, self.dofs, self.scatter, X, coef)

    def diagonal(self):
        de = torch.diagonal(self.A64, dim1=1, dim2=2).reshape(-1)
        return sorted_segment_sum(de[self.scatter.perm.long()],
                                  self.scatter.ids_sorted, self.ndofs)

    def to(self, device):
        return _Block(A64=self.A64.to(device), A32=self.A32.to(device),
                      dofs=self.dofs.to(device),
                      scatter=Scatter(*[x.to(device) for x in
                                        self.scatter[:3]],
                                      self.scatter.ndofs))


class TransportSystem(NamedTuple):
    K: _Block                 # unit stiffness
    R: Optional[_Block]       # unit-mu Robin
    free: torch.Tensor        # (ndofs,) bool, system numbering
    bc_values: torch.Tensor   # (ndofs,) f64
    ndofs: int                # padded to a multiple of BAND_TILE
    space: FunctionSpace
    Kband: Optional[torch.Tensor] = None   # (T, R, W) f32
    perm: Optional[np.ndarray] = None      # new2old (system -> space)
    iperm: Optional[np.ndarray] = None     # old2new


def system_to(sys: TransportSystem, device) -> TransportSystem:
    """The same system with every tensor on ``device``."""
    return sys._replace(
        K=sys.K.to(device), R=None if sys.R is None else sys.R.to(device),
        free=sys.free.to(device), bc_values=sys.bc_values.to(device),
        Kband=None if sys.Kband is None else sys.Kband.to(device))


def unpermute_columns(sys: TransportSystem, Xcols):
    """(B, ndofs) columns in system numbering -> (B, n_true) in the
    FunctionSpace's dof numbering."""
    n_true = sys.space.ndofs
    if sys.iperm is None:
        return Xcols[:, :n_true]
    idx = torch.as_tensor(sys.iperm[:n_true].astype(np.int64),
                          device=Xcols.device)
    return Xcols[:, idx]


def build_transport_system(mesh: MeshData, device,
                           element="P2") -> TransportSystem:
    """Assemble K (unit stiffness) and R (unit Robin on the bottom wall),
    the Dirichlet lift (c = 1 left, c = 0 right), pad to the band
    tile, reorder for the smallest bandwidth, and build the f32 band of K.

    Padding dofs are constrained identity rows with zero right-hand side."""
    device = torch.device(device)
    space = FunctionSpace(mesh, element)
    bottom = mesh.bc_marker == MARKERS["bottom"]
    K_e, K_dofs = stiffness_block(space, device)
    bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
    n_true = space.ndofs
    ndofs = -(-n_true // BAND_TILE) * BAND_TILE
    free = np.concatenate([bc.free, np.zeros(ndofs - n_true, dtype=bool)])
    bc_values = np.concatenate([bc.values, np.zeros(ndofs - n_true)])

    perm, iperm = best_bandwidth_permutation(
        K_dofs, np.asarray(space.dof_coords), n_true, ndofs)
    K_dofs = iperm[K_dofs]
    K = _Block.build(K_e, K_dofs, ndofs)
    R = None
    if bottom.any():
        R_e, R_dofs = robin_facet_block(space, bottom, device)
        R = _Block.build(R_e, iperm[R_dofs], ndofs)
    plan = build_band_plan(K_dofs, ndofs, tile=BAND_TILE)
    Kband = band_from_elements(K.A32, plan)
    return TransportSystem(
        K=K, R=R,
        free=torch.as_tensor(free[perm], device=device),
        bc_values=torch.as_tensor(bc_values[perm], dtype=torch.float64,
                                  device=device),
        ndofs=ndofs, space=space, Kband=Kband, perm=perm, iperm=iperm)


# ---------------------------------------------------------------------------
# the operator A(D_b, mu_b) on (n, B) columns
# ---------------------------------------------------------------------------

class OperatorArgs(NamedTuple):
    """One precision's view of the sweep operator (``operator_args``)."""
    K: _Block
    R: Optional[_Block]
    Kband: Optional[torch.Tensor]   # used by the f32 view only
    free: torch.Tensor
    D_vec: torch.Tensor             # (B,) in the view's dtype
    mu_vec: torch.Tensor


def operator_args(sys: TransportSystem, D_vec, mu_vec, f32: bool):
    dt = torch.float32 if f32 else torch.float64
    dev = sys.free.device
    return OperatorArgs(
        K=sys.K, R=sys.R, Kband=sys.Kband if f32 else None, free=sys.free,
        D_vec=torch.as_tensor(D_vec, device=dev).to(dt),
        mu_vec=torch.as_tensor(mu_vec, device=dev).to(dt))


def _apply_raw(a: OperatorArgs, X):
    if a.Kband is not None:
        Y = band_apply(a.Kband, X, coef=a.D_vec)
    else:
        Y = a.K.apply_batched(X, coef=a.D_vec)
    if a.R is not None:
        Y = Y + a.R.apply_batched(X, coef=a.mu_vec)
    return Y


def apply_operator(a: OperatorArgs, X):
    """Constrained operator: A on free rows, identity on constrained ones
    (the JAX ``_operator_program`` A_fn)."""
    free = a.free[:, None]
    Y = _apply_raw(a, torch.where(free, X, 0.0))
    return torch.where(free, Y, X)


def operator_rhs(a: OperatorArgs, G):
    """Right-hand side of the lifted system: -A G on free rows, G on
    constrained ones."""
    return torch.where(a.free[:, None], -_apply_raw(a, G), G)


def fine_dinv(sys: TransportSystem, D_vec, mu_vec):
    """(n, B) f32 inverse diagonal of A(D_b, mu_b); 1 on constrained rows."""
    dev = sys.free.device
    D = torch.as_tensor(D_vec, dtype=torch.float64, device=dev)
    mu = torch.as_tensor(mu_vec, dtype=torch.float64, device=dev)
    d = D[None, :] * sys.K.diagonal()[:, None]
    if sys.R is not None:
        d = d + mu[None, :] * sys.R.diagonal()[:, None]
    ok = sys.free[:, None] & (d != 0)
    return torch.where(ok, 1.0 / torch.where(d != 0, d, 1.0),
                       1.0).float()


def _colnorm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _mixed_solve(a64, a32, M, RHS, X0, tol):
    """The JAX ``_mixed_solve_program`` with ``x0_lift=True``: X0 is the
    Dirichlet lift, so the opening residual is where(free, RHS, 0).

    Returns (X, rn (B,) true f64 residual norms, iters (B,), passes)."""
    B = RHS.shape[1]
    free = a64.free[:, None]

    def inner(R64):
        rn0 = _colnorm(R64)
        R = R64.float()
        tol_in = torch.maximum(INNER_RTOL * rn0, 0.1 * tol).float()
        Z = M(R)
        P = Z
        rz = torch.sum(R * Z, dim=0)
        Dx = torch.zeros_like(R)
        cit = torch.zeros(B, dtype=torch.int64, device=R.device)
        for _ in range(N_INNER):
            active = _colnorm(R) > tol_in
            if not bool(active.any()):
                break
            AP = apply_operator(a32, P)
            pAp = torch.sum(P * AP, dim=0)
            alpha = torch.where(active & (pAp != 0),
                                rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
            Dx = Dx + alpha * P
            R = R - alpha * AP
            Z = M(R)
            rz_new = torch.sum(R * Z, dim=0)
            beta = torch.where(active & (rz != 0),
                               rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
            P = torch.where(active, Z + beta * P, P)
            rz = rz_new
            cit = cit + active
        return Dx, R, cit

    def true_pass(X, R64):
        Dx, _, cit = inner(R64)
        X = X + Dx.double()
        R64 = RHS - apply_operator(a64, X)
        return X, R64, _colnorm(R64), cit

    X = X0
    R64 = torch.where(free, RHS, 0.0)
    rn = _colnorm(R64)
    tot = torch.zeros(B, dtype=torch.int64, device=RHS.device)
    k = 0
    # one leading true pass: a cheap pass started at full residual scale
    # would carry ~2^-24 ||b|| of f32 drift
    if bool((rn > tol).any()):
        X, R64, rn, cit = true_pass(X, R64)
        tot, k = tot + cit, k + 1
    # cheap passes carry the inner CG's own recurrence residual
    while k < 1 + CHEAP_PASSES and bool((rn > tol).any()):
        Dx, Rf, cit = inner(R64)
        X = X + Dx.double()
        R64 = Rf.double()
        rn = _colnorm(R64)
        tot, k = tot + cit, k + 1
    # certification: reported norms are always a true f64 residual
    R64 = RHS - apply_operator(a64, X)
    rn = _colnorm(R64)
    while k < MAX_PASSES and bool((rn > tol).any()):
        X, R64, rn, cit = true_pass(X, R64)
        tot, k = tot + cit, k + 1
    return X, rn, tot, k


def solve_sweep(sys: TransportSystem, D_values, mu_values, rtol=1e-12,
                multilevel=None):
    """Batched mixed-precision transport solve over sweep points.

    D_values, mu_values: (B,).  multilevel: a ``solvers.multilevel``
    hierarchy (hybrid cycle); None preconditions with Jacobi.
    Returns (X (B, n_true) f64 in FunctionSpace numbering, info) with info
    keys iters (B,), resnorm (B,), rel_resnorm (B,), passes."""
    dev = sys.free.device
    D_vec = torch.as_tensor(np.asarray(D_values, dtype=np.float64),
                            device=dev)
    mu_vec = torch.as_tensor(np.asarray(mu_values, dtype=np.float64),
                             device=dev)
    B = int(D_vec.shape[0])
    a64 = operator_args(sys, D_vec, mu_vec, f32=False)
    a32 = operator_args(sys, D_vec, mu_vec, f32=True)
    G = sys.bc_values[:, None].expand(-1, B).contiguous()
    RHS = operator_rhs(a64, G)
    if multilevel is not None:
        from ..solvers.multilevel import make_ml_preconditioner
        M = make_ml_preconditioner(multilevel)
    else:
        dinv = fine_dinv(sys, D_vec, mu_vec)

        def M(R):
            return dinv * R
    bnorm = _colnorm(RHS)
    X, rn, tot, passes = _mixed_solve(a64, a32, M, RHS, G, rtol * bnorm)
    bn = bnorm.cpu().numpy()
    resnorm = rn.cpu().numpy()
    info = {"iters": tot.cpu().numpy(), "resnorm": resnorm,
            "rel_resnorm": resnorm / np.where(bn > 0, bn, 1.0),
            "passes": int(passes)}
    return unpermute_columns(sys, X.t()), info
