"""Batched parameter sweeps (counterpart of ``parallel/sweep.py``).

A sweep shares one mesh and operator sparsity; the coefficients are
factored out,

    A(D, mu) = D * K + Adv + R(mu),    R(mu) = mu * R_unit,

or, for a spatially varying mu_b(x) per column (the step-mu studies), R_b a
per-sample batch of Robin facet matrices on R_unit's facets
(``robin_matrices_for_mu``, ``solve_sweep(robin_matrices=)``);
with Adv the advection by one fixed velocity field (the nondimensional
Stokes field is Pe-independent, so one velocity feeds every Pe column), and
all B sweep columns are solved at once in the batch-minor ``(n, B)`` layout.
Both solves are f64 defect-correction loops around f32 preconditioned
Krylov passes with per-column ``active`` masks, as the JAX package runs
them on a TPU:

  symmetric (no Adv)   the fused mixed program: f32 CG passes, the first
                       started from the Dirichlet lift, one cheap pass that
                       carries the inner recurrence residual
  nonsymmetric (Adv)   up to 12 true passes of f32 BiCGStab (the
                       per-pass refine program); no cheap passes

Operator applies by precision:

  f64 (defect residuals, right-hand side)  K, Adv and R through kernel C
  f32 (inner Krylov)                        K and Adv through kernel A (the
                                            bands), R through kernel C

R is added last, in place, into the rows it touches (kernel C's ``out=``
form, shared or per-sample), with the rounding of the separate apply and
add.

Convergence of the inner iteration is tested on the host once per
iteration (``any(|r_b| > tol_b)``), one device sync each; the ``active``
masks make any extra iteration a no-op for converged columns, as in the
JAX programs.  f64 CG and f64 BiCGStab (the JAX CPU default) are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..fem.assembly import (advection_block, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.band_plans import best_bandwidth_permutation, build_band_plan
from ..ops.banded import band_apply, band_from_elements, band_spans
from ..ops.elemspmv import (ElementKernel, Scatter, element_apply_plain,
                            make_scatter, make_segment_plan,
                            planned_segment_sum)

__all__ = ["TransportSystem", "build_transport_system", "system_to",
           "unpermute_columns", "robin_matrices_for_mu", "OperatorArgs",
           "operator_args", "apply_operator", "operator_rhs", "fine_dinv",
           "solve_sweep", "BAND_TILE"]

# rows per band tile; systems are padded to a multiple of it (and to
# nothing else)
BAND_TILE = 256
# the JAX package's mixed-solve settings: inner f32 Krylov steps per pass,
# f64 passes (CG, BiCGStab), inner residual reduction per pass, cheap
# passes after the first (CG only)
N_INNER = 300
MAX_PASSES = 10
MAX_PASSES_BICGSTAB = 12
INNER_RTOL = 1e-4
CHEAP_PASSES = 1


class _Block(NamedTuple):
    """One element block: f64 and f32 entity matrices + scatter and tile
    plans; on a CUDA device also kernel C bound to each precision (its
    fixed tensors checked once, where the block is made).  The matrices
    are (N, nd, nd), shared by the columns, or (B, N, nd, nd), one set per
    column (``per_sample``)."""
    A64: torch.Tensor
    A32: torch.Tensor
    dofs: torch.Tensor        # (N, nd) int32
    scatter: Scatter
    kernels: Optional[tuple] = None   # (f64, f32) ElementKernel on CUDA

    @classmethod
    def of(cls, A64, A32, dofs, scatter: Scatter):
        """The block of these tensors, with its kernels where they lie on
        a CUDA device."""
        kernels = None
        if A64.device.type == "cuda":
            kernels = (ElementKernel(A64, dofs, scatter),
                       ElementKernel(A32, dofs, scatter))
        return cls(A64, A32, dofs, scatter, kernels)

    @classmethod
    def build(cls, A64, dofs, ndofs: int):
        """From f64 entity matrices on their device and an (N, nd) numpy
        dof map in the system's numbering of ``ndofs`` rows."""
        dev = A64.device
        A64 = A64.contiguous()     # einsum outputs may be strided views
        return cls.of(A64, A64.float(),
                      torch.as_tensor(np.asarray(dofs), dtype=torch.int32,
                                      device=dev),
                      make_scatter(dofs, ndofs, dev))

    def per_sample(self, A_batch):
        """The block of per-sample matrices ``A_batch`` (B, N, nd, nd) f64
        (numpy or tensor) on this block's entities, dof map and plans."""
        A = torch.as_tensor(A_batch, dtype=torch.float64,
                            device=self.A64.device).contiguous()
        if A.dim() != 4 or tuple(A.shape[1:]) != tuple(self.A64.shape[-3:]):
            raise ValueError(f"per-sample matrices {tuple(A.shape)} do not "
                             f"fit a block of {tuple(self.A64.shape[-3:])}")
        return _Block.of(A, A.float(), self.dofs, self.scatter)

    @property
    def ndofs(self):
        return self.scatter.ndofs

    def apply_batched(self, X, coef=None, out=None):
        """(n, B) -> (n, B) in X's dtype, ``coef`` (B,) fused per column (a
        per-sample block takes none); with ``out``, adds that into ``out``
        in place and returns it (on the card only the rows the block
        touches are read and written)."""
        if X.device.type == "cpu":
            A = self.A64 if X.dtype == torch.float64 else self.A32
            return element_apply_plain(A, self.dofs, self.scatter, X, coef,
                                       out)
        if self.kernels is None:
            raise ValueError("kernel C needs every tensor on X's CUDA device")
        return self.kernels[X.dtype != torch.float64](X, coef, out)

    def diagonal(self):
        """(ndofs,) f64 diagonal of the assembled block; (ndofs, B) of a
        per-sample block."""
        return self.diagonal_batched(self.A64)

    def diagonal_batched(self, A):
        """Diagonal of the block assembled from other matrices on its dof
        map: (N, nd, nd) -> (ndofs,), per-sample (B, N, nd, nd) ->
        (ndofs, B); summed in entry order on every device."""
        de = torch.diagonal(A, dim1=-2, dim2=-1)
        de = (de.reshape(-1) if A.dim() == 3
              else de.reshape(A.shape[0], -1).t())
        # the rows of de are the (entity, i) entries of dofs: the scatter
        # plan's perm is their stable argsort by dof
        seg = make_segment_plan(self.scatter.ids_sorted, self.ndofs,
                                de.device, order=self.scatter.perm)
        return planned_segment_sum(de, seg)

    def to(self, device):
        return _Block.of(self.A64.to(device), self.A32.to(device),
                         self.dofs.to(device), self.scatter.to(device))


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
    Adv: Optional[_Block] = None           # advection (nonsymmetric)
    Advband: Optional[torch.Tensor] = None  # its band, on K's plan
    Kspans: Optional[torch.Tensor] = None   # band_spans of each band
    Advspans: Optional[torch.Tensor] = None


def _to(x, device):
    return None if x is None else x.to(device)


def system_to(sys: TransportSystem, device) -> TransportSystem:
    """The same system with every tensor on ``device``."""
    return sys._replace(
        K=sys.K.to(device), R=_to(sys.R, device), Adv=_to(sys.Adv, device),
        free=sys.free.to(device), bc_values=sys.bc_values.to(device),
        Kband=_to(sys.Kband, device), Advband=_to(sys.Advband, device),
        Kspans=_to(sys.Kspans, device), Advspans=_to(sys.Advspans, device))


def unpermute_columns(sys: TransportSystem, Xcols):
    """(B, ndofs) columns in system numbering -> (B, n_true) in the
    FunctionSpace's dof numbering."""
    n_true = sys.space.ndofs
    if sys.iperm is None:
        return Xcols[:, :n_true]
    idx = torch.as_tensor(sys.iperm[:n_true].astype(np.int64),
                          device=Xcols.device)
    return Xcols[:, idx]


def build_transport_system(mesh: MeshData, device, element="P2",
                           u_values=None, u_space=None, dirichlet=None,
                           with_robin=True) -> TransportSystem:
    """Assemble K (unit stiffness), Adv (advection by the velocity
    ``u_values`` on ``u_space``, when given) and R (unit Robin on the bottom
    wall, unless ``with_robin`` is False), the Dirichlet lift (``dirichlet``
    (marker, value) pairs; default c = 1 left, c = 0 right), pad to the
    band tile, reorder for the smallest bandwidth, and build the f32 bands
    of K and Adv on K's plan (Adv has K's dofs), each with its
    ``band_spans``.

    Padding dofs are constrained identity rows with zero right-hand side."""
    device = torch.device(device)
    space = FunctionSpace(mesh, element)
    bottom = mesh.bc_marker == MARKERS["bottom"]
    K_e, K_dofs = stiffness_block(space, device)
    if dirichlet is None:
        dirichlet = [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)]
    bc = make_bc(space, dirichlet)
    n_true = space.ndofs
    ndofs = -(-n_true // BAND_TILE) * BAND_TILE
    free = np.concatenate([bc.free, np.zeros(ndofs - n_true, dtype=bool)])
    bc_values = np.concatenate([bc.values, np.zeros(ndofs - n_true)])

    perm, iperm = best_bandwidth_permutation(
        K_dofs, np.asarray(space.dof_coords), n_true, ndofs)
    K_dofs = iperm[K_dofs]
    K = _Block.build(K_e, K_dofs, ndofs)
    plan = build_band_plan(K_dofs, ndofs, tile=BAND_TILE)
    Adv = Advband = Advspans = None
    if u_values is not None:
        Adv_e, _ = advection_block(space, u_values, u_space, device)
        Adv = _Block.build(Adv_e, K_dofs, ndofs)
        Advband = band_from_elements(Adv.A32, plan)
        Advspans = band_spans(Advband)
    Kband = band_from_elements(K.A32, plan)
    R = None
    if with_robin and bottom.any():
        R_e, R_dofs = robin_facet_block(space, bottom, device)
        R = _Block.build(R_e, iperm[R_dofs], ndofs)
    return TransportSystem(
        K=K, R=R,
        free=torch.as_tensor(free[perm], device=device),
        bc_values=torch.as_tensor(bc_values[perm], dtype=torch.float64,
                                  device=device),
        ndofs=ndofs, space=space, Kband=Kband, Kspans=band_spans(Kband),
        perm=perm, iperm=iperm, Adv=Adv, Advband=Advband, Advspans=Advspans)


def robin_matrices_for_mu(sys: TransportSystem, mu):
    """(F, nd, nd) f64 Robin facet matrices, on the system's device, of a
    spatially varying ``mu(x)`` callable on the bottom wall, facet for
    facet those of ``sys.R`` (nothing is padded)."""
    bottom = sys.space.mesh.bc_marker == MARKERS["bottom"]
    return robin_facet_block(sys.space, bottom, sys.free.device, mu=mu)[0]


# ---------------------------------------------------------------------------
# the operator A(D_b, mu_b) on (n, B) columns
# ---------------------------------------------------------------------------

class OperatorArgs(NamedTuple):
    """One precision's view of the sweep operator (``operator_args``)."""
    K: _Block
    Adv: Optional[_Block]
    R: Optional[_Block]
    Kband: Optional[torch.Tensor]   # the bands: f32 view only
    Advband: Optional[torch.Tensor]
    Kspans: Optional[torch.Tensor]  # and their spans
    Advspans: Optional[torch.Tensor]
    free: torch.Tensor
    D_vec: torch.Tensor             # (B,) in the view's dtype
    mu_vec: torch.Tensor
    R_batch: Optional[_Block] = None  # per-sample Robin (step-mu sweeps):
                                      #   applied in place of mu_vec * R


def operator_args(sys: TransportSystem, D_vec, mu_vec, f32: bool,
                  R_batch: Optional[_Block] = None):
    """``R_batch``: the per-sample Robin block of a step-mu sweep
    (``sys.R.per_sample``), applied in place of ``mu_vec * sys.R``."""
    dt = torch.float32 if f32 else torch.float64
    dev = sys.free.device
    return OperatorArgs(
        K=sys.K, Adv=sys.Adv, R=sys.R, R_batch=R_batch,
        Kband=sys.Kband if f32 else None,
        Advband=sys.Advband if f32 else None,
        Kspans=sys.Kspans if f32 else None,
        Advspans=sys.Advspans if f32 else None, free=sys.free,
        D_vec=torch.as_tensor(D_vec, device=dev).to(dt),
        mu_vec=torch.as_tensor(mu_vec, device=dev).to(dt))


def _apply_raw(a: OperatorArgs, X):
    # summation order K, Adv, R as in the JAX programs; R adds into Y's
    # boundary rows in place (Y is this function's own)
    if a.Kband is not None:
        Y = band_apply(a.Kband, X, coef=a.D_vec, spans=a.Kspans)
    else:
        Y = a.K.apply_batched(X, coef=a.D_vec)
    if a.Adv is not None:
        Y = Y + (band_apply(a.Advband, X, spans=a.Advspans)
                 if a.Advband is not None else a.Adv.apply_batched(X))
    if a.R_batch is not None:
        Y = a.R_batch.apply_batched(X, out=Y)
    elif a.R is not None:
        Y = a.R.apply_batched(X, coef=a.mu_vec, out=Y)
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


def fine_dinv(sys: TransportSystem, D_vec, mu_vec, robin_matrices=None):
    """(n, B) f32 inverse diagonal of A(D_b, mu_b); 1 on constrained rows.
    ``robin_matrices``: per-sample Robin matrices (B, F, nd, nd) f64 on
    sys.R's facets, in place of mu_b * R."""
    dev = sys.free.device
    D = torch.as_tensor(D_vec, dtype=torch.float64, device=dev)
    mu = torch.as_tensor(mu_vec, dtype=torch.float64, device=dev)
    d = D[None, :] * sys.K.diagonal()[:, None]
    if sys.Adv is not None:
        d = d + sys.Adv.diagonal()[:, None]
    if sys.R is not None:
        if robin_matrices is None:
            d = d + mu[None, :] * sys.R.diagonal()[:, None]
        else:
            d = d + sys.R.diagonal_batched(torch.as_tensor(
                robin_matrices, dtype=torch.float64, device=dev))
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


def _bicgstab_solve(a64, a32, M, RHS, X0, tol):
    """The JAX per-pass ``_refine_program_bicgstab`` loop: up to
    MAX_PASSES_BICGSTAB true f64 passes (at least one), each an f32
    preconditioned BiCGStab with per-column ``active`` masks, started from
    the Dirichlet lift X0 (so the opening residual is where(free, RHS, 0),
    and each pass's closing residual opens the next: the same f64 values
    the JAX program recomputes).

    Returns (X, rn (B,) true f64 residual norms, iters (B,), passes)."""
    B = RHS.shape[1]

    def inner(R64):
        rn0 = _colnorm(R64)
        R = R64.float()
        tol_in = torch.maximum(INNER_RTOL * rn0, 0.1 * tol).float()
        Rhat = R
        rho = alpha = omega = torch.ones(B, dtype=R.dtype, device=R.device)
        Dx = torch.zeros_like(R)
        P = torch.zeros_like(R)
        V = torch.zeros_like(R)
        cit = torch.zeros(B, dtype=torch.int64, device=R.device)
        for _ in range(N_INNER):
            active = _colnorm(R) > tol_in
            if not bool(active.any()):
                break
            # the breakdown guards of the JAX body, term for term
            rho_new = torch.sum(Rhat * R, dim=0)
            beta = torch.where(
                active,
                (rho_new / torch.where(rho != 0, rho, 1.0))
                * (alpha / torch.where(omega != 0, omega, 1.0)), 0.0)
            P = torch.where(active, R + beta * (P - omega * V), P)
            Phat = M(P)
            V = apply_operator(a32, Phat)
            denom = torch.sum(Rhat * V, dim=0)
            alpha = torch.where(active & (denom != 0),
                                rho_new / torch.where(denom != 0, denom, 1.0),
                                0.0)
            S = R - alpha * V
            Shat = M(S)
            T = apply_operator(a32, Shat)
            tt = torch.sum(T * T, dim=0)
            omega = torch.where(active & (tt != 0),
                                torch.sum(T * S, dim=0)
                                / torch.where(tt != 0, tt, 1.0), 0.0)
            Dx = Dx + alpha * Phat + omega * Shat
            R = torch.where(active, S - omega * T, R)
            rho = rho_new
            cit = cit + active
        return Dx, cit

    X = X0
    R64 = torch.where(a64.free[:, None], RHS, 0.0)
    tot = torch.zeros(B, dtype=torch.int64, device=RHS.device)
    for k in range(1, MAX_PASSES_BICGSTAB + 1):
        Dx, cit = inner(R64)
        X = X + Dx.double()
        R64 = RHS - apply_operator(a64, X)
        rn = _colnorm(R64)
        tot = tot + cit
        if not bool((rn > tol).any()):
            break
    return X, rn, tot, k


def solve_sweep(sys: TransportSystem, D_values, mu_values=None, rtol=1e-12,
                multilevel=None, robin_matrices=None):
    """Batched mixed-precision transport solve over sweep points: CG
    without advection, BiCGStab with it.

    D_values, mu_values: (B,).  robin_matrices: (B, F, nd, nd) f64
    per-sample Robin matrices on sys.R's facets (``robin_matrices_for_mu``
    stacked), in place of mu_values; where the hierarchy's fine level was
    built from this very tensor, its block is used and none is bound anew.
    multilevel: a ``solvers.multilevel`` hierarchy (hybrid cycle for CG,
    multiplicative V(1,1) for BiCGStab, the cycles the JAX package runs on
    a TPU); None preconditions with Jacobi.
    Returns (X (B, n_true) f64 in FunctionSpace numbering, info) with info
    keys iters (B,), resnorm (B,), rel_resnorm (B,), passes."""
    dev = sys.free.device
    D_vec = torch.as_tensor(np.asarray(D_values, dtype=np.float64),
                            device=dev)
    B = int(D_vec.shape[0])
    mu_vec = torch.as_tensor(
        np.zeros(B) if mu_values is None
        else np.asarray(mu_values, dtype=np.float64), device=dev)
    nonsym = sys.Adv is not None
    Rb = None
    if robin_matrices is not None:
        Rb = None if multilevel is None else multilevel.levels[0].R_batch
        if Rb is None or Rb.A64 is not robin_matrices:
            Rb = sys.R.per_sample(robin_matrices)
        if Rb.A64.shape[0] != B:
            raise ValueError(f"{Rb.A64.shape[0]} Robin matrix sets for {B} "
                             "columns")
    a64 = operator_args(sys, D_vec, mu_vec, f32=False, R_batch=Rb)
    a32 = operator_args(sys, D_vec, mu_vec, f32=True, R_batch=Rb)
    G = sys.bc_values[:, None].expand(-1, B).contiguous()
    RHS = operator_rhs(a64, G)
    if multilevel is not None:
        from ..solvers.multilevel import make_ml_preconditioner
        M = make_ml_preconditioner(multilevel,
                                   cycle="mult" if nonsym else "hybrid")
    else:
        dinv = fine_dinv(sys, D_vec, mu_vec,
                         None if Rb is None else Rb.A64)

        def M(R):
            return dinv * R
    bnorm = _colnorm(RHS)
    solve = _bicgstab_solve if nonsym else _mixed_solve
    X, rn, tot, passes = solve(a64, a32, M, RHS, G, rtol * bnorm)
    bn = bnorm.cpu().numpy()
    resnorm = rn.cpu().numpy()
    info = {"iters": tot.cpu().numpy(), "resnorm": resnorm,
            "rel_resnorm": resnorm / np.where(bn > 0, bn, 1.0),
            "passes": int(passes)}
    return unpermute_columns(sys, X.t()), info
