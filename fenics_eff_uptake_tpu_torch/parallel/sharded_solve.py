"""Sharded sweep and Stokes solves: DP over "sweep" x TP over "cells" on
``torch.distributed`` (counterpart of ``parallel/sharded_solve.py``).

The solver stack of the JAX package's sharded path, rank by rank:

  "sweep" (DP): the (n, B) Krylov state is split by columns; every vector
      operation and reduction is column-local, no collective.
  "cells" (TP): each rank holds a contiguous chunk of ceil(N / tp) elements
      of every fine block (padded with zero matrices at a dummy dof),
      bound to kernel C with the full number of output rows; an operator
      apply is the chunk's apply followed by ONE all-reduce over "cells".

The multigrid cycle under the partition (the JAX ``M_apply``): a fine
pre-smooth and post-smooth through the sharded operator, restriction and
prolongation by the levels' gather transfers, and the mid and coarse levels
replicated on every rank as element blocks (kernel C in f64), their per-
column arrays (inverse diagonals, per-sample Robin matrices, coarsest
inverses) split over "sweep".  As in JAX, the coarsest product is rounded
to f32 before its prolongation.  Per iteration that is 3 all-reduces for
CG and 6 for BiCGStab under the cycle, 1 and 2 under Jacobi.

The host protocol is JAX's: chunks of ``chunk_iters`` iterations, one
host read of the (B,) residual norms per chunk, per-column freezing by the
``active`` masks, iterations counted in whole chunks.  The right-hand side
and the inverse diagonal come from the sharded operator (one all-reduce
each).  At the end the columns are gathered over "sweep" (one all-reduce
of a zero-padded buffer) and every rank holds X in FunctionSpace
numbering.

Stokes: the saddle MINRES with the velocity stiffness and the divergence
block split over "cells" and ONE fused all-reduce per saddle apply (A U,
B^T p and B u in one buffer); the velocity V-cycle's mid and coarse levels
and the Schur-deflation basis replicated; 3 all-reduces per iteration.

The functions that run in a rank take the ("sweep", "cells") DeviceMesh
(``sharding.make_device_mesh``); the parent's calls, ``solve_sweep_sharded``
and ``stokes_solve_sharded``, send host copies of the systems the caller
built to a ``sharding.RankGroup`` and return rank 0's result.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.stokes_flow import _Divergence, _sync
from ..ops.elemspmv import make_segment_plan, planned_segment_sum
from ..solvers.minres import minres_tree
from ..solvers.multilevel import gather_transfer
from .sharding import all_reduce_sum, kernel_launches
from .sweep import _Block, system_to

__all__ = ["ShardedSystem", "build_sharded_system", "sharded_solve_sweep",
           "ShardedStokes", "StokesHost", "stokes_host",
           "build_sharded_stokes", "sharded_stokes_solve",
           "solve_sweep_sharded", "stokes_solve_sharded",
           "host_system", "host_hierarchy", "fine_element_bytes"]


class _Layout(NamedTuple):
    """Where this rank sits in the ("sweep", "cells") mesh."""
    device: torch.device
    dp: int
    tp: int
    sweep_index: int
    cells_index: int
    sweep: object             # process groups of the two mesh dimensions
    cells: object

    def columns(self, B: int) -> slice:
        """This rank's columns of a batch of B (a multiple of dp)."""
        if B % self.dp:
            raise ValueError(f"sweep batch {B} must divide over dp="
                             f"{self.dp}")
        b = B // self.dp
        return slice(self.sweep_index * b, (self.sweep_index + 1) * b)


def _mesh_layout(device_mesh) -> _Layout:
    if device_mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    si, ci = device_mesh.get_coordinate()
    return _Layout(dev, device_mesh.size(0), device_mesh.size(1), int(si),
                   int(ci), device_mesh.get_group("sweep"),
                   device_mesh.get_group("cells"))


def _chunk(N: int, lay: _Layout):
    """(first, end, length) of this rank's element chunk of N."""
    n_loc = -(-N // lay.tp)
    lo = lay.cells_index * n_loc
    return lo, lo + n_loc, n_loc


def _split_block(block: _Block, lay: _Layout, ndofs: int,
                 dummy_dof=None) -> _Block:
    """This rank's contiguous chunk of ``block``'s elements, padded to
    ceil(N / tp) with zero matrices at ``dummy_dof`` (default the last
    dof), bound on the rank's device with its own plans into the full
    ``ndofs`` rows (rows the chunk never touches come out zero)."""
    A, dofs = block.A64.cpu(), block.dofs.cpu().numpy()
    N, nd = dofs.shape
    lo, hi, n_loc = _chunk(N, lay)
    A, dofs = A[lo:hi], dofs[lo:hi]
    pad = n_loc - A.shape[0]
    if pad:
        A = torch.cat([A, A.new_zeros((pad, nd, nd))])
        dofs = np.concatenate([dofs, np.full(
            (pad, nd), ndofs - 1 if dummy_dof is None else dummy_dof,
            dofs.dtype)])
    return _Block.build(A.to(lay.device), dofs, ndofs)


def _split_batch_matrices(R_batch, lay: _Layout, cols: slice):
    """This rank's columns and element chunk of per-sample matrices
    (B, N, nd, nd), padded as ``_split_block`` pads the block they sit
    on, on the rank's device."""
    Rb = torch.as_tensor(R_batch, dtype=torch.float64).cpu()[cols]
    lo, hi, n_loc = _chunk(Rb.shape[1], lay)
    Rb = Rb[:, lo:hi]
    pad = n_loc - Rb.shape[1]
    if pad:
        Rb = torch.cat([Rb, Rb.new_zeros((Rb.shape[0], pad)
                                         + tuple(Rb.shape[2:]))], dim=1)
    return Rb.to(lay.device)


def _apply(block: _Block, X, coef=None, out=None):
    """``block.apply_batched``, counted in ``_apply.calls``: on a card
    every call must be one launch of kernel C (``_check_kernels``)."""
    _apply.calls += 1
    return block.apply_batched(X, coef=coef, out=out)


_apply.calls = 0


def _check_kernels(lay: _Layout, applies0: int, launches0: int):
    """On a card, raise unless every block apply since ``applies0`` was a
    launch of kernel C (never its plain version)."""
    if lay.device.type != "cuda":
        return
    applies = _apply.calls - applies0
    launches = kernel_launches()["element_apply"] - launches0
    if applies <= 0 or launches != applies:
        raise RuntimeError(f"kernel C launched {launches} times for "
                           f"{applies} block applies on {lay.device}")


def _block_bytes(b: Optional[_Block]) -> int:
    """Device bytes of one block: its matrices, dof map, scatter and tile
    plans, and the sorted copies its bound kernels hold."""
    if b is None:
        return 0
    ts = [b.A64, b.A32, b.dofs, *b.scatter[:3], *b.scatter.tiles[:6]]
    ts += [k.A_sorted for k in (b.kernels or {}).values()]
    return int(sum(t.numel() * t.element_size() for t in ts))


def fine_element_bytes(sys) -> int:
    """Bytes of the fine element arrays (K, Adv, R and a per-sample Robin
    block) of a system or of one rank's ``ShardedSystem``."""
    return sum(_block_bytes(getattr(sys, k, None))
               for k in ("K", "Adv", "R", "Rb"))


# ---------------------------------------------------------------------------
# host copies: what the parent sends to the ranks
# ---------------------------------------------------------------------------

def host_system(sys, elements_only=False):
    """A TransportSystem as the ranks receive it: on the CPU, without its
    bands (the sharded operator is element-partitioned) and without its
    space (the ranks take its number of dofs as ``n_true``).
    ``elements_only``: its blocks carry only their f64 matrices and dof
    maps, all that ``_split_block`` reads (a fine system, whose chunks the
    ranks plan anew)."""
    s = sys._replace(Kband=None, Advband=None, Kspans=None, Advspans=None,
                     space=None)
    if not elements_only:
        return system_to(s, "cpu")

    def elements(b):
        return None if b is None else _Block(b.A64.cpu(), None,
                                             b.dofs.cpu(), None)
    return s._replace(K=elements(s.K), Adv=elements(s.Adv),
                      R=elements(s.R), free=s.free.cpu(),
                      bc_values=s.bc_values.cpu())


def host_hierarchy(ml):
    """A MultilevelData as the ranks receive it: on the CPU, without
    transfer bands (the sharded cycle transfers by gather), the fine
    level's system (the sharded operator takes its place) and the copies
    in other dtypes."""
    levels = []
    for l, la in enumerate(ml.levels):
        sys = None if l == 0 else host_system(la.sys)
        levels.append(la._replace(
            sys=sys, dinv=la.dinv.cpu(), free=la.free.cpu(), bands=None,
            R_batch=None if l == 0 or la.R_batch is None
            else la.R_batch.to("cpu")))
    return ml._replace(levels=tuple(levels), Ainv=ml.Ainv.cpu(),
                       free_c=ml.free_c.cpu(), D_vec=ml.D_vec.cpu(),
                       mu_vec=ml.mu_vec.cpu(), A_c=None, info=None,
                       lowp=None)


# ---------------------------------------------------------------------------
# the sharded transport system and its V-cycle
# ---------------------------------------------------------------------------

class _RankLevel(NamedTuple):
    sys: object               # the level's TransportSystem on the device
                              #   (None at the fine level)
    R_batch: Optional[_Block]  # per-sample Robin of the rank's columns
    dinv: torch.Tensor        # (n_l, B_rank) or (n_l, 1)
    free: torch.Tensor
    gather: tuple             # gather_transfer of the level's transfer


class _RankHierarchy(NamedTuple):
    """One rank's view of a hierarchy: its columns of the per-column
    arrays, every level below the fine one replicated on its device."""
    levels: tuple
    Ainv: torch.Tensor        # (B_rank or 1, nc, nc) f32
    free_c: torch.Tensor
    omega: float
    D_vec: torch.Tensor       # (B_rank,) f64
    mu_vec: torch.Tensor


def _rank_hierarchy(ml, lay: _Layout, replicated=False) -> _RankHierarchy:
    """``replicated``: every column on every rank (the Stokes velocity
    block, whose two columns are one vector), else the rank's columns."""
    dev = lay.device
    cols = (slice(None) if replicated
            else lay.columns(int(ml.D_vec.numel())))

    def per_column(t):
        return (t if t.shape[-1] == 1 else t[:, cols]).to(dev)

    levels = []
    for l, la in enumerate(ml.levels):
        sys = rb = None
        if l:
            sys = system_to(la.sys, dev)
            if la.R_batch is not None:
                rb = sys.R.per_sample(la.R_batch.A64[cols])
        levels.append(_RankLevel(sys, rb, per_column(la.dinv),
                                 la.free.to(dev),
                                 gather_transfer(la.transfer, dev)))
    Ainv = ml.Ainv if ml.Ainv.shape[0] == 1 else ml.Ainv[cols]
    return _RankHierarchy(tuple(levels), Ainv.to(dev), ml.free_c.to(dev),
                          float(ml.omega), ml.D_vec[cols].to(dev),
                          ml.mu_vec[cols].to(dev))


class ShardedSystem(NamedTuple):
    layout: _Layout
    K: _Block                 # this rank's element chunks, full rows
    Adv: Optional[_Block]
    R: Optional[_Block]
    Rb: Optional[_Block]      # per-sample Robin chunk of the rank's columns
    batch: Optional[int]      # the batch the per-sample matrices fix
    ml: Optional[_RankHierarchy]
    free: torch.Tensor        # (ndofs,) replicated
    bc_values: torch.Tensor
    ndofs: int
    n_true: int
    iperm: Optional[np.ndarray]


def build_sharded_system(sys, device_mesh, multilevel=None,
                         robin_batch=None, n_true=None) -> ShardedSystem:
    """Partition a TransportSystem (and its hierarchy) over the mesh, in a
    rank: its K, Adv and R element chunks on the rank's device, the
    hierarchy's levels below the fine one replicated.  ``robin_batch``
    (B, F, nd, nd): per-sample Robin matrices on sys.R's facets (the
    step-mu surrogates), in place of mu * R.  ``n_true``: the dofs of the
    system's space where ``sys.space`` is not carried (``host_system``)."""
    lay = _mesh_layout(device_mesh)
    n = sys.ndofs
    split = [None if b is None else _split_block(b, lay, n)
             for b in (sys.K, sys.Adv, sys.R)]
    Rb = batch = None
    if robin_batch is not None:
        if sys.R is None:
            raise ValueError("robin_batch needs sys.R (the unit-mu Robin "
                             "block) for its scatter plan")
        batch = int(robin_batch.shape[0])
        Rb = split[2].per_sample(_split_batch_matrices(
            robin_batch, lay, lay.columns(batch)))
    return ShardedSystem(
        layout=lay, K=split[0], Adv=split[1], R=split[2], Rb=Rb, batch=batch,
        ml=None if multilevel is None else _rank_hierarchy(multilevel, lay),
        free=sys.free.to(lay.device), bc_values=sys.bc_values.to(lay.device),
        ndofs=n, n_true=int(sys.space.ndofs if n_true is None else n_true),
        iperm=sys.iperm)


def _operator(ss: ShardedSystem, D, mu, dt):
    """(A_raw, A_bc) of the rank's columns in ``dt``: A_raw = the chunk's
    K D + Adv + R (mu or per sample) summed over "cells" (one all-reduce);
    A_bc the constrained operator (identity on constrained rows)."""
    lay = ss.layout
    free = ss.free[:, None]

    def A_raw(X):
        Y = _apply(ss.K, X, coef=D)
        if ss.Adv is not None:
            Y = Y + _apply(ss.Adv, X)
        if ss.Rb is not None:
            Y = _apply(ss.Rb, X, out=Y)
        elif ss.R is not None:
            Y = _apply(ss.R, X, coef=mu, out=Y)
        return all_reduce_sum(Y, lay.cells)

    def A_bc(X):
        return torch.where(free, A_raw(torch.where(free, X, 0.0)), X)
    return A_raw, A_bc


def _cycle(hv: _RankHierarchy, A_bc, dt):
    """The V-cycle under the partition (JAX ``M_apply``): fine pre- and
    post-smooth through the sharded ``A_bc``, gather transfers, mid
    levels and the coarsest inverses replicated, in ``dt``."""
    levels = hv.levels
    n_mid = len(levels)
    omega = torch.as_tensor(hv.omega, dtype=dt, device=hv.D_vec.device)
    D, mu = hv.D_vec.to(dt), hv.mu_vec.to(dt)
    dinvs = [la.dinv.to(dt) for la in levels]
    gathers = [(cols, w.to(dt), plan) for cols, w, plan in
               (la.gather for la in levels)]
    Ainv = hv.Ainv

    def A_l(l, X):
        la = levels[l]
        s = la.sys
        free = la.free[:, None]
        X = torch.where(free, X, 0.0)
        Y = _apply(s.K, X, coef=D)
        if s.Adv is not None:
            Y = Y + _apply(s.Adv, X)
        if la.R_batch is not None:
            Y = _apply(la.R_batch, X, out=Y)
        elif s.R is not None:
            Y = _apply(s.R, X, coef=mu, out=Y)
        return torch.where(free, Y, X)

    def restrict(l, r):
        _, w, plan = gathers[l]
        return planned_segment_sum(
            (w[:, :, None] * r[:, None, :]).reshape(-1, r.shape[1]), plan)

    def prolong(l, xc):
        cols, w, _ = gathers[l]
        wd = torch.promote_types(w.dtype, xc.dtype)
        return torch.einsum("nk,nkb->nb", w.to(wd),
                            xc.to(wd)[cols]).to(xc.dtype)

    def coarse(rc):
        # JAX's preferred_element_type=f32: the product rounded to f32
        rc = torch.where(hv.free_c[:, None], rc, 0.0)
        wd = torch.promote_types(Ainv.dtype, rc.dtype)
        xc = torch.matmul(Ainv.to(wd), rc.to(wd).t().unsqueeze(-1))
        return xc.squeeze(-1).t().float()

    def below(l, rc):
        """The correction of level l's restricted residual rc."""
        if l < n_mid:
            return vcycle(l, torch.where(levels[l].free[:, None], rc, 0.0))
        return coarse(rc)

    def vcycle(l, r):
        x = omega * dinvs[l] * r
        xc = below(l + 1, restrict(l, r - A_l(l, x)))
        x = x + prolong(l, xc)
        return x + omega * dinvs[l] * (r - A_l(l, x))

    def M(R):
        Rw = R.to(dt)
        x = omega * dinvs[0] * Rw
        xc = below(1, restrict(0, Rw - A_bc(x)))
        x = x + prolong(0, xc)
        x = x + omega * dinvs[0] * (Rw - A_bc(x))
        return x.to(R.dtype)
    return M


def _colnorm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _gather_columns(X, cols: slice, B: int, lay: _Layout):
    """(n, B) on every rank from each sweep rank's (n, B / dp) columns:
    one all-reduce over "sweep" of a zero-padded buffer."""
    full = X.new_zeros((X.shape[0], B))
    full[:, cols] = X
    return all_reduce_sum(full, lay.sweep)


def _cg_chunk(A_bc, M, n_iters, state, tol):
    """``n_iters`` masked CG iterations (the JAX chunk body)."""
    X, R, Z, P, rz = state
    for _ in range(n_iters):
        active = _colnorm(R) > tol
        AP = A_bc(P)
        pAp = torch.sum(P * AP, dim=0)
        alpha = torch.where(active & (pAp != 0),
                            rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = M(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(active & (rz != 0),
                           rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        P = torch.where(active, Z + beta * P, P)
        rz = rz_new
    return X, R, Z, P, rz


def _bicgstab_chunk(A_bc, M, n_iters, state, Rhat, tol):
    """``n_iters`` masked BiCGStab iterations (the JAX chunk body)."""
    X, R, P, V, rho, alpha, omega = state
    for _ in range(n_iters):
        active = _colnorm(R) > tol
        rho_new = torch.sum(Rhat * R, dim=0)
        beta = torch.where(
            active, (rho_new / torch.where(rho != 0, rho, 1.0))
            * (alpha / torch.where(omega != 0, omega, 1.0)), 0.0)
        P = torch.where(active, R + beta * (P - omega * V), P)
        Phat = M(P)
        V = A_bc(Phat)
        denom = torch.sum(Rhat * V, dim=0)
        alpha = torch.where(active & (denom != 0),
                            rho_new / torch.where(denom != 0, denom, 1.0),
                            0.0)
        S = R - alpha * V
        Shat = M(S)
        T = A_bc(Shat)
        tt = torch.sum(T * T, dim=0)
        omega = torch.where(active & (tt != 0), torch.sum(T * S, dim=0)
                            / torch.where(tt != 0, tt, 1.0), 0.0)
        X = X + alpha * Phat + omega * Shat
        R = torch.where(active, S - omega * T, R)
        rho = rho_new
    return X, R, P, V, rho, alpha, omega


def sharded_solve_sweep(ss: ShardedSystem, D_values, mu_values,
                        rtol=1e-10, maxiter=5000, chunk_iters=50,
                        f32=False):
    """Chunked CG (BiCGStab with advection), multigrid-preconditioned when
    the system carries a hierarchy, else Jacobi, over the mesh; runs in
    every rank.  D_values, mu_values: (B,) of the whole batch (B a
    multiple of dp; mu ignored with per-sample Robin matrices).

    Returns (X (B, n_true) f64 in FunctionSpace numbering on every rank,
    info) with info iters (B,) (in whole chunks), resnorm and rel_resnorm
    (the recurrence's, JAX's stopping quantity), true_rel_resnorm (the f64
    residual of X), converged (the recurrence met rtol and X is finite),
    all_reduces_per_iter (the collectives of the iteration loop per
    dispatched iteration) and chunks."""
    lay = ss.layout
    dev = lay.device
    dt = torch.float32 if f32 else torch.float64
    D_all = np.asarray(D_values, dtype=np.float64)
    B = int(D_all.size)
    cols = lay.columns(B)
    if ss.batch is not None and ss.batch != B:
        raise ValueError(f"{ss.batch} Robin matrix sets for {B} columns")
    D64 = torch.as_tensor(D_all[cols], device=dev)
    mu64 = torch.as_tensor(np.asarray(mu_values, np.float64)[cols],
                           device=dev)
    applies0 = _apply.calls
    launches0 = kernel_launches()["element_apply"]
    t0 = _sync(dev)
    A_raw, A_bc = _operator(ss, D64.to(dt), mu64.to(dt), dt)
    free = ss.free[:, None]
    Bl = D64.numel()
    G64 = ss.bc_values[:, None].expand(-1, Bl).contiguous()
    G = G64.to(dt)
    RHS = torch.where(free, -A_raw(G), G)
    if ss.ml is not None:
        M = _cycle(ss.ml, A_bc, dt)
    else:
        # the inverse diagonal of the chunks' sum: one all-reduce
        d = D64 * ss.K.diagonal()[:, None]
        if ss.Adv is not None:
            d = d + ss.Adv.diagonal()[:, None]
        if ss.Rb is not None:
            d = d + ss.Rb.diagonal()
        elif ss.R is not None:
            d = d + mu64 * ss.R.diagonal()[:, None]
        d = all_reduce_sum(d.contiguous(), lay.cells)
        dinv = torch.where(free & (d != 0),
                           1.0 / torch.where(d != 0, d, 1.0), 1.0).to(dt)

        def M(R):
            return dinv * R
    X = G
    R = RHS - A_bc(X)
    bnorm = _colnorm(RHS).cpu().numpy()
    tol_np = rtol * bnorm
    tol = torch.as_tensor(tol_np, dtype=dt, device=dev)
    rn = _colnorm(R).cpu().numpy()
    col_iters = np.zeros(Bl, dtype=np.int64)
    iters = chunks = 0
    chunk_s = []
    t_chunk = t_loop = _sync(dev)
    if ss.Adv is not None:
        calls0 = all_reduce_sum.calls
        ones = torch.ones(Bl, dtype=dt, device=dev)
        state, Rhat = (X, R, torch.zeros_like(R), torch.zeros_like(R),
                       ones, ones, ones), R
        while iters < maxiter and (rn > tol_np).any():
            active = rn > tol_np
            state = _bicgstab_chunk(A_bc, M, chunk_iters, state, Rhat, tol)
            iters, chunks = iters + chunk_iters, chunks + 1
            rn = _colnorm(state[1]).cpu().numpy()
            col_iters[active] = iters
            chunk_s.append(time.time() - t_chunk)
            t_chunk = time.time()
    else:
        Z = M(R)
        calls0 = all_reduce_sum.calls
        state = (X, R, Z, Z, torch.sum(R * Z, dim=0))
        while iters < maxiter and (rn > tol_np).any():
            active = rn > tol_np
            state = _cg_chunk(A_bc, M, chunk_iters, state, tol)
            iters, chunks = iters + chunk_iters, chunks + 1
            rn = _colnorm(state[1]).cpu().numpy()
            col_iters[active] = iters
            chunk_s.append(time.time() - t_chunk)
            t_chunk = time.time()
    per_iter = (all_reduce_sum.calls - calls0) / max(iters, 1)
    t_end = _sync(dev)
    X = state[0].double()
    if f32:        # the certificate is an f64 residual
        A_raw, A_bc = _operator(ss, D64, mu64, torch.float64)
        RHS = torch.where(free, -A_raw(G64), G64)
    true = _colnorm(RHS - A_bc(X))
    bn = np.where(bnorm > 0, bnorm, 1.0)
    rows = torch.as_tensor(np.stack([col_iters, rn, rn / bn]),
                           dtype=torch.float64, device=dev)
    rows = torch.cat([rows, (true / torch.as_tensor(bn, device=dev))[None]])
    t_true = _sync(dev)
    out = _gather_columns(torch.cat([X, rows]), cols, B, lay)
    t_gather = _sync(dev)
    _check_kernels(lay, applies0, launches0)
    Xf, rows = out[:ss.ndofs], out[ss.ndofs:].cpu().numpy()
    if ss.iperm is not None:
        Xf = Xf[torch.as_tensor(ss.iperm[:ss.n_true].astype(np.int64),
                                device=dev)]
    else:
        Xf = Xf[:ss.n_true]
    rel = rows[2]
    info = {"iters": rows[0].astype(np.int64), "resnorm": rows[1],
            "rel_resnorm": rel, "true_rel_resnorm": rows[3],
            "converged": (rel <= rtol) & np.isfinite(rows[3]),
            "all_reduces_per_iter": per_iter, "chunks": chunks,
            "chunk_s": chunk_s,
            "stage_s": {"start": t_loop - t0, "loop": t_end - t_loop,
                        "residual": t_true - t_end,
                        "gather": t_gather - t_true}}
    return Xf.t().contiguous(), info


# ---------------------------------------------------------------------------
# sharded Stokes: block-preconditioned MINRES on the saddle system
# ---------------------------------------------------------------------------

class StokesHost(NamedTuple):
    """What the ranks receive of a ``stokes_setup``: host copies of the
    velocity system (without bands), the divergence block, the velocity
    hierarchy and the pressure preconditioner's parts."""
    sysV: object
    n_true: int               # velocity scalar dofs of the space
    B_e: torch.Tensor         # (NB, np_e, 2 nd) f64
    rdofs: torch.Tensor
    cdofs: torch.Tensor
    np_: int
    free_p: torch.Tensor
    mp_inv: torch.Tensor
    Z: torch.Tensor
    Cinv: torch.Tensor
    b: tuple
    G: torch.Tensor
    ml: object


def stokes_host(st) -> StokesHost:
    """The host copy of a ``models.stokes_flow.StokesSetup`` for the
    ranks."""
    return StokesHost(
        sysV=host_system(st.sysV, elements_only=True),
        n_true=int(st.sysV.space.ndofs),
        B_e=st.div.B64.cpu(),
        rdofs=st.div.rdofs.cpu(), cdofs=st.div.cdofs.cpu(),
        np_=int(st.Q.ndofs), free_p=st.free_p.cpu(), mp_inv=st.mp_inv.cpu(),
        Z=st.Z.cpu(), Cinv=st.Cinv.cpu(), b=tuple(t.cpu() for t in st.b),
        G=st.G.cpu(), ml=host_hierarchy(st.ml))


class ShardedStokes(NamedTuple):
    layout: _Layout
    K: _Block                 # this rank's velocity stiffness chunk (B = 2)
    div: _Divergence          # this rank's divergence chunk
    ml: _RankHierarchy        # the velocity hierarchy, replicated
    free: torch.Tensor        # (ns,)
    free_p: torch.Tensor
    mp_inv: torch.Tensor
    Z: torch.Tensor
    Cinv: torch.Tensor
    b: tuple
    G: torch.Tensor
    ns: int
    np_: int
    n_true: int
    iperm: Optional[np.ndarray]


def _split_divergence(host: StokesHost, lay: _Layout) -> _Divergence:
    """This rank's chunk of the divergence block, padded with zero
    matrices at the last pressure dof and the last velocity slot, with
    its segment plans into the full pressure and velocity rows."""
    ns2 = 2 * host.sysV.ndofs
    Be, rd, cd = host.B_e, host.rdofs, host.cdofs
    NB, nr, nc = Be.shape
    lo, hi, n_loc = _chunk(NB, lay)
    Be, rd, cd = Be[lo:hi], rd[lo:hi], cd[lo:hi]
    pad = n_loc - Be.shape[0]
    if pad:
        Be = torch.cat([Be, Be.new_zeros((pad, nr, nc))])
        rd = torch.cat([rd, rd.new_full((pad, nr), host.np_ - 1)])
        cd = torch.cat([cd, cd.new_full((pad, nc), ns2 - 1)])
    dev = lay.device
    Be, rd, cd = Be.to(dev), rd.to(dev), cd.to(dev)
    return _Divergence(B64=Be, B32=Be.float(), rdofs=rd, cdofs=cd,
                       rplan=make_segment_plan(rd, host.np_, dev),
                       cplan=make_segment_plan(cd, ns2, dev))


def build_sharded_stokes(host: StokesHost, device_mesh) -> ShardedStokes:
    """Partition the saddle system over the mesh's "cells", in a rank: the
    velocity stiffness and the divergence block split (the two blocks
    that carry the work), everything else replicated, f64 throughout."""
    lay = _mesh_layout(device_mesh)
    dev = lay.device
    sysV = host.sysV
    return ShardedStokes(
        layout=lay, K=_split_block(sysV.K, lay, sysV.ndofs),
        div=_split_divergence(host, lay),
        ml=_rank_hierarchy(host.ml, lay, replicated=True),
        free=sysV.free.to(dev),
        free_p=host.free_p.to(dev), mp_inv=host.mp_inv.to(dev),
        Z=host.Z.to(dev), Cinv=host.Cinv.to(dev),
        b=tuple(t.to(dev) for t in host.b), G=host.G.to(dev),
        ns=sysV.ndofs, np_=host.np_, n_true=host.n_true, iperm=sysV.iperm)


def _stokes_ops(sst: ShardedStokes):
    """(S, M, counts): the saddle apply with ONE fused all-reduce over
    "cells", and the block preconditioner diag(sharded V-cycle, lumped Mp
    + Z Cinv Z^T); counts["S"] counts the saddle applies."""
    lay = sst.layout
    ns, np_ = sst.ns, sst.np_
    free = sst.free[:, None]
    free_p = sst.free_p
    counts = {"S": 0}

    def S(x):
        U, p = x
        Um = torch.where(free, U, 0.0)
        pm = torch.where(free_p, p, 0.0)
        buf = torch.cat([_apply(sst.K, Um).reshape(-1),
                         sst.div.apply_t(pm), sst.div.apply(Um)])
        all_reduce_sum(buf, lay.cells)
        counts["S"] += 1
        AU, Btp, Bu = torch.split(buf, [2 * ns, 2 * ns, np_])
        opU = torch.where(free, (AU + Btp).reshape(ns, 2), U)
        return opU, torch.where(free_p, Bu, p)

    def A_bc(U):
        Y = _apply(sst.K, torch.where(free, U, 0.0))
        return torch.where(free, all_reduce_sum(Y, lay.cells), U)

    Mv = _cycle(sst.ml, A_bc, torch.float64)
    Z, Cinv, mp = sst.Z, sst.Cinv, sst.mp_inv

    def M(x):
        U, p = x
        return Mv(U), mp * p + Z @ (Cinv @ (Z.T @ p))
    return S, M, counts


def sharded_stokes_solve(sst: ShardedStokes, rtol=1e-9, maxiter=2000,
                         chunk_iters=80):
    """f64 MINRES over the mesh (``solvers.minres.minres_tree`` on the
    sharded applies), in every rank.  Returns (U (n_true, 2), p (np,))
    f64 tensors in FunctionSpace numbering and info: outer_iters,
    inner_iters (0), passes (1), resnorm and rel_resnorm (the true saddle
    residual), converged (MINRES's own test), method
    "minres+mg+sharded", all_reduces_per_iter."""
    lay = sst.layout
    applies0 = _apply.calls
    launches0 = kernel_launches()["element_apply"]
    S, M, counts = _stokes_ops(sst)
    calls0 = all_reduce_sum.calls
    res = minres_tree(S, sst.b, M, rtol=rtol, maxiter=maxiter,
                      chunk_iters=chunk_iters)
    # the opening S and M apply (1 + 2) are not an iteration's
    per_iter = ((all_reduce_sum.calls - calls0 - 3)
                / max(counts["S"] - 1, 1))
    SU, Sp = S(res.x)
    b = sst.b
    rn = float(torch.sqrt(torch.sum((b[0] - SU) ** 2)
                          + torch.sum((b[1] - Sp) ** 2)))
    bnorm = float(torch.sqrt(torch.sum(b[0] ** 2) + torch.sum(b[1] ** 2)))
    _check_kernels(lay, applies0, launches0)
    U = sst.G + res.x[0]
    if sst.iperm is not None:
        U = U[torch.as_tensor(sst.iperm[:sst.n_true].astype(np.int64),
                              device=U.device)]
    info = {"outer_iters": int(res.iters), "inner_iters": 0, "passes": 1,
            "resnorm": rn, "rel_resnorm": rn / max(bnorm, 1e-300),
            "converged": bool(res.converged), "method": "minres+mg+sharded",
            "all_reduces_per_iter": per_iter}
    return U[:sst.n_true], res.x[1][:sst.np_], info


# ---------------------------------------------------------------------------
# the SPMD functions the parent sends, and the parent's calls
# ---------------------------------------------------------------------------

def _sweep_task(ctx, sys, n_true, ml, robin_batch, D, mu, rtol, maxiter,
                chunk_iters, f32):
    t0 = time.time()
    ss = build_sharded_system(sys, ctx.mesh, multilevel=ml,
                              robin_batch=robin_batch, n_true=n_true)
    t1 = _sync(ctx.device)
    X, info = sharded_solve_sweep(ss, D, mu, rtol=rtol, maxiter=maxiter,
                                  chunk_iters=chunk_iters, f32=f32)
    t2 = _sync(ctx.device)
    info.update(setup_s=t1 - t0, solve_s=t2 - t1,
                elements=int(ss.K.A64.shape[0]),
                fine_bytes=fine_element_bytes(ss))
    return (X.cpu().numpy() if ctx.rank == 0 else None), info


def _device_bytes(dev) -> int:
    """The bytes this process holds on ``dev`` (0 off the card)."""
    return int(torch.cuda.memory_allocated(dev)) if dev.type == "cuda" else 0


def solve_sweep_sharded(group, sys, D_values, mu_values=None,
                        multilevel=None, robin_matrices=None, rtol=1e-10,
                        maxiter=5000, chunk_iters=50, f32=False,
                        device=None):
    """The parent's sharded sweep: ``sys`` (and ``multilevel``, built at
    this batch) sent as host copies to the ranks of ``group`` (a
    ``sharding.RankGroup``), ``sharded_solve_sweep`` there.  B must be a
    multiple of the group's dp (the studies pad with the last column, and
    build sys and the hierarchy on the CPU: the ranks need host copies
    only, so the parent keeps no unsharded system on the card).
    Returns (X (B, n_true) f64 on ``device`` (default sys's), info of
    rank 0, with ``ranks``: every rank's elements, fine_bytes, setup_s and
    solve_s, and parent_device_bytes: what this process held on the
    group's card while the ranks solved)."""
    B = len(np.asarray(D_values))
    if B % group.dp:
        raise ValueError(f"sweep batch {B} must divide over dp={group.dp}")
    mu = np.zeros(B) if mu_values is None else np.asarray(mu_values,
                                                          np.float64)
    host, n_true = host_system(sys, elements_only=True), int(sys.space.ndofs)
    Rb = (None if robin_matrices is None
          else torch.as_tensor(robin_matrices, dtype=torch.float64).cpu())
    held = _device_bytes(group.device)
    X, info = group.run(
        _sweep_task, host, n_true,
        None if multilevel is None else host_hierarchy(multilevel), Rb,
        np.asarray(D_values, np.float64), mu, rtol, maxiter, chunk_iters,
        f32)
    info = dict(info, parent_device_bytes=held, ranks=[{k: r[1][k] for k in (
        "elements", "fine_bytes", "setup_s", "solve_s", "stage_s")}
        for r in group.results])
    X = torch.as_tensor(X, device=sys.free.device if device is None
                        else device)
    if group.log is not None:
        group.log.append({"kind": "sweep", "sys": sys, "D": D_values,
                          "mu": mu_values, "multilevel": multilevel,
                          "robin_matrices": robin_matrices, "X": X,
                          "info": info})
    return X, info


def _stokes_task(ctx, host, rtol, maxiter, chunk_iters):
    t0 = time.time()
    sst = build_sharded_stokes(host, ctx.mesh)
    t1 = _sync(ctx.device)
    U, p, info = sharded_stokes_solve(sst, rtol=rtol, maxiter=maxiter,
                                      chunk_iters=chunk_iters)
    t2 = _sync(ctx.device)
    info.update(rank_setup_s=t1 - t0, solve_s=t2 - t1,
                elements=int(sst.K.A64.shape[0]),
                fine_bytes=_block_bytes(sst.K))
    if ctx.rank:
        return None, None, info
    return U.cpu().numpy(), p.cpu().numpy(), info


def stokes_solve_sharded(group, mesh, H, rtol=1e-9, maxiter=2000,
                         chunk_iters=40):
    """The parent's sharded Stokes solve (the JAX package's
    ``sharded_stokes_or_single`` with a shard spec): ``stokes_setup`` on
    the group's device in the parent (as JAX builds it on its device: the
    coarse-pressure deflation takes the setup's f32 cycle), its host copy
    to the ranks, the parent's references to the setup dropped, and
    ``sharded_stokes_solve`` in the ranks.  The field is kept in the setup
    cache as ``models.stokes_flow.stokes_solve`` keeps its own
    (``cached_field``), keyed by the mesh, H, rtol and the partition: the
    ranks, tp and the backend, which fix the all-reduces' summation order
    that the field's bits follow.  Returns (u, p) Functions with numpy
    values; ``solver_info`` carries the ranks' report plus setup_s (the
    parent's setup and copy), solve_s (the ranks' call),
    parent_setup_peak_bytes (the most the setup added on the card; the
    card's peak-memory statistics are reset for it) and
    parent_device_bytes (what this process held there while the ranks
    solved; the setup memos keep the velocity system)."""
    from ..fem.space import Function
    from ..models.stokes_flow import cached_field, stokes_setup
    from ..utils.diskcache import cache_key_of
    dev = group.device

    def solve():
        t0 = time.time()
        base = _device_bytes(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        st = stokes_setup(mesh, H, dev)
        host, V, Q = stokes_host(st), st.V, st.Q
        peak = (int(torch.cuda.max_memory_allocated(dev)) - base
                if dev.type == "cuda" else 0)
        del st
        t1 = _sync(dev)
        held = _device_bytes(dev)
        U, p, info = group.run(_stokes_task, host, rtol, maxiter,
                               chunk_iters)
        t2 = time.time()
        info = dict(info, setup_s=t1 - t0, solve_s=t2 - t1,
                    parent_setup_peak_bytes=peak, parent_device_bytes=held,
                    ranks=[r[2] for r in group.results])
        u = Function(V, U.reshape(-1))
        pf = Function(Q, p)
        u.solver_info = pf.solver_info = info
        return u, pf

    key = cache_key_of(
        "stokes-v1", np.asarray(mesh.vertices), np.asarray(mesh.cells),
        np.asarray(mesh.bc_marker), float(H), float(rtol), "f64",
        "minres+mg+sharded", group.n, group.tp, group.backend)
    u, p = cached_field(key, mesh, solve)
    if group.log is not None:
        group.log.append({"kind": "stokes", "mesh": mesh, "H": H, "u": u,
                          "p": p})
    return u, p
