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
The default solves (``precision="mixed"``) are f64 defect-correction loops
around f32 preconditioned Krylov passes with per-column ``active`` masks,
as the JAX package runs them on a TPU:

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

The Krylov iterations are ``solvers/batched.py``'s masked steps and its
loop (``krylov_loop``), which tests convergence on the host once per
iteration (``any(|r_b| > tol_b)``), one device sync each; the ``active``
masks make any extra iteration a no-op for converged columns, as in the
JAX programs.  On the card the mixed passes run the loop's graphed twin
(``KrylovGraph``): one graph of the f32 step per solve, captured at its
second step and replayed at every later one, with the eager loop's
iterations, reads and bits.  Every host read of a solve goes through
``utils.profiling.host_read`` (counted in ``host_syncs``), every
iteration counts in ``krylov_steps``, and a solve is a ``solve`` span
with ``solve.preconditioner``, one ``solve.pass`` per defect pass and
``solve.certify`` inside (and ``solve.capture`` inside the pass that
captures the step's graph).

``solve_sweep`` reaches the JAX package's other configurations through
keyword arguments (it reads no environment variable): ``precision="f64"``
(the JAX CPU default: one f64 CG or BiCGStab of ``solvers/batched.py`` with
the f64 cycle, every apply through kernel C) and ``"f32"``; the cycle
(``"hybrid"``, ``"mult"``, ``"add"``), its smoothing steps and its working
dtype (``ml_dtype=torch.bfloat16``, or ``transfer_dtype=torch.bfloat16``
alone); 0 or more cheap passes; the inner tolerance; and the
preconditioner: the multigrid cycle, the two-level one of
``solvers/twolevel.py`` (``twolevel=``, or ``coarse_mesh=``), or Jacobi.
The defaults are the configuration the JAX package runs on a TPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..fem.assembly import (advection_block, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..ops.band_plans import (BandPlan, best_bandwidth_permutation,
                              build_band_plan)
from ..ops.banded import BandKernel, band_from_elements, band_spans
from ..ops.elemspmv import (CHUNK_SLOTS, FILL_TILES, MIN_TILE_ROWS,
                            TILE_ROWS, ElementKernel, Scatter, TilePlan,
                            _i32, element_apply_plain, make_scatter,
                            make_segment_plan, make_tiles,
                            planned_segment_sum)
from ..solvers.batched import (KrylovGraph, _colnorm, batched_bicgstab,
                               batched_cg, bicgstab_state, bicgstab_step,
                               cg_state, cg_step, krylov_loop)
from ..utils.diskcache import (Memo, cache_key_of, count, disk_enabled,
                               load_arrays, store_arrays, timed)
from ..utils.profiling import host_read, span

__all__ = ["TransportSystem", "build_transport_system", "system_to",
           "system_from_arrays",
           "unpermute_columns", "robin_matrices_for_mu", "OperatorArgs",
           "operator_args", "apply_operator", "operator_rhs", "fine_dinv",
           "solve_sweep", "build_mu_sweep_system", "solve_mu_sweep",
           "MuSweepSystem", "BAND_TILE", "PRECISIONS"]

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
    column (``per_sample``).  ``with_bf16`` adds a bf16 copy of the f32
    matrices (the bf16 cycle's Robin blocks) and its kernel."""
    A64: torch.Tensor
    A32: torch.Tensor
    dofs: torch.Tensor        # (N, nd) int32
    scatter: Scatter
    kernels: Optional[dict] = None    # dtype -> ElementKernel, on CUDA
    A16: Optional[torch.Tensor] = None   # bf16 matrices (with_bf16)

    @classmethod
    def of(cls, A64, A32, dofs, scatter: Scatter, A16=None):
        """The block of these tensors, with its kernels where they lie on
        a CUDA device."""
        kernels = None
        if A64.device.type == "cuda":
            kernels = {A.dtype: ElementKernel(A, dofs, scatter)
                       for A in (A64, A32, A16) if A is not None}
        return cls(A64, A32, dofs, scatter, kernels, A16)

    def with_bf16(self):
        """This block with a bf16 copy of its f32 matrices (and, on a CUDA
        device, kernel C bound to it) beside the f64 and f32 ones."""
        if self.A16 is not None:
            return self
        A16 = self.A32.to(torch.bfloat16)
        kernels = self.kernels
        if kernels is not None:
            kernels = {**kernels, A16.dtype: ElementKernel(
                A16, self.dofs, self.scatter)}
        return self._replace(A16=A16, kernels=kernels)

    def matrices(self, dtype):
        """The entity matrices in ``dtype`` (f64, f32, or bf16 after
        ``with_bf16``)."""
        A = {torch.float64: self.A64, torch.float32: self.A32,
             torch.bfloat16: self.A16}.get(dtype)
        if A is None:
            raise TypeError(f"this block has no {dtype} matrices")
        return A

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
            return element_apply_plain(self.matrices(X.dtype), self.dofs,
                                       self.scatter, X, coef, out)
        if self.kernels is None:
            raise ValueError("kernel C needs every tensor on X's CUDA device")
        if X.dtype not in self.kernels:
            raise TypeError(f"this block has no {X.dtype} kernel")
        return self.kernels[X.dtype](X, coef, out)

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
                         self.dofs.to(device), self.scatter.to(device),
                         None if self.A16 is None else self.A16.to(device))


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
    mu_sweep_D: Optional[float] = None      # build_mu_sweep_system's fixed
                                            # D, which solve_mu_sweep uses
    Kkern: Optional[BandKernel] = None      # kernel A bound to each band
    Advkern: Optional[BandKernel] = None    #   (with_kernels)


def with_kernels(sys: TransportSystem) -> TransportSystem:
    """The system with kernel A bound to each of its bands (none where it
    has no band): every system with bands carries them."""
    return sys._replace(
        Kkern=None if sys.Kband is None else BandKernel(sys.Kband,
                                                        sys.Kspans),
        Advkern=None if sys.Advband is None else BandKernel(sys.Advband,
                                                            sys.Advspans))


def _to(x, device):
    return None if x is None else x.to(device)


def system_to(sys: TransportSystem, device) -> TransportSystem:
    """The same system with every tensor on ``device`` (its band kernels
    bound there)."""
    return with_kernels(sys._replace(
        K=sys.K.to(device), R=_to(sys.R, device), Adv=_to(sys.Adv, device),
        free=sys.free.to(device), bc_values=sys.bc_values.to(device),
        Kband=_to(sys.Kband, device), Advband=_to(sys.Advband, device),
        Kspans=_to(sys.Kspans, device), Advspans=_to(sys.Advspans, device)))


def unpermute_columns(sys: TransportSystem, Xcols):
    """(B, ndofs) columns in system numbering -> (B, n_true) in the
    FunctionSpace's dof numbering."""
    n_true = sys.space.ndofs
    if sys.iperm is None:
        return Xcols[:, :n_true]
    idx = torch.as_tensor(sys.iperm[:n_true].astype(np.int64),
                          device=Xcols.device)
    return Xcols[:, idx]


TSYS_TAG = "port-tsys"
# the fine and level systems of the few geometries a study step holds (the
# JAX package's _TSYS_MEMO cap); a fine entry holds its bands on the device
_TSYS_MEMO = Memo(TSYS_TAG, cap=24)


def _system_key(mesh: MeshData, element, u_values, u_space, dirichlet,
                with_robin):
    """Content key of an assembled system: every input of
    ``build_transport_system`` and the plan constants its arrays depend
    on."""
    if dirichlet is None:
        bc = "default"
    else:
        bc = repr([(int(m), float(v)) for m, v in dirichlet])
    return cache_key_of(
        "tsys-v1", np.asarray(mesh.vertices), np.asarray(mesh.cells),
        np.asarray(mesh.bc_marker), np.asarray(mesh.boundary.edges),
        np.asarray(mesh.boundary.cell), element,
        None if u_values is None else np.asarray(u_values, np.float64),
        None if u_space is None else (u_space.element, u_space.vs),
        bc, bool(with_robin), BAND_TILE, TILE_ROWS, MIN_TILE_ROWS,
        FILL_TILES, CHUNK_SLOTS)


def _np(t):
    return t.detach().cpu().numpy()


def _system_to_arrays(sys: TransportSystem, plan: BandPlan):
    """The host arrays of a system: its blocks' f64 matrices, dof maps,
    scatter and tile plans, the dof permutation, constraints and the band
    plan (the bands themselves are made again from it)."""
    out = {"ndofs": int(sys.ndofs), "free": _np(sys.free),
           "bc_values": _np(sys.bc_values), "perm": sys.perm,
           "iperm": sys.iperm, "plan_perm": plan.perm,
           "plan_ids": plan.ids_sorted,
           "plan_dims": np.asarray([plan.tiles, plan.tile, plan.width,
                                    plan.halo])}
    for name in ("K", "Adv", "R"):
        b = getattr(sys, name)
        if b is None:
            continue
        sc, tp = b.scatter, b.scatter.tiles
        out.update({
            f"{name}_A64": _np(b.A64), f"{name}_dofs": _np(b.dofs),
            f"{name}_perm": _np(sc.perm), f"{name}_ids": _np(sc.ids_sorted),
            f"{name}_rowptr": _np(sc.rowptr), f"{name}_ndofs": int(sc.ndofs),
            f"{name}_tile_ints": np.asarray(tp[6:])})
        for f in TilePlan._fields[:6]:
            out[f"{name}_tile_{f}"] = _np(getattr(tp, f))
    return out


def _block_from_arrays(d, name, device) -> Optional[_Block]:
    """Block ``name`` of a system's arrays: the stored plans where they
    are given (this package's cache), else the scatter's row pointers and
    kernel C's tiles made from the sorted scatter (the JAX package's
    arrays, ``convert``)."""
    if f"{name}_A64" not in d:
        return None
    A64 = torch.tensor(np.asarray(d[f"{name}_A64"]), dtype=torch.float64,
                       device=device)
    dofs = np.asarray(d[f"{name}_dofs"])
    perm = np.asarray(d[f"{name}_perm"])
    ids = np.asarray(d[f"{name}_ids"])
    ndofs = int(d[f"{name}_ndofs"])
    if f"{name}_rowptr" in d:
        rowptr = np.asarray(d[f"{name}_rowptr"])
        tiles = TilePlan(
            *[_i32(d[f"{name}_tile_{f}"], device)
              for f in TilePlan._fields[:6]],
            *[int(v) for v in d[f"{name}_tile_ints"]])
    else:
        rowptr = np.searchsorted(ids, np.arange(ndofs + 1))
        tiles = make_tiles(dofs, perm, rowptr, device)
    scatter = Scatter(perm=_i32(perm, device), ids_sorted=_i32(ids, device),
                      rowptr=_i32(rowptr, device), ndofs=ndofs, tiles=tiles)
    return _Block.of(A64, A64.float(), _i32(dofs, device), scatter)


def system_from_arrays(d, space: FunctionSpace, device) -> TransportSystem:
    """A system from its host arrays on ``device``: ``_system_to_arrays``'
    (the bands scattered again from the stored plan, as a build scatters
    them) or the JAX package's ``_system_to_arrays`` (dense ``Kband`` and
    ``Advband`` given).  Each band gets its ``band_spans``."""
    device = torch.device(device)
    K, Adv = _block_from_arrays(d, "K", device), \
        _block_from_arrays(d, "Adv", device)
    if "plan_perm" in d:
        t, r, w, halo = (int(v) for v in d["plan_dims"])
        plan = BandPlan(perm=np.asarray(d["plan_perm"]),
                        ids_sorted=np.asarray(d["plan_ids"]), tiles=t,
                        tile=r, width=w, halo=halo)
        Kband = band_from_elements(K.A32, plan)
        Advband = None if Adv is None else band_from_elements(Adv.A32, plan)
    else:
        Kband, Advband = (
            None if d.get(k) is None else torch.tensor(
                np.asarray(d[k]), dtype=torch.float32, device=device)
            for k in ("Kband", "Advband"))

    def host(k):
        v = d.get(k)
        return None if v is None else np.asarray(v)

    return with_kernels(TransportSystem(
        K=K, R=_block_from_arrays(d, "R", device), Adv=Adv,
        free=torch.tensor(np.asarray(d["free"], dtype=bool), device=device),
        bc_values=torch.tensor(np.asarray(d["bc_values"]),
                               dtype=torch.float64, device=device),
        ndofs=int(d["ndofs"]), space=space, Kband=Kband,
        Kspans=None if Kband is None else band_spans(Kband),
        perm=host("perm"), iperm=host("iperm"), Advband=Advband,
        Advspans=None if Advband is None else band_spans(Advband)))


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

    Padding dofs are constrained identity rows with zero right-hand side.

    The result is content-memoised in this process per (inputs, device),
    and its host arrays are kept in the setup cache (tag ``port-tsys``): a
    disk hit binds the blocks' kernels and scatters the bands again on
    ``device`` from the stored plan, and gives the build's tensors bit
    for bit.

    An ``assembly`` span; a build on a miss has the children
    ``assembly.space``, ``assembly.elements`` (twice: the element
    matrices, then their blocks in the new numbering), ``assembly.reorder``
    and ``assembly.bands`` (the plan, the bands and the uploads)."""
    with span("assembly"):
        device = torch.device(device)
        key = _system_key(mesh, element, u_values, u_space, dirichlet,
                          with_robin)
        memo_key = (key, str(device))
        hit = _TSYS_MEMO.get(memo_key)
        if hit is not None:
            if hit.space.mesh is not mesh:
                hit = hit._replace(space=FunctionSpace(mesh, element))
            return hit
        d = load_arrays(TSYS_TAG, key)
        if d is not None:
            return _TSYS_MEMO.put(memo_key, system_from_arrays(
                d, FunctionSpace(mesh, element), device))
        count(TSYS_TAG, "miss")
        sys, plan = _assemble_system(mesh, device, element, u_values, u_space,
                                     dirichlet, with_robin)
        if disk_enabled():
            with timed(TSYS_TAG, "write"):      # the copies to the host
                arrays = _system_to_arrays(sys, plan)
            store_arrays(TSYS_TAG, key, arrays)
        return _TSYS_MEMO.put(memo_key, sys)


def _assemble_system(mesh, device, element, u_values, u_space, dirichlet,
                     with_robin):
    """(the assembled system, its band plan): ``build_transport_system``'s
    build on a miss."""
    with span("assembly.space"):
        space = FunctionSpace(mesh, element)
        bottom = mesh.bc_marker == MARKERS["bottom"]
        if dirichlet is None:
            dirichlet = [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)]
        bc = make_bc(space, dirichlet)
        n_true = space.ndofs
        ndofs = -(-n_true // BAND_TILE) * BAND_TILE
        free = np.concatenate([bc.free,
                               np.zeros(ndofs - n_true, dtype=bool)])
        bc_values = np.concatenate([bc.values, np.zeros(ndofs - n_true)])
    with span("assembly.elements"):
        K_e, K_dofs = stiffness_block(space, device)
        Adv_e = R_e = None
        if u_values is not None:
            Adv_e, _ = advection_block(space, u_values, u_space, device)
        if with_robin and bottom.any():
            R_e, R_dofs = robin_facet_block(space, bottom, device)
    with span("assembly.reorder"):
        perm, iperm = best_bandwidth_permutation(
            K_dofs, np.asarray(space.dof_coords), n_true, ndofs)
        K_dofs = iperm[K_dofs]
    with span("assembly.elements"):
        K = _Block.build(K_e, K_dofs, ndofs)
        Adv = None if Adv_e is None else _Block.build(Adv_e, K_dofs, ndofs)
        R = None if R_e is None else _Block.build(R_e, iperm[R_dofs], ndofs)
    with span("assembly.bands"):
        plan = build_band_plan(K_dofs, ndofs, tile=BAND_TILE)
        Advband = Advspans = None
        if Adv is not None:
            Advband = band_from_elements(Adv.A32, plan)
            Advspans = band_spans(Advband)
        Kband = band_from_elements(K.A32, plan)
        return with_kernels(TransportSystem(
            K=K, R=R,
            free=torch.as_tensor(free[perm], device=device),
            bc_values=torch.as_tensor(bc_values[perm], dtype=torch.float64,
                                      device=device),
            ndofs=ndofs, space=space, Kband=Kband, Kspans=band_spans(Kband),
            perm=perm, iperm=iperm, Adv=Adv, Advband=Advband,
            Advspans=Advspans)), plan


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
    Kkern: Optional[BandKernel]     # kernel A on the bands: f32 view only
    Advkern: Optional[BandKernel]
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
        Kkern=sys.Kkern if f32 else None,
        Advkern=sys.Advkern if f32 else None, free=sys.free,
        D_vec=torch.as_tensor(D_vec, device=dev).to(dt),
        mu_vec=torch.as_tensor(mu_vec, device=dev).to(dt))


def _apply_raw(a: OperatorArgs, X):
    # summation order K, Adv, R as in the JAX programs; R adds into Y's
    # boundary rows in place (Y is this function's own)
    if a.Kkern is not None:
        Y = a.Kkern(X, a.D_vec)
    else:
        Y = a.K.apply_batched(X, coef=a.D_vec)
    if a.Adv is not None:
        Y = Y + (a.Advkern(X) if a.Advkern is not None
                 else a.Adv.apply_batched(X))
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


def fine_dinv(sys: TransportSystem, D_vec, mu_vec, robin_matrices=None,
              dtype=torch.float32):
    """(n, B) inverse diagonal of A(D_b, mu_b), computed in f64 and
    returned in ``dtype``; 1 on constrained rows.
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
                       1.0).to(dtype)


def _inner_loop(step, a32, M, RHS):
    """The f32 Krylov loop of a mixed solve's passes, ``loop(state, tol,
    maxiter) -> (state, iterations)``: on the card one ``KrylovGraph``
    for the whole solve (its step captured once and replayed in every
    pass; its buffers go with the loop when the solve returns), on the
    CPU ``krylov_loop``."""
    def A(P):
        return apply_operator(a32, P)

    if RHS.is_cuda:
        return KrylovGraph(step, A, M).loop
    return functools.partial(krylov_loop, step, A, M)


def _defect_pass(a64, M, loop, start, RHS, X, R64, tol, inner_rtol,
                 n_inner, true=True):
    """One pass of the f64 defect correction from X at its f64 residual
    R64: the solve's f32 ``loop`` (``_inner_loop``; ``start`` its step's
    state) from the correction 0, to max(inner_rtol ||R64||, 0.1 tol) per
    column and at most ``n_inner`` iterations, then X + the correction in
    f64 and the new residual: the true f64 one, or (``true`` False: a
    cheap pass) the inner recurrence's.  The caller opens the
    ``solve.pass`` span.

    Returns (X, R64, its norms (B,), iterations (B,))."""
    rn0 = _colnorm(R64)
    R = R64.float()
    tol_in = torch.maximum(inner_rtol * rn0, 0.1 * tol).float()
    s, cit = loop(start(M, torch.zeros_like(R), R), tol_in, n_inner)
    X = X + s.X.double()
    R64 = RHS - apply_operator(a64, X) if true else s.R.double()
    return X, R64, _colnorm(R64), cit


def _mixed_solve(a64, a32, M, RHS, X0, tol, cheap_passes=CHEAP_PASSES,
                 inner_rtol=INNER_RTOL, n_inner=N_INNER):
    """The JAX ``_mixed_solve_program`` with ``x0_lift=True``: X0 is the
    Dirichlet lift, so the opening residual is where(free, RHS, 0).  Each
    pass is a ``_defect_pass`` of ``solvers.batched.cg_step``: one leading
    true pass, ``cheap_passes`` cheap ones, a certifying f64 residual,
    then true passes until every column meets ``tol``.  ``cheap_passes`` =
    0 runs true passes only (each closing f64 residual opens the next
    pass); ``n_inner``: f32 CG iterations per pass at most.

    Returns (X, rn (B,) true f64 residual norms, iters (B,), passes)."""
    B = RHS.shape[1]
    loop = _inner_loop(cg_step, a32, M, RHS)

    def pass_(X, R64, true=True):
        with span("solve.pass"):
            return _defect_pass(a64, M, loop, cg_state, RHS, X, R64, tol,
                                inner_rtol, n_inner, true)

    X = X0
    R64 = torch.where(a64.free[:, None], RHS, 0.0)
    rn = _colnorm(R64)
    tot = torch.zeros(B, dtype=torch.int64, device=RHS.device)
    k = 0
    if cheap_passes > 0:
        # one leading true pass: a cheap pass started at full residual
        # scale would carry ~2^-24 ||b|| of f32 drift
        if bool(host_read((rn > tol).any())):
            X, R64, rn, cit = pass_(X, R64)
            tot, k = tot + cit, k + 1
        # cheap passes carry the inner CG's own recurrence residual
        while k < 1 + cheap_passes and bool(host_read((rn > tol).any())):
            X, R64, rn, cit = pass_(X, R64, true=False)
            tot, k = tot + cit, k + 1
        # certification: reported norms are always a true f64 residual
        with span("solve.certify"):
            R64 = RHS - apply_operator(a64, X)
            rn = _colnorm(R64)
    while k < MAX_PASSES and bool(host_read((rn > tol).any())):
        X, R64, rn, cit = pass_(X, R64)
        tot, k = tot + cit, k + 1
    return X, rn, tot, k


def _bicgstab_solve(a64, a32, M, RHS, X0, tol, inner_rtol=INNER_RTOL,
                    n_inner=N_INNER):
    """The JAX per-pass ``_refine_program_bicgstab`` loop: up to
    MAX_PASSES_BICGSTAB true passes (at least one), each a
    ``_defect_pass`` of ``solvers.batched.bicgstab_step``, started from
    the Dirichlet lift X0 (so the opening residual is where(free, RHS, 0),
    and each pass's closing residual opens the next: the same f64 values
    the JAX program recomputes); ``n_inner``: BiCGStab iterations per pass
    at most.

    Returns (X, rn (B,) true f64 residual norms, iters (B,), passes)."""
    X = X0
    R64 = torch.where(a64.free[:, None], RHS, 0.0)
    tot = torch.zeros(RHS.shape[1], dtype=torch.int64, device=RHS.device)
    loop = _inner_loop(bicgstab_step, a32, M, RHS)
    for k in range(1, MAX_PASSES_BICGSTAB + 1):
        with span("solve.pass"):
            X, R64, rn, cit = _defect_pass(
                a64, M, loop, bicgstab_state, RHS, X, R64, tol, inner_rtol,
                n_inner)
            tot = tot + cit
            if not bool(host_read((rn > tol).any())):
                break
    return X, rn, tot, k


PRECISIONS = ("mixed", "f64", "f32")


def solve_sweep(sys: TransportSystem, D_values, mu_values=None, rtol=1e-12,
                multilevel=None, robin_matrices=None, precision="mixed",
                cycle=None, cheap_passes=CHEAP_PASSES, inner_rtol=INNER_RTOL,
                ml_dtype=None, transfer_dtype=None, n_smooth=1,
                maxiter=50000, coarse_mesh=None, u_coarse=None,
                robin_coarse=None, twolevel=None):
    """Batched transport solve over sweep points: CG without advection,
    BiCGStab with it.

    D_values, mu_values: (B,).  robin_matrices: (B, F, nd, nd) f64
    per-sample Robin matrices on sys.R's facets (``robin_matrices_for_mu``
    stacked), in place of mu_values; where the hierarchy's fine level was
    built from this very tensor, its block is used and none is bound anew.
    The preconditioner: multilevel, a ``solvers.multilevel`` hierarchy;
    else twolevel, a ``solvers.twolevel.TwoLevelData``, or the one that
    ``build_twolevel`` makes of coarse_mesh (with u_coarse, the velocity
    (values, space) on it, and robin_coarse, the columns' Robin matrices
    on its bottom facets); else Jacobi.  maxiter: the Krylov iterations of
    an f64 or f32 solve, and at most that many per mixed pass.

    precision: "mixed" (f32 Krylov passes inside f64 defect correction, the
    JAX package's TPU configuration), "f64" (one f64 Krylov solve with the
    f64 cycle, its CPU default) or "f32" (one f32 solve, rtol at least
    1e-6).  cycle: "hybrid", "mult" or "add"; None takes hybrid for CG and
    mult for BiCGStab.  cheap_passes: defect passes of the mixed CG that
    carry the inner recurrence residual (0: true passes only).  inner_rtol:
    the residual reduction of one mixed pass.  ml_dtype: the cycle's
    working dtype under "mixed" and "f32" (None: f32; torch.bfloat16);
    transfer_dtype=torch.bfloat16: bf16 transfer bands in an f32 cycle.
    n_smooth: smoothing steps of the multiplicative part.

    Returns (X (B, n_true) f64 in FunctionSpace numbering, info) with info
    keys iters (B,), resnorm (B,), rel_resnorm (B,) (under "mixed" a true
    f64 residual; else the Krylov recurrence's, as in the JAX package),
    true_rel_resnorm (B,) (the f64 residual of the returned X, whatever
    the precision), converged (B,) bool (true_rel_resnorm <= rtol, or
    max(rtol, 1e-6) under "f32"; False for a column that broke down into
    NaN: a nonsymmetric solve whose cycle rounds to bf16 can) and, under
    "mixed", passes."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    with span("solve"):
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
                raise ValueError(f"{Rb.A64.shape[0]} Robin matrix sets for "
                                 f"{B} columns")
        a64 = operator_args(sys, D_vec, mu_vec, f32=False, R_batch=Rb)
        a32 = operator_args(sys, D_vec, mu_vec, f32=True, R_batch=Rb)
        G = sys.bc_values[:, None].expand(-1, B).contiguous()
        RHS = operator_rhs(a64, G)
        wd = torch.float64 if precision == "f64" else torch.float32
        with span("solve.preconditioner"):
            Rb64 = None if Rb is None else Rb.A64
            if multilevel is not None:
                from ..solvers.multilevel import make_ml_preconditioner
                if cycle is None:
                    cycle = "mult" if nonsym else "hybrid"
                M = make_ml_preconditioner(
                    multilevel, cycle=cycle,
                    dtype=torch.float64 if precision == "f64" else ml_dtype,
                    transfer_dtype=transfer_dtype, n_smooth=n_smooth)
            elif twolevel is not None or coarse_mesh is not None:
                from ..solvers.twolevel import (build_twolevel,
                                                make_preconditioner)
                tl = twolevel
                if tl is None:
                    tl = build_twolevel(sys, coarse_mesh, D_values,
                                        mu_values,
                                        robin_matrices_coarse=robin_coarse,
                                        u_coarse=u_coarse)
                M = make_preconditioner(tl, fine_dinv(
                    sys, D_vec, mu_vec, Rb64, dtype=torch.float64))
            else:
                dinv = fine_dinv(sys, D_vec, mu_vec, Rb64, dtype=wd)

                def M(R):
                    return dinv * R
        bnorm = _colnorm(RHS)
        bn = host_read(bnorm)
        bn = np.where(bn > 0, bn, 1.0)
        if precision == "mixed":
            n_inner = min(N_INNER, maxiter)
            if nonsym:
                X, rn, tot, passes = _bicgstab_solve(
                    a64, a32, M, RHS, G, rtol * bnorm, inner_rtol, n_inner)
            else:
                X, rn, tot, passes = _mixed_solve(
                    a64, a32, M, RHS, G, rtol * bnorm, cheap_passes,
                    inner_rtol, n_inner)
            with span("solve.certify"):
                resnorm = host_read(rn)
                info = {"iters": host_read(tot), "resnorm": resnorm,
                        "rel_resnorm": resnorm / bn,
                        "true_rel_resnorm": resnorm / bn,
                        "converged": resnorm / bn <= rtol,
                        "passes": int(passes)}
                return unpermute_columns(sys, X.t()), info
        krylov = batched_bicgstab if nonsym else batched_cg
        a = a64 if precision == "f64" else a32
        if precision == "f32":
            rtol = max(rtol, 1e-6)
        with span("solve.pass"):
            res = krylov(lambda P: apply_operator(a, P), RHS.to(wd), M=M,
                         X0=G.to(wd), rtol=rtol, maxiter=maxiter)
        with span("solve.certify"):
            X = res.X.double()
            true = host_read(_colnorm(RHS - apply_operator(a64, X)))
            info = {"iters": res.iters, "resnorm": res.resnorm,
                    "rel_resnorm": res.resnorm / bn,
                    "true_rel_resnorm": true / bn,
                    "converged": true / bn <= rtol}
            return unpermute_columns(sys, X.t()), info


# the JAX package's simple-mu API: a pure-diffusion sweep over mu at one D
MuSweepSystem = TransportSystem


def build_mu_sweep_system(mesh: MeshData, device, D=1.0, element="P2",
                          u_values=None, u_space=None) -> TransportSystem:
    """``build_transport_system`` with the fixed diffusivity ``D`` of the
    sweeps that ``solve_mu_sweep`` runs on it recorded on the system."""
    return build_transport_system(mesh, device, element, u_values,
                                  u_space)._replace(mu_sweep_D=float(D))


def solve_mu_sweep(sys: TransportSystem, mu_values, rtol=1e-13,
                   **options):
    """``solve_sweep`` over ``mu_values`` at the system's recorded D (1.0
    for a system not made by ``build_mu_sweep_system``); ``options`` are
    ``solve_sweep``'s keyword arguments."""
    D = 1.0 if sys.mu_sweep_D is None else sys.mu_sweep_D
    return solve_sweep(sys, [D] * len(mu_values), mu_values=mu_values,
                       rtol=rtol, **options)
