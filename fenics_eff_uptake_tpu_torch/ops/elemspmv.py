"""Element-block operator apply (counterpart of ``ops/elemspmv.py``) and
kernel C, the element apply.

An operator block is kept as per-entity dense matrices ``A_e (N, nd, nd)``
plus the entity -> dof map, and applied to a batch-minor ``(n, B)`` array:

    Y[d, b] = coef[b] * sum_{(e,i): dofs[e,i] = d} sum_j A_e[e,i,j] X[dofs[e,j], b]

Two forms: the full output ``Y`` (every row), and ``out=``, which adds the
block's result into ``out`` in place (``out[d, b] += ...``) and returns
it; on the card that form reads and writes only the rows the block
touches.  A per-sample block carries one matrix set per column,
``A_e (B, N, nd, nd)``, on the same dof map, and takes no ``coef``:

    Y[d, b] = sum_{(e,i): dofs[e,i] = d} sum_j A_e[b,e,i,j] X[dofs[e,j], b]

A CPU tensor takes the plain PyTorch version, :func:`element_apply_plain`
(gather, einsum, ``index_add_`` in sorted order).  On a CUDA device an
:class:`ElementKernel` binds one block to the hand-written kernel of
``csrc/element_apply.cu``: it checks the block's fixed tensors once, when
it is made, and only ``X``, ``coef`` and ``out`` per call, and launches or
raises.  There is no fallback between the two.  The kernel runs on the
tile plan of :func:`make_tiles`, which :func:`make_scatter` builds beside
the sorted-scatter plan.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build

__all__ = ["Scatter", "TilePlan", "make_scatter", "make_tiles",
           "element_apply_plain", "ElementKernel", "SegmentPlan",
           "make_segment_plan", "planned_segment_sum", "meta_ints",
           "TILE_ROWS", "CHUNK_SLOTS"]

# entity sizes kernel C is compiled for: 6 (P2 cells, and P2 Robin facets,
# which carry their owner cell's dofs), 3 (P1), 2 (two-node edge blocks)
KERNEL_ND = (2, 3, 6)
# the kernel's row tile and entry chunk: the most rows (with entries) of
# one thread block, and the sorted entries whose products it holds in
# shared memory at once (csrc/element_apply.cu).  A block with few rows
# takes smaller tiles, down to MIN_TILE_ROWS, so that it still makes about
# FILL_TILES tiles: a few thread blocks for each of an H100's 132 SMs.
TILE_ROWS = 64
MIN_TILE_ROWS = 8
FILL_TILES = 512
CHUNK_SLOTS = 512
_MAX_TILE_ROWS = 512      # with CHUNK_SLOTS, one f64 column fits 96 KB


def meta_ints(nd: int) -> int:
    """ints per element record: index, nd dofs, nd slots, to 16 bytes."""
    return (1 + 2 * nd + 3) // 4 * 4


class TilePlan(NamedTuple):
    """Kernel C's plan of one entity -> dof map (:func:`make_tiles`)."""
    rows: torch.Tensor    # (n_rows,) int32: the rows with entries, ascending
    rptr: torch.Tensor    # (n_rows+1,) int32: first sorted entry of each
    cptr: torch.Tensor    # (T+1,) int32: first chunk of each tile
    eptr: torch.Tensor    # (n_chunks+1,) int32: first record of each chunk
    meta: torch.Tensor    # (n_records, meta_ints(nd)) int32: per chunk, one
                          #   record per distinct entity, in the order its
                          #   first entry sorts: the entity, its nd dofs,
                          #   the chunk slot of each entry (-1 outside)
    gaps: torch.Tensor    # (n_gaps,) int32: the rows without entries
    rows_per_tile: int
    chunk_slots: int
    max_chunk: int        # most entries in one chunk
    max_elems: int        # most records in one chunk
    max_tile_chunks: int  # most chunks in one tile
    x_rows: int           # rows of X the block reads (its largest dof + 1)

    @property
    def n_tiles(self):
        return self.cptr.shape[0] - 1

    def to(self, device):
        return TilePlan(*[x.to(device) for x in self[:6]], *self[6:])


class Scatter(NamedTuple):
    """Sorted-scatter plan for one entity -> dof map."""
    perm: torch.Tensor        # (N*nd,) int32: flat entries sorted by dof
    ids_sorted: torch.Tensor  # (N*nd,) int32: their dof ids, ascending
    rowptr: torch.Tensor      # (ndofs+1,) int32: CSR start of each dof
    ndofs: int
    tiles: TilePlan           # kernel C's plan (make_tiles)

    def to(self, device):
        return Scatter(*[x.to(device) for x in self[:3]], self.ndofs,
                       self.tiles.to(device))


def _i32(a, device):
    return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def make_tiles(dofs, perm, rowptr, device, rows_per_tile=None,
               chunk_slots=CHUNK_SLOTS) -> TilePlan:
    """Host-built tile plan of an (N, nd) numpy dof map from its
    sorted-scatter plan (``perm``, the stable argsort of the flat entries
    by dof, and ``rowptr``).

    The rows that hold entries are cut into tiles of ``rows_per_tile``
    consecutive ones (default: TILE_ROWS, or fewer for a block of few
    rows); a tile's entries are one range of sorted positions, cut into
    chunks of ``chunk_slots``; each chunk holds one record per distinct
    entity of its entries, in the order of their first entry.  Rows
    without entries belong to no tile; they are listed apart (the
    full-output form writes them as zeros)."""
    dofs = np.asarray(dofs, dtype=np.int32)
    perm = np.asarray(perm, dtype=np.int64)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    N, nd = dofs.shape
    m = perm.size
    if m != N * nd or m >= 2 ** 31:
        raise ValueError(f"{m} entries do not form an int32 ({N}, {nd}) "
                         "dof map")
    touched = rowptr[1:] > rowptr[:-1]
    rows = np.flatnonzero(touched)
    if rows_per_tile is None:
        rows_per_tile = TILE_ROWS
        while (rows_per_tile > MIN_TILE_ROWS
               and rows.size < rows_per_tile * FILL_TILES):
            rows_per_tile //= 2
    if not 1 <= rows_per_tile <= _MAX_TILE_ROWS:
        raise ValueError(f"rows_per_tile={rows_per_tile} not in "
                         f"[1, {_MAX_TILE_ROWS}]")
    if not 1 <= chunk_slots <= CHUNK_SLOTS:
        raise ValueError(f"chunk_slots={chunk_slots} not in "
                         f"[1, {CHUNK_SLOTS}]")
    S = chunk_slots
    rptr = np.append(rowptr[rows], m)
    kptr = rptr[::rows_per_tile] if rows.size else np.zeros(1, np.int64)
    if kptr[-1] != m:
        kptr = np.append(kptr, m)
    lens = np.diff(kptr)
    nch = -(-lens // S)
    cptr = np.concatenate([[0], np.cumsum(nch)])
    n_chunks = int(cptr[-1])
    ctile = np.repeat(np.arange(lens.size), nch)
    cstart = kptr[ctile] + (np.arange(n_chunks) - cptr[ctile]) * S
    clen = np.diff(np.append(cstart, m))
    chunk = np.repeat(np.arange(n_chunks), clen)
    pos = np.empty(m, dtype=np.int64)
    pos[perm] = np.arange(m)
    # each entity's entries in sorted order: the first of each chunk opens
    # the entity's record in that chunk
    P = pos.reshape(N, nd)
    Ps = np.sort(P, axis=1)
    Cs = chunk[Ps]
    opens = np.ones((N, nd), dtype=bool)
    opens[:, 1:] = Cs[:, 1:] != Cs[:, :-1]
    is_first = np.zeros(m, dtype=bool)
    is_first[Ps[opens]] = True
    first = np.flatnonzero(is_first)                 # in sorted order
    rec_e = perm[first] // nd
    rec_c = chunk[first]
    counts = np.bincount(rec_c, minlength=n_chunks)
    eptr = np.concatenate([[0], np.cumsum(counts)])
    meta = np.full((rec_e.size, meta_ints(nd)), -1, dtype=np.int32)
    meta[:, 0] = rec_e
    meta[:, 1:1 + nd] = dofs[rec_e]
    slot = (P.astype(np.int32)[rec_e]
            - cstart.astype(np.int32)[rec_c][:, None])
    np.putmask(slot, (slot < 0) | (slot >= clen[rec_c][:, None]), -1)
    meta[:, 1 + nd:1 + 2 * nd] = slot
    return TilePlan(
        rows=_i32(rows, device), rptr=_i32(rptr, device),
        cptr=_i32(cptr, device), eptr=_i32(eptr, device),
        meta=_i32(meta, device),
        gaps=_i32(np.flatnonzero(~touched), device),
        rows_per_tile=int(rows_per_tile), chunk_slots=int(S),
        max_chunk=int(min(S, lens.max())) if lens.size else 0,
        max_elems=int(counts.max()) if n_chunks else 0,
        max_tile_chunks=int(nch.max()) if lens.size else 0,
        x_rows=int(rows[-1]) + 1 if rows.size else 0)


def make_scatter(entity_dofs, ndofs: int, device) -> Scatter:
    """Host-built plans of an (N, nd) entity -> dof map (numpy or tensor):
    the sorted scatter and kernel C's tiles."""
    dofs = np.asarray(torch.as_tensor(entity_dofs).cpu())
    ids = dofs.ravel()
    perm = np.argsort(ids, kind="stable")
    ids_sorted = ids[perm]
    rowptr = np.searchsorted(ids_sorted, np.arange(ndofs + 1))
    return Scatter(perm=_i32(perm, device),
                   ids_sorted=_i32(ids_sorted, device),
                   rowptr=_i32(rowptr, device), ndofs=int(ndofs),
                   tiles=make_tiles(dofs, perm, rowptr, device))


class SegmentPlan(NamedTuple):
    """Gather plan of a segment sum over a fixed entry -> segment map:
    row k of ``idx`` holds, for every segment that has entries, one plus
    the position of its k-th entry (in entry order), or 0, a prepended
    zero, where it has fewer."""
    idx: torch.Tensor              # (max_count, n_used) int64
    segs: Optional[torch.Tensor]   # (n_used,) int64 segment ids, or None
                                   #   when every segment has entries
    num_segments: int


def make_segment_plan(ids, num_segments: int, device,
                      order=None) -> SegmentPlan:
    """Plan, built on ``device``, for the segment ids of the entries (any
    shape, flattened in C order; numpy or tensor).  A caller that already
    holds a stable argsort of the ids passes them sorted, and that argsort
    as ``order``; entries it leaves out of ``order`` stay out of the
    sums."""
    ids = torch.as_tensor(ids, device=device).reshape(-1).long()
    if order is None:
        ids, order = torch.sort(ids, stable=True)
    order = torch.as_tensor(order, device=device).long()
    m = ids.numel()
    first = torch.ones(m, dtype=torch.bool, device=device)
    first[1:] = ids[1:] != ids[:-1]
    start = torch.nonzero(first).reshape(-1)
    counts = torch.diff(start, append=start.new_tensor([m]))
    col = torch.repeat_interleave(
        torch.arange(start.numel(), device=device), counts)
    rank = torch.arange(m, device=device) - start[col]
    max_count = int(counts.max()) if m else 0
    idx = torch.zeros((max_count, start.numel()), dtype=torch.long,
                      device=device)
    idx[rank, col] = order + 1
    dense = start.numel() == num_segments
    return SegmentPlan(idx=idx, segs=None if dense else ids[start],
                       num_segments=int(num_segments))


def planned_segment_sum(vals, plan: SegmentPlan):
    """out[s] = sum of the rows of ``vals`` (M, ...) in segment s, added in
    entry order: one gather and add per rank and one store to distinct
    slots, no atomics, so every device gives the same sums (CUDA's
    ``index_add_`` with repeated ids adds in no fixed order)."""
    rest = tuple(vals.shape[1:])
    Vp = torch.cat([vals.new_zeros((1,) + rest), vals])
    out = vals.new_zeros((plan.idx.shape[1],) + rest)
    for k in range(plan.idx.shape[0]):
        out = out + Vp[plan.idx[k]]
    if plan.segs is None:
        return out
    full = vals.new_zeros((plan.num_segments,) + rest)
    full[plan.segs] = out
    return full


def element_apply_plain(A, dofs, scatter: Scatter, X, coef=None, out=None):
    """Plain PyTorch kernel C: gather, einsum, ``index_add_`` in sorted
    order; with ``out``, ``out += that`` in place (returns ``out``).  A is
    (N, nd, nd), shared by the columns, or per-sample (B, N, nd, nd) (then
    without ``coef``).  Runs on any device; the CPU path and the tests use
    it."""
    N, nd = dofs.shape
    B = X.shape[1]
    Xe = X[dofs.long()]                                  # (N, nd, B)
    if A.dim() == 4:
        if coef is not None or A.shape[0] != B:
            raise ValueError(f"per-sample A {tuple(A.shape)} takes X of "
                             f"{A.shape[0]} columns and no coef")
        Ye = torch.einsum("bnij,njb->nib", A.to(X.dtype), Xe)
    else:
        Ye = torch.einsum("nij,njb->nib", A.to(X.dtype), Xe)
    if coef is not None:
        Ye = Ye * coef.to(X.dtype)
    Y = torch.zeros((scatter.ndofs, B), dtype=X.dtype, device=X.device)
    Y.index_add_(0, scatter.ids_sorted.long(),
                 Ye.reshape(N * nd, B)[scatter.perm.long()])
    return Y if out is None else out.add_(Y)


def _check_block(A, dofs, scatter: Scatter, dtype=None):
    """Raise unless kernel C can take this block as it is (and, where
    ``dtype`` is given, X of that dtype)."""
    if A.dim() not in (3, 4) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (N, nd, nd) or (B, N, nd, nd), got "
                         f"{tuple(A.shape)}")
    N, nd = A.shape[-3], A.shape[-1]
    if nd not in KERNEL_ND:
        raise ValueError(f"nd={nd} not in {KERNEL_ND}")
    if A.dtype not in (torch.float32, torch.float64) or (
            dtype is not None and A.dtype != dtype):
        raise TypeError(f"A and X must share f32 or f64, got {A.dtype}, "
                        f"{dtype}")
    if tuple(dofs.shape) != (N, nd) or dofs.dtype != torch.int32:
        raise ValueError("dofs must be (N, nd) int32")
    if scatter.perm.numel() != N * nd or scatter.perm.dtype != torch.int32:
        raise ValueError("scatter.perm must be (N*nd,) int32")
    if (scatter.rowptr.numel() != scatter.ndofs + 1
            or scatter.rowptr.dtype != torch.int32):
        raise ValueError("scatter.rowptr must be (ndofs+1,) int32")
    tp = scatter.tiles
    if (tp.rptr.numel() != tp.rows.numel() + 1
            or tp.meta.shape[1:] != (meta_ints(nd),)
            or tp.rows.numel() + tp.gaps.numel() != scatter.ndofs):
        raise ValueError("the tile plan is not this block's")
    ts = [A, dofs, scatter.perm, *tp[:6]]
    if any(t.dtype != torch.int32 for t in ts[1:]):
        raise ValueError("the tile plan's arrays must be int32")
    for t in ts:
        if t.device.type != "cuda" or t.device != A.device:
            raise ValueError("kernel C needs every tensor on X's CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel C needs contiguous tensors")


def _check_call(X, coef, out, dtype, device, ndofs, min_rows, batch=0):
    """Raise unless X, coef and out fit a block of ``ndofs`` rows in
    ``dtype`` on ``device`` whose dofs need ``min_rows`` rows of X; a
    per-sample block bound at ``batch`` > 0 columns takes X of exactly
    that many and no coef."""
    if X.dtype != dtype:
        raise TypeError(f"A and X must share f32 or f64, got {dtype}, "
                        f"{X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (n, B), got {tuple(X.shape)}")
    n, B = X.shape
    if B < 1 or n < min_rows:
        raise ValueError(f"X {tuple(X.shape)} needs B >= 1 and at least "
                         f"{min_rows} rows")
    if batch and (B != batch or coef is not None):
        raise ValueError(f"a per-sample block bound at B={batch} takes X of "
                         f"{batch} columns and no coef, got B={B}"
                         + ("" if coef is None else " with coef"))
    ts = [X]
    if coef is not None:
        if coef.dtype != dtype or tuple(coef.shape) != (B,):
            raise ValueError("coef must be (B,) of X's dtype")
        ts.append(coef)
    if out is not None:
        if out.dtype != dtype or tuple(out.shape) != (ndofs, B):
            raise ValueError(f"out must be ({ndofs}, {B}) of X's dtype")
        size = X.element_size() * B
        xa, oa = X.data_ptr(), out.data_ptr()
        if xa < oa + ndofs * size and oa < xa + n * size:
            raise ValueError("out must not overlap X")
        ts.append(out)
    for t in ts:
        if t.device != device:
            raise ValueError("kernel C needs every tensor on X's CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel C needs contiguous tensors")


class _PlanStruct(ctypes.Structure):
    """csrc/element_apply.cu ``Plan``: one block's plan for the kernel."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "A", "rows", "rptr", "cptr", "eptr", "meta", "gaps")]
        + [(n, ctypes.c_int) for n in (
            "is_f64", "nd", "ndofs", "n_rows", "n_tiles", "rows_per_tile",
            "chunk_slots", "max_chunk", "max_elems", "max_tile_chunks",
            "n_gaps", "batch")])


class ElementKernel:
    """Kernel C bound to one element block in one dtype (A's).

    The block's fixed tensors (A, dofs, the scatter and tile plans) are
    checked here, once, and A's rows are copied in sorted-entry order (the
    kernel reads a chunk's rows as one range; A must not change after);
    a call checks what changes (X, coef, out: shape, dtype, device,
    contiguity) and launches on the current stream.  ``kernel(X, coef)``
    returns the full (ndofs, B) output; ``kernel(X, coef, out=Y)`` adds
    into Y's touched rows and returns Y.

    A per-sample block, A (B, N, nd, nd), is bound with its rows in the
    same sorted-entry order and the batch innermost, (N*nd, nd, B): the
    kernel reads them from global memory, neighbouring threads (columns)
    at neighbouring addresses.  It takes X of exactly B columns and no
    coef, and raises on anything else.

    ``ElementKernel.launches`` counts the launches of every bound block,
    ``ElementKernel.launches_out`` those of the out= form among them,
    ``ElementKernel.launches_sample`` those of per-sample blocks (either
    form) among them."""

    launches = 0
    launches_out = 0
    launches_sample = 0
    __slots__ = ("A_sorted", "scatter", "device", "dtype", "ndofs",
                 "min_rows", "batch", "_plan", "_addr", "_fn", "_index")

    def __init__(self, A, dofs, scatter: Scatter):
        _check_block(A, dofs, scatter)
        tp = scatter.tiles
        nd = A.shape[-1]
        perm = scatter.perm.long()
        if A.dim() == 4:
            self.batch = A.shape[0]
            self.A_sorted = (A.permute(1, 2, 3, 0)
                             .reshape(-1, nd, self.batch)[perm].contiguous())
        else:
            self.batch = 0
            self.A_sorted = A.reshape(-1, nd)[perm].contiguous()
        self.scatter = scatter
        self.device, self.dtype = A.device, A.dtype
        self.ndofs = scatter.ndofs
        self.min_rows = tp.x_rows
        self._plan = _PlanStruct(
            self.A_sorted.data_ptr(), *[x.data_ptr() for x in tp[:6]],
            int(A.dtype == torch.float64), nd, scatter.ndofs,
            tp.rows.numel(), tp.n_tiles, tp.rows_per_tile, tp.chunk_slots,
            tp.max_chunk, tp.max_elems, tp.max_tile_chunks,
            tp.gaps.numel(), self.batch)
        self._addr = ctypes.addressof(self._plan)
        self._fn = None
        self._index = A.device.index

    def __call__(self, X, coef=None, out=None):
        _check_call(X, coef, out, self.dtype, self.device, self.ndofs,
                    self.min_rows, self.batch)
        if self._fn is None:
            self._fn = _build.library().feu_element_apply
        B = X.shape[1]
        Y = out if out is not None else torch.empty(
            (self.ndofs, B), dtype=X.dtype, device=X.device)
        err = self._fn(self._addr, X.data_ptr(),
                       None if coef is None else coef.data_ptr(),
                       Y.data_ptr(), int(out is not None), B,
                       _build.raw_stream(self._index))
        if err:
            _build.check(err, "element_apply")
        ElementKernel.launches += 1
        if out is not None:
            ElementKernel.launches_out += 1
        if self.batch:
            ElementKernel.launches_sample += 1
        return Y
