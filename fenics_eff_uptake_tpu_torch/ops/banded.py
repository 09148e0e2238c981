"""Banded-dense operator forms (counterpart of ``ops/banded.py``) and
kernels A and B.

After a bandwidth-reducing dof ordering, the assembled operator fits a
block band of row tiles:

    band[t, r, w] = A[t*R + r, (t - halo)*R + w],   W = (2*halo + 1)*R

and a multigrid transfer (restriction or prolongation) a windowed band
whose window start is per-tile data:

    band[t, r, w] = P[t*R + r, offs[t] + w]

:class:`BandKernel` (kernel A) and :class:`RectBandKernel` (kernel B)
are a band bound once, where it is made: its fixed tensors are checked
there, its f32 form gets its work list (:func:`work_list`) and the
tensor map of ``csrc/band_f32.cu``, and a call checks only what changes
(X, coef) and launches.  They dispatch on the device of X: CPU tensors
take the plain PyTorch versions, CUDA tensors the kernels of
``csrc/band_f32.cu`` (f32) and ``csrc/band_apply.cu`` (bf16), or raise.
:func:`band_apply` and :func:`rect_band_apply` are the same kernels
bound for the one call; a band's work list is kept with its spans
(:func:`work_list`), so binding it again launches nothing.  The band
values are scattered on the band's device by the deterministic
``planned_segment_sum``.  Host plans live in
``ops/band_plans.py``.

Less than half of a band holds anything.  :func:`band_spans` records, for
each block of ``SPAN_ROWS`` band rows, the range of ``SPAN_COLS``-column
chunks that holds all of its nonzeros; it is computed once where each band
is made and carried beside it, and the kernels stream only those chunks.
Every skipped term is ``fmaf(0, x, acc) == acc``, so for finite X the
result equals the full-width sum bit for bit.

An assembled operator's spans are still mostly zeros (a graded band's
64-row block spans ~1,150 columns for ~12 nonzeros a row), so kernel A
has a second f32 form, ``csrc/band_packed.cu``, that streams only the
nonzeros (:func:`band_pack`, :class:`PackedBand`: sliced ELL, slices of
``PACK_ROWS`` rows, each row's entries in ascending window column).  Its
outputs are the same chains less their zero terms, so it gives the span
form's bits.  :func:`band_form` picks the form of a band by its bytes:
:class:`BandKernel` binds the packed form where it reads fewer bytes than
the spans, the span form elsewhere (dense bands).

Operand types.  Both kernels take f32 operands, and the bf16 operand forms
of the JAX package's bf16 cycle and bf16 transfer bands:

    A          band, X, coef and Y in bf16
    B, form 1  band in bf16, X in f32 (rounded to bf16 as it is read), Y f32
    B, form 2  band, X and Y in bf16

In each the products are formed from the bf16 values and summed in f32 (a
bf16 x bf16 product is exact in f32), the coef product is made in f32, and
a bf16 Y is rounded once, on the store; the plain versions upcast, run the
f32 einsum and round once, and never a bf16 einsum.  On the card the bf16
forms run on the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32
accumulate), as the TPU kernels' bf16 branch runs on the MXU: the f32 sums
go in the tensor cores' order, so the kernels are held to the plain
versions by tolerance (a bf16 Y equal in at least 99% of the entries and
each within one bf16 ulp or 1e-5 of its sum of |terms|; an f32 Y within
1e-5 of it), not bit for bit.  The spans of an f32 band serve its bf16
copy: bf16 has f32's exponent range, so rounding to bf16 makes no nonzero
of the band zero (short of f32's subnormals, and a value that did round to
zero adds nothing).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build
from .band_plans import BandPlan, RectBandPlan
from .elemspmv import make_segment_plan, planned_segment_sum

__all__ = ["band_from_elements", "rect_band_values", "band_spans",
           "span_elements", "SPAN_ROWS", "SPAN_COLS", "MAX_COLS",
           "band_order", "band_items", "work_list", "box_rows",
           "chunk_subs", "ring_stages", "PACK_ROWS", "PackedBand",
           "band_pack", "band_form", "BandKernel", "RectBandKernel",
           "band_apply", "band_apply_plain", "check_band_apply_args",
           "rect_band_apply", "rect_band_apply_plain",
           "check_rect_band_apply_args", "BAND_APPLY_DTYPES",
           "RECT_BAND_APPLY_DTYPES", "launches_by_band"]

# the kernels' span block and column sub-box (csrc/band_f32.cu kSpanRows,
# kSub; csrc/band_apply.cu kRows, kK), and the widest column block of one
# item (kMaxCols)
SPAN_ROWS = 64
SPAN_COLS = 32
MAX_COLS = 96


def band_from_elements(A_e, plan: BandPlan):
    """Scatter element matrices (N, nd, nd) into the f32 (T, R, W) band."""
    seg = make_segment_plan(plan.ids_sorted,
                            plan.tiles * plan.tile * plan.width, A_e.device,
                            order=plan.perm)
    flat = planned_segment_sum(A_e.float().reshape(-1), seg)
    return flat.reshape(plan.tiles, plan.tile, plan.width)


def rect_band_values(plan: RectBandPlan, vals):
    """Scatter transfer entries (the flattened (n, k) weights) into the
    (T, R, W) band on ``vals``' device; dump-slot (zero) entries drop."""
    segs = plan.tiles * plan.tile * plan.width
    keep = plan.ids < segs          # the dump slot sorts last
    seg = make_segment_plan(plan.ids[keep], segs, vals.device,
                            order=plan.perm[keep])
    flat = planned_segment_sum(vals.reshape(-1), seg)
    return flat.reshape(plan.tiles, plan.tile, plan.width)


def band_spans(band):
    """(T, ceil(R / SPAN_ROWS), 2) int32 on the band's device: for each
    block of SPAN_ROWS rows of each tile, the range [lo, hi) of
    SPAN_COLS-column chunks that holds every nonzero of the block (the
    first and last chunk of the range hold one); [0, 0) for a block
    without any.  One reduction over the band."""
    T, R, W = band.shape
    nb, nc = -(-R // SPAN_ROWS), -(-W // SPAN_COLS)
    nz = F.pad(band != 0, (0, nc * SPAN_COLS - W, 0, nb * SPAN_ROWS - R))
    occ = nz.reshape(T, nb, SPAN_ROWS, nc, SPAN_COLS).any(4).any(2)
    k = torch.arange(nc, dtype=torch.int32, device=band.device)
    hi = torch.where(occ, k + 1, 0).amax(-1)
    lo = torch.where(occ, k, nc).amin(-1)
    lo = torch.where(hi > 0, lo, 0)
    return torch.stack([lo, hi], -1).to(torch.int32).contiguous()


def _span_elements(band, spans):
    T, R, W = band.shape
    nb = spans.shape[1]
    rows = torch.clamp(R - SPAN_ROWS * torch.arange(nb, device=band.device),
                       max=SPAN_ROWS)
    cols = (torch.clamp(spans[..., 1] * SPAN_COLS, max=W)
            - spans[..., 0] * SPAN_COLS).clamp(min=0)
    return (cols.long() * rows).sum()


def span_elements(band, spans):
    """The band elements inside the column spans: what a kernel streams
    of the band (``band.numel()`` with full spans)."""
    return int(_span_elements(band, spans))


def band_order(spans, W):
    """(T * nrb,) int32 on the spans' device: the band's span blocks
    (t * nrb + row block) in the f32 kernels' work order, the most
    sub-boxes first, ties in index order.  A few device operations, no
    host sync."""
    nk = (spans[..., 1].clamp(max=-(-W // SPAN_COLS))
          - spans[..., 0].clamp(min=0)).clamp(min=0).reshape(-1)
    return torch.argsort(nk, descending=True, stable=True).to(torch.int32)


def band_items(spans, W, offs=None):
    """(T * nrb, 4) int32 on the spans' device: the f32 kernels' bound work
    list, one record per span block in ``band_order``: the block
    t * nrb + row block, its span [lo, hi) in sub-boxes, and kernel B's
    window start offs[t] (0 for kernel A)."""
    order = band_order(spans, W)
    nrb = spans.shape[1]
    off = (torch.zeros_like(order) if offs is None
           else offs[order.long() // nrb])
    return torch.cat([order[:, None], spans.reshape(-1, 2)[order.long()],
                      off[:, None]], 1).to(torch.int32).contiguous()


def work_list(spans, W, offs=None):
    """``band_items(spans, W, offs)``, kept on the spans tensor: binding
    the band again (the free functions bind for each call) reuses it
    until spans or offs change in place or another W or offs comes."""
    memo = getattr(spans, "_feu_work_list", None)
    if (memo is None or memo[0] != W or memo[1] is not offs
            or memo[2] != spans._version
            or (offs is not None and memo[3] != offs._version)):
        memo = (W, offs, spans._version,
                None if offs is None else offs._version,
                band_items(spans, W, offs))
        spans._feu_work_list = memo
    return memo[4]


def box_rows(R):
    """Rows of the f32 kernels' band boxes: a band of R <= 16 rows takes
    16-row boxes (the graded mid restriction's R = 8), others 64 (one span
    block)."""
    return 16 if R <= 16 else SPAN_ROWS


def chunk_subs(R, B, blocks):
    """Sub-boxes per ring stage of the f32 kernels at R rows, B columns and
    ``blocks`` span blocks: the 16-row boxes take 8 (256 columns) up to 4
    columns and 2 above; the 64-row boxes 1 up to 48 columns (small
    stages fit more CTAs on an SM) but 2 up to 4 columns on bands of
    fewer than 1,000 blocks (few CTAs: wider chunks), and 2 above 48
    columns (the fastest of a grid of widths and depths on an H100)."""
    b = min(B, MAX_COLS)
    if R <= 16:
        return 8 if b <= 4 else 2
    if b <= 4:
        return 2 if blocks < 1000 else 1
    return 1 if b <= 48 else 2


def ring_stages(R, B, blocks):
    """Ring stages of the f32 kernels at R rows, B columns and ``blocks``
    span blocks: 4 for the 16-row boxes; for the 64-row boxes 3 up to 4
    columns, 2 above 48, and between them 2 on bands of 1,000 blocks and
    more (their items fill the card: smaller rings fit more CTAs on an
    SM) and 3 on smaller ones (few CTAs: a deeper ring keeps more bytes
    in flight each) (as ``chunk_subs``, the fastest on an H100)."""
    if R <= 16:
        return 4
    b = min(B, MAX_COLS)
    if b <= 4:
        return 3
    if b > 48:
        return 2
    return 2 if blocks >= 1000 else 3


def _check_spans(name, band, spans, dev):
    T, R, _ = band.shape
    shape = (T, -(-R // SPAN_ROWS), 2)
    if spans is None:
        raise ValueError(f"{name} on a CUDA tensor needs the band's spans "
                         "(band_spans)")
    if spans.dtype != torch.int32 or tuple(spans.shape) != shape:
        raise ValueError(f"{name}: spans must be {shape} int32, got "
                         f"{tuple(spans.shape)} {spans.dtype}")
    if spans.device != dev or not spans.is_contiguous():
        raise ValueError(f"{name}: spans must be contiguous on X's device")


# ---------------------------------------------------------------------------
# kernel A's packed form: the band's nonzeros alone
# ---------------------------------------------------------------------------

# rows of one slice of the packed form (csrc/band_packed.cu kSlice): a warp
PACK_ROWS = 32
# band elements a packing step scans at once (its transient int32 ranks)
_PACK_STEP = 1 << 26


class PackedBand(NamedTuple):
    """Kernel A's packed f32 form of a (T, R, W) band (sliced ELL).

    The rows (t * R + r) go in slices of ``PACK_ROWS``; slice s holds
    k_s slots a row, k_s its longest row's nonzeros, slot-major (slot j
    of row s * PACK_ROWS + i at ``offs[s] + j * PACK_ROWS + i``), so
    that a warp's loads of one slot are one coalesced run.  A row's
    entries are its nonzeros in ascending window column w, then padding:
    value 0 at the row's own column (w = halo * R + r)."""
    vals: torch.Tensor      # (slots,) f32
    cols: torch.Tensor      # (slots,) w: uint16 bits in int16 (W <= 65,535),
                            # else int32
    offs: torch.Tensor      # (slices + 1,) int32 slot offsets
    entries: int            # the band's nonzeros

    @property
    def slots(self):
        return self.vals.numel()

    def nbytes(self):
        """What the kernel streams of the form: its slots' values and
        columns."""
        return self.slots * (4 + self.cols.element_size())


def _row_counts(band):
    """Nonzeros of each row (T * R,) int32, and each slice's longest
    (slices,) int32."""
    T, R, W = band.shape
    step = max(1, _PACK_STEP // (R * W))
    cnt = torch.cat([(band[t:t + step] != 0).sum(-1, dtype=torch.int32)
                     .reshape(-1) for t in range(0, T, step)])
    ns = -(-T * R // PACK_ROWS)
    k = F.pad(cnt, (0, ns * PACK_ROWS - T * R)).reshape(ns, PACK_ROWS)
    return cnt, k.amax(1)


def _pack(band, k, kmax, slots, entries):
    """The packed form from the slices' slot counts k (``_row_counts``),
    the longest row kmax and the slots: no host sync.  Row i's j-th
    entry is at the first w where its running count of nonzeros reaches
    j (``searchsorted``); past its count the search gives W, padding."""
    T, R, W = band.shape
    dev = band.device
    ns = k.numel()
    npad = ns * PACK_ROWS
    halo = (W // R - 1) // 2
    pos = torch.full((npad, kmax), W, dtype=torch.int32, device=dev)
    vals = torch.zeros((npad, kmax), dtype=torch.float32, device=dev)
    if kmax:
        step = max(1, _PACK_STEP // (R * W))
        j = torch.arange(1, kmax + 1, dtype=torch.int32, device=dev)
        for t in range(0, T, step):
            rank = (band[t:t + step] != 0).reshape(-1, W).cumsum(
                1, dtype=torch.int32)
            at = torch.searchsorted(rank, j.expand(len(rank), kmax)
                                    .contiguous(), out_int32=True)
            rows = slice(t * R, t * R + len(rank))
            pos[rows] = at
            live, at = at < W, at.clamp(max=W - 1).long()
            vals[rows] = torch.where(
                live, band[t:t + step].reshape(-1, W).gather(1, at), 0.0)
    own = (halo * R + torch.arange(npad, device=dev) % R).to(torch.int32)
    cols = torch.where(pos < W, pos, own[:, None])
    if W <= 65535:                      # uint16 bits in an int16 tensor
        cols = torch.where(cols > 32767, cols - 65536, cols).to(torch.int16)
    # slot-major slices, each cut to its own k_s slots a row
    offs = F.pad(torch.cumsum(k * PACK_ROWS, 0), (1, 0)).to(torch.int32)
    m = slots // PACK_ROWS
    s = torch.repeat_interleave(torch.arange(ns, device=dev), k,
                                output_size=m)
    src = s * kmax + torch.arange(m, device=dev) - (offs[:-1] // PACK_ROWS)[s]

    def slot_major(a):
        a = a.reshape(ns, PACK_ROWS, kmax).transpose(1, 2)
        return a.reshape(ns * kmax, PACK_ROWS)[src].reshape(-1)
    return PackedBand(slot_major(vals), slot_major(cols), offs, entries)


def _sizes(band, spans):
    """(each slice's slots a row, the entries, the slots, the longest
    row, the span elements): one host sync."""
    cnt, k = _row_counts(band)
    sp = (_span_elements(band, spans) if spans is not None
          else torch.zeros((), dtype=torch.long, device=band.device))
    entries, slots, kmax, span_el = torch.stack(
        [cnt.sum().long(), k.sum().long() * PACK_ROWS, k.max().long(),
         sp]).tolist()
    return k, entries, slots, kmax, span_el


def band_pack(band):
    """The packed form of an f32 (T, R, W) band (:class:`PackedBand`), on
    the band's device: a few device operations and one host sync (the
    slots)."""
    k, entries, slots, kmax, _ = _sizes(band, None)
    return _pack(band, k, kmax, slots, entries)


def band_form(band, spans):
    """The form kernel A binds for an f32 band and its spans: the
    :class:`PackedBand` where its bytes (slots x (4 + column bytes)) are
    below the span form's (``span_elements`` x 4), else None (the span
    form).  One host sync, then, for the packed form, a few device
    operations; the result is kept on the band until it or the spans
    change.  Each call is one bind, counted in ``utils.profiling``:
    ``band_packed_binds`` or ``band_span_binds``, and the packed form's
    ``band_packed_entries`` and ``band_packed_slots``."""
    memo = getattr(band, "_feu_band_form", None)
    if (memo is None or memo[0] != band._version or memo[1] is not spans
            or memo[2] != spans._version):
        k, entries, slots, kmax, span_el = _sizes(band, spans)
        per = 4 + (2 if band.shape[2] <= 65535 else 4)
        packed = None
        if slots * per < span_el * 4 and slots < 2 ** 31:   # int32 offs
            packed = _pack(band, k, kmax, slots, entries)
        memo = (band._version, spans, spans._version, packed)
        band._feu_band_form = memo
    packed = memo[3]
    if packed is None:
        profiling.band_span_binds += 1
    else:
        profiling.band_packed_binds += 1
        profiling.band_packed_entries += packed.entries
        profiling.band_packed_slots += packed.slots
    return packed


# ---------------------------------------------------------------------------
# kernel A: square band
# ---------------------------------------------------------------------------

def band_apply_plain(band, X, coef=None):
    """Plain PyTorch kernel A: unfold the zero-padded X windows, einsum.
    A bf16 band: X rounded to bf16, both upcast, the f32 einsum, the coef
    product in f32, one rounding to X's dtype."""
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    n, B = X.shape
    Xp = F.pad(X.to(band.dtype), (0, 0, halo * R, halo * R))
    if band.dtype == torch.bfloat16:
        win = Xp.float().unfold(0, W, R)
        Y = torch.einsum("trw,tbw->trb", band.float(), win).reshape(n, B)
        if coef is not None:
            Y = Y * coef.float()
        return Y.to(X.dtype)
    win = Xp.unfold(0, W, R)                           # (T, B, W)
    Y = torch.einsum("trw,tbw->trb", band, win).reshape(n, B).to(X.dtype)
    if coef is not None:
        Y = Y * coef.to(X.dtype)
    return Y


# the (band, X) dtypes each kernel takes; Y, and A's coef, have X's
_F32, _BF16 = torch.float32, torch.bfloat16
BAND_APPLY_DTYPES = ((_F32, _F32), (_BF16, _BF16))
RECT_BAND_APPLY_DTYPES = ((_F32, _F32), (_BF16, _F32), (_BF16, _BF16))


def _check_dtypes(name, band, X, allowed):
    if (band.dtype, X.dtype) not in allowed:
        raise TypeError(
            f"{name} kernel takes (band, X) in one of "
            f"{[tuple(str(d) for d in p) for p in allowed]}, got "
            f"{band.dtype}, {X.dtype}")


def _check_cuda(name, band, ts, dev):
    per = 16 // band.element_size()
    if band.shape[2] % per or band.data_ptr() % 16:
        raise ValueError(f"{name} needs W % {per} == 0 and a 16-byte aligned "
                         f"band (it is copied {per} values at a time)")
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs every tensor on X's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def check_band_apply_args(band, X, coef=None, spans=None):
    """Raise unless kernel A can take these arguments as they are."""
    _check_dtypes("band_apply", band, X, BAND_APPLY_DTYPES)
    if band.dim() != 3 or X.dim() != 2:
        raise ValueError("band must be (T, R, W) and X (n, B)")
    T, R, W = band.shape
    if W % R or (W // R) % 2 != 1:
        raise ValueError(f"W={W} is not (2*halo+1)*R for R={R}")
    if X.shape[0] != T * R:
        raise ValueError(f"X has {X.shape[0]} rows, band covers {T * R}")
    if X.shape[1] < 1:
        raise ValueError(f"B={X.shape[1]}: X needs at least one column")
    ts = [band, X]
    if coef is not None:
        if coef.dtype != X.dtype or tuple(coef.shape) != (X.shape[1],):
            raise ValueError("coef must be (B,) of X's dtype")
        ts.append(coef)
    _check_cuda("band_apply", band, ts, X.device)
    _check_spans("band_apply", band, spans, X.device)


def band_apply(band, X, coef=None, spans=None):
    """Kernel A: Y = A @ X from the (T, R, W) band, ``coef`` (B,) fused.
    ``spans`` (``band_spans(band)``, or of the f32 band a bf16 one was
    rounded from) is required on CUDA tensors; the plain version ignores
    it.  f32 operands, or band, X and coef all bf16 (f32 sums, Y bf16).
    The kernel bound for this one call (:class:`BandKernel`).
    ``band_apply.launches`` counts the launches of kernel A,
    bound or not, ``.launches_bf16`` those of the bf16 form and
    ``.launches_packed`` those of the packed f32 form among them."""
    if X.device.type == "cpu":
        return band_apply_plain(band, X, coef)
    check_band_apply_args(band, X, coef, spans)
    return BandKernel(band, spans)(X, coef)


band_apply.launches = 0
band_apply.launches_bf16 = 0
band_apply.launches_packed = 0


# ---------------------------------------------------------------------------
# kernel B: rectangular windowed band (MG transfers)
# ---------------------------------------------------------------------------

def rect_band_apply_plain(band, offs, Xp):
    """Plain PyTorch kernel B: index the windows, einsum.  A bf16 band: Xp
    rounded to bf16, both upcast, the f32 einsum, one rounding to Xp's
    dtype."""
    T, R, W = band.shape
    idx = offs.long()[:, None] + torch.arange(W, device=Xp.device)
    win = Xp.to(band.dtype)[idx]                       # (T, W, B)
    if band.dtype == torch.bfloat16:
        band, win = band.float(), win.float()
    Y = torch.einsum("trw,twb->trb", band, win)
    return Y.reshape(T * R, Xp.shape[1]).to(Xp.dtype)


def check_rect_band_apply_args(band, offs, Xp, spans=None):
    """Raise unless kernel B can take these arguments as they are."""
    _check_dtypes("rect_band_apply", band, Xp, RECT_BAND_APPLY_DTYPES)
    if band.dim() != 3 or Xp.dim() != 2:
        raise ValueError("band must be (T, R, W) and Xp (n, B)")
    T = band.shape[0]
    if offs.dtype != torch.int32 or tuple(offs.shape) != (T,):
        raise ValueError("offs must be (T,) int32")
    if Xp.shape[1] < 1:
        raise ValueError(f"B={Xp.shape[1]}: Xp needs at least one column")
    _check_cuda("rect_band_apply", band, [band, offs, Xp], Xp.device)
    _check_spans("rect_band_apply", band, spans, Xp.device)


def rect_band_apply(band, offs, Xp, spans=None):
    """Kernel B: Y (T*R, B) = rect_band @ Xp; Xp zero-padded by the caller
    to the plan's ``n_cols_pad`` rows.  ``spans`` (``band_spans(band)``, or
    of the f32 band a bf16 one was rounded from) is required on CUDA
    tensors; the plain version ignores it.  f32 operands; a bf16 band with
    f32 Xp (rounded to bf16 as it is read; Y f32); or band and Xp in bf16
    (Y bf16); f32 sums in each.  The kernel bound for this one call
    (:class:`RectBandKernel`).
    ``rect_band_apply.launches`` counts the launches of kernel B, bound or
    not, ``.launches_bf16_band`` those with a bf16 band and f32 Xp and
    ``.launches_bf16`` those all in bf16 among them."""
    if Xp.device.type == "cpu":
        return rect_band_apply_plain(band, offs, Xp)
    check_rect_band_apply_args(band, offs, Xp, spans)
    return RectBandKernel(band, offs, spans)(Xp)


rect_band_apply.launches = 0
rect_band_apply.launches_bf16 = 0
rect_band_apply.launches_bf16_band = 0

# launches of kernels A and B by (kernel, band dtype, T, R, W, B): which
# bands and widths a path runs the kernels at (the counters above sum them)
launches_by_band = collections.Counter()


# ---------------------------------------------------------------------------
# the bound forms
# ---------------------------------------------------------------------------

class _BandStruct(ctypes.Structure):
    """csrc/band_f32.cu ``BandPlan``: one bound f32 band."""
    _fields_ = ([("map", ctypes.c_ulonglong * 16)]
                + [(n, ctypes.c_void_p) for n in ("band", "items", "offs")]
                + [(n, ctypes.c_int) for n in ("T", "R", "W", "halo", "rb")])


class _PackedStruct(ctypes.Structure):
    """csrc/band_packed.cu ``PackedPlan``: one bound packed band."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("vals", "cols", "offs")]
                + [("n", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("ns", "R", "halo", "wide")])


def _packed_struct(band, pk):
    T, R, W = band.shape
    return _PackedStruct(
        vals=pk.vals.data_ptr(), cols=pk.cols.data_ptr(),
        offs=pk.offs.data_ptr(), n=T * R, ns=pk.offs.numel() - 1, R=R,
        halo=(W // R - 1) // 2, wide=int(pk.cols.dtype == torch.int32))


class _Bound:
    """What kernels A and B share: the band and its spans, checked once;
    an f32 band's work list (``work_list``) and tensor map
    (``csrc/band_f32.cu`` ``feu_band_bind``, which raises through
    ``_build.check`` where the map does not encode)."""

    __slots__ = ("band", "spans", "offs", "items", "device", "_plan",
                 "_addr", "_launch", "_index", "_key")
    name = ""

    def __init__(self, band, spans, offs, halo):
        if band.dim() != 3:
            raise ValueError(f"{self.name}: band must be (T, R, W), got "
                             f"{tuple(band.shape)}")
        if band.dtype not in (_F32, _BF16):
            raise TypeError(f"{self.name}: the band must be f32 or bf16, "
                            f"got {band.dtype}")
        self.band, self.spans, self.offs = band, spans, offs
        self.device = band.device
        self._key = (self.name, str(band.dtype), *band.shape)
        self.items = self._plan = None
        self._addr = self._launch = None
        self._index = band.device.index
        if band.device.type != "cuda":
            return
        T, R, W = band.shape
        _check_cuda(self.name, band,
                    [band] + ([] if offs is None else [offs]), band.device)
        _check_spans(self.name, band, spans, band.device)
        if band.dtype == _F32:
            self._bind_f32(halo)

    def _bind_f32(self, halo):
        """The span form: the work list and the tensor map."""
        band, spans, offs = self.band, self.spans, self.offs
        T, R, W = band.shape
        self.items = work_list(spans, W, offs)
        self._plan = _BandStruct(
            band=band.data_ptr(), items=self.items.data_ptr(),
            offs=None if offs is None else offs.data_ptr(),
            T=T, R=R, W=W, halo=halo, rb=box_rows(R))
        self._addr = ctypes.addressof(self._plan)
        lib = _build.library()
        _build.check(lib.feu_band_bind(self._addr), f"{self.name} bind")
        self._launch = lib.feu_band_launch

    def _check_x(self, X, allowed):
        _check_dtypes(self.name, self.band, X, allowed)
        if X.dim() != 2 or X.shape[1] < 1:
            raise ValueError(f"{self.name}: X must be (n, B) with B >= 1, "
                             f"got {tuple(X.shape)}")
        if X.device != self.device:
            raise ValueError(f"{self.name} needs X on the band's device "
                             f"{self.device}, got {X.device}")
        if not X.is_contiguous():
            raise ValueError(f"{self.name} needs a contiguous X")

    def _run(self, X, n, coef, Y):
        T, R, W = self.band.shape
        B = X.shape[1]
        blocks = T * -(-R // SPAN_ROWS)
        err = self._launch(self._addr, X.data_ptr(), n,
                           None if coef is None else coef.data_ptr(),
                           Y.data_ptr(), B, chunk_subs(R, B, blocks),
                           ring_stages(R, B, blocks),
                           _build.raw_stream(self._index))
        if err:
            _build.check(err, self.name)

    def __eq__(self, other):
        # the same kernel: one class, equal band, spans and offs
        if type(other) is not type(self):
            return NotImplemented
        return all(
            (a is None and b is None) or (
                a is not None and b is not None and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
            for a, b in ((self.band, other.band),
                         (self.spans, other.spans),
                         (self.offs, other.offs)))

    __hash__ = None


class BandKernel(_Bound):
    """Kernel A bound to one (T, R, W) band, f32 or bf16, and its spans
    (``band_spans``, or of the f32 band a bf16 one was rounded from).

    The band and spans are checked here, once.  An f32 band on the card
    binds the form of fewer bytes (``band_form``): its packed form
    (``packed``, ``csrc/band_packed.cu``), or the span form with its work
    list (``work_list``: ``band_items``, the most sub-boxes first) and
    its tensor map; the two give the same bits.  Neither band nor spans
    may change after.  ``kernel(X, coef)`` checks X and coef (dtype,
    shape, device, contiguity) and launches on the current stream: Y =
    coef * (A @ X).  A CPU X takes ``band_apply_plain``.  Launches count
    in ``band_apply.launches`` (and ``.launches_bf16``,
    ``.launches_packed``)."""

    __slots__ = ("packed",)
    name = "band_apply"

    def __init__(self, band, spans):
        if band.dim() == 3:
            T, R, W = band.shape
            if W % R or (W // R) % 2 != 1:
                raise ValueError(f"W={W} is not (2*halo+1)*R for R={R}")
            halo = (W // R - 1) // 2
        else:
            halo = 0
        self.packed = None
        super().__init__(band, spans, None, halo)

    def _bind_f32(self, halo):
        self.packed = band_form(self.band, self.spans)
        if self.packed is None:
            super()._bind_f32(halo)
            return
        self._plan = _packed_struct(self.band, self.packed)
        self._addr = ctypes.addressof(self._plan)
        self._launch = _build.library().feu_band_packed_launch

    def check(self, X, coef=None):
        """Raise unless the kernel can take X and coef as they are."""
        self._check_x(X, BAND_APPLY_DTYPES)
        T, R, W = self.band.shape
        if X.shape[0] != T * R:
            raise ValueError(f"X has {X.shape[0]} rows, band covers {T * R}")
        if coef is not None and (
                coef.dtype != X.dtype or tuple(coef.shape) != (X.shape[1],)
                or coef.device != X.device or not coef.is_contiguous()):
            raise ValueError("coef must be (B,) of X's dtype, contiguous "
                             "on X's device")

    def __call__(self, X, coef=None):
        if X.device.type == "cpu":
            return band_apply_plain(self.band, X, coef)
        self.check(X, coef)
        T, R, W = self.band.shape
        n, B = X.shape
        Y = torch.empty_like(X)
        if self.packed is not None:
            err = self._launch(self._addr, X.data_ptr(),
                               None if coef is None else coef.data_ptr(),
                               Y.data_ptr(), B,
                               _build.raw_stream(self._index))
            if err:
                _build.check(err, self.name)
            band_apply.launches_packed += 1
        elif self._launch is not None:
            self._run(X, n, coef, Y)
        else:
            err = _build.library().feu_band_apply_bf16(
                self.band.data_ptr(), self.spans.data_ptr(), X.data_ptr(),
                None if coef is None else coef.data_ptr(), Y.data_ptr(),
                T, R, W, B, _build.raw_stream(self._index))
            _build.check(err, self.name)
            band_apply.launches_bf16 += 1
        band_apply.launches += 1
        launches_by_band[self._key + (B,)] += 1
        return Y


class _SpanBandKernel(BandKernel):
    """Kernel A bound to the span form whatever ``band_form`` picks: the
    form the packed one is held to (tests, ``chip_smoke.py``)."""

    __slots__ = ()

    def _bind_f32(self, halo):
        profiling.band_span_binds += 1
        _Bound._bind_f32(self, halo)


class RectBandKernel(_Bound):
    """Kernel B bound to one (T, R, W) transfer band (f32 or bf16), its
    window starts ``offs`` (T,) int32 and its spans, checked once, as
    :class:`BandKernel`.  ``kernel(Xp)``: Y (T*R, B) = rect_band @ Xp for
    Xp of any number of rows (windows past its end read zeros); an f32
    band takes f32 Xp, a bf16 band f32 or bf16 Xp.  A CPU Xp takes
    ``rect_band_apply_plain``.  Launches count in
    ``rect_band_apply.launches`` (and its bf16 counters)."""

    __slots__ = ()
    name = "rect_band_apply"

    def __init__(self, band, offs, spans):
        if band.dim() == 3 and (offs.dtype != torch.int32
                                or tuple(offs.shape) != (band.shape[0],)):
            raise ValueError("offs must be (T,) int32")
        super().__init__(band, spans, offs, 0)

    def check(self, Xp):
        """Raise unless the kernel can take Xp as it is."""
        self._check_x(Xp, RECT_BAND_APPLY_DTYPES)

    def __call__(self, Xp):
        if Xp.device.type == "cpu":
            return rect_band_apply_plain(self.band, self.offs, Xp)
        self.check(Xp)
        T, R, W = self.band.shape
        n, B = Xp.shape
        Y = torch.empty((T * R, B), dtype=Xp.dtype, device=Xp.device)
        if self._launch is not None:
            self._run(Xp, n, None, Y)
        else:
            x_bf16 = Xp.dtype == _BF16
            err = _build.library().feu_rect_band_apply_bf16(
                self.band.data_ptr(), self.spans.data_ptr(),
                self.offs.data_ptr(), Xp.data_ptr(), Y.data_ptr(), T, R, W,
                n, B, int(x_bf16), _build.raw_stream(self._index))
            _build.check(err, self.name)
            rect_band_apply.launches_bf16 += x_bf16
            rect_band_apply.launches_bf16_band += not x_bf16
        rect_band_apply.launches += 1
        launches_by_band[self._key + (B,)] += 1
        return Y
