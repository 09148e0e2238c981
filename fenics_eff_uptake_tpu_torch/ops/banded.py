"""Banded-dense operator forms (counterpart of ``ops/banded.py``) and
kernels A and B.

After a bandwidth-reducing dof ordering, the assembled operator fits a
block band of row tiles:

    band[t, r, w] = A[t*R + r, (t - halo)*R + w],   W = (2*halo + 1)*R

and a multigrid transfer (restriction or prolongation) a windowed band
whose window start is per-tile data:

    band[t, r, w] = P[t*R + r, offs[t] + w]

:func:`band_apply` (kernel A) and :func:`rect_band_apply` (kernel B)
dispatch on the device of X: CPU tensors take the plain PyTorch versions,
CUDA tensors the kernels of ``csrc/band_apply.cu`` (or raise).  The band
values are scattered on the band's device by the deterministic
``planned_segment_sum``.  Host plans live in ``ops/band_plans.py``.

Less than half of a band holds anything.  :func:`band_spans` records, for
each block of ``SPAN_ROWS`` band rows, the range of ``SPAN_COLS``-column
chunks that holds all of its nonzeros; it is computed once where each band
is made and carried beside it, and the kernels stream only those chunks.
Every skipped term is ``fmaf(0, x, acc) == acc``, so for finite X the
result equals the full-width sum bit for bit.

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

import torch
import torch.nn.functional as F

from . import _build
from .band_plans import BandPlan, RectBandPlan
from .elemspmv import make_segment_plan, planned_segment_sum

__all__ = ["band_from_elements", "rect_band_values", "band_spans",
           "SPAN_ROWS", "SPAN_COLS", "band_apply", "band_apply_plain",
           "check_band_apply_args", "rect_band_apply",
           "rect_band_apply_plain", "check_rect_band_apply_args",
           "BAND_APPLY_DTYPES", "RECT_BAND_APPLY_DTYPES"]

# the kernels' row block and column chunk (csrc/band_apply.cu kRows, kK)
SPAN_ROWS = 64
SPAN_COLS = 32


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
    ``band_apply.launches`` counts the launches, ``.launches_bf16`` those
    of the bf16 form among them."""
    if X.device.type == "cpu":
        return band_apply_plain(band, X, coef)
    check_band_apply_args(band, X, coef, spans)
    T, R, W = band.shape
    Y = torch.empty_like(X)
    bf16 = band.dtype == torch.bfloat16
    lib = _build.library()
    err = (lib.feu_band_apply_bf16 if bf16 else lib.feu_band_apply)(
        band.data_ptr(), spans.data_ptr(), X.data_ptr(),
        None if coef is None else coef.data_ptr(), Y.data_ptr(),
        T, R, W, X.shape[1], _build.raw_stream(X.device.index))
    _build.check(err, "band_apply")
    band_apply.launches += 1
    band_apply.launches_bf16 += bf16
    return Y


band_apply.launches = 0
band_apply.launches_bf16 = 0


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
    (Y bf16); f32 sums in each.  ``rect_band_apply.launches`` counts the
    launches, ``.launches_bf16_band`` those with a bf16 band and f32 Xp
    and ``.launches_bf16`` those all in bf16 among them."""
    if Xp.device.type == "cpu":
        return rect_band_apply_plain(band, offs, Xp)
    check_rect_band_apply_args(band, offs, Xp, spans)
    T, R, W = band.shape
    Y = torch.empty((T * R, Xp.shape[1]), dtype=Xp.dtype, device=Xp.device)
    lib = _build.library()
    stream = _build.raw_stream(Xp.device.index)
    bf16_band = band.dtype == torch.bfloat16
    x_bf16 = Xp.dtype == torch.bfloat16
    if bf16_band:
        err = lib.feu_rect_band_apply_bf16(
            band.data_ptr(), spans.data_ptr(), offs.data_ptr(),
            Xp.data_ptr(), Y.data_ptr(), T, R, W, Xp.shape[0], Xp.shape[1],
            int(x_bf16), stream)
    else:
        err = lib.feu_rect_band_apply(
            band.data_ptr(), spans.data_ptr(), offs.data_ptr(),
            Xp.data_ptr(), Y.data_ptr(), T, R, W, Xp.shape[0], Xp.shape[1],
            stream)
    _build.check(err, "rect_band_apply")
    rect_band_apply.launches += 1
    rect_band_apply.launches_bf16 += bf16_band and x_bf16
    rect_band_apply.launches_bf16_band += bf16_band and not x_bf16
    return Y


rect_band_apply.launches = 0
rect_band_apply.launches_bf16 = 0
rect_band_apply.launches_bf16_band = 0
