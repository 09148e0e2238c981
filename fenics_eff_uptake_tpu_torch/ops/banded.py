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
           "rect_band_apply_plain", "check_rect_band_apply_args"]

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
    """Plain PyTorch kernel A: unfold the zero-padded X windows, einsum."""
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    n, B = X.shape
    Xp = F.pad(X.to(band.dtype), (0, 0, halo * R, halo * R))
    win = Xp.unfold(0, W, R)                           # (T, B, W)
    Y = torch.einsum("trw,tbw->trb", band, win).reshape(n, B).to(X.dtype)
    if coef is not None:
        Y = Y * coef.to(X.dtype)
    return Y


def _check_cuda_f32(name, band, ts, dev):
    if band.shape[2] % 4 or band.data_ptr() % 16:
        raise ValueError(f"{name} needs W % 4 == 0 and a 16-byte aligned "
                         "band (it is read as float4)")
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} needs every tensor on X's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def check_band_apply_args(band, X, coef=None, spans=None):
    """Raise unless kernel A can take these arguments as they are."""
    if band.dtype != torch.float32 or X.dtype != torch.float32:
        raise TypeError(f"band_apply kernel takes f32 band and X, got "
                        f"{band.dtype}, {X.dtype}")
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
        if coef.dtype != torch.float32 or tuple(coef.shape) != (X.shape[1],):
            raise ValueError("coef must be (B,) f32")
        ts.append(coef)
    _check_cuda_f32("band_apply", band, ts, X.device)
    _check_spans("band_apply", band, spans, X.device)


def band_apply(band, X, coef=None, spans=None):
    """Kernel A: Y = A @ X from the (T, R, W) band, ``coef`` (B,) fused.
    ``spans`` (``band_spans(band)``) is required on CUDA tensors; the plain
    version ignores it."""
    if X.device.type == "cpu":
        return band_apply_plain(band, X, coef)
    check_band_apply_args(band, X, coef, spans)
    T, R, W = band.shape
    Y = torch.empty_like(X)
    err = _build.library().feu_band_apply(
        band.data_ptr(), spans.data_ptr(), X.data_ptr(),
        None if coef is None else coef.data_ptr(), Y.data_ptr(),
        T, R, W, X.shape[1], _build.raw_stream(X.device.index))
    _build.check(err, "band_apply")
    band_apply.launches += 1
    return Y


band_apply.launches = 0


# ---------------------------------------------------------------------------
# kernel B: rectangular windowed band (MG transfers)
# ---------------------------------------------------------------------------

def rect_band_apply_plain(band, offs, Xp):
    """Plain PyTorch kernel B: index the windows, einsum."""
    T, R, W = band.shape
    idx = offs.long()[:, None] + torch.arange(W, device=Xp.device)
    win = Xp.to(band.dtype)[idx]                       # (T, W, B)
    Y = torch.einsum("trw,twb->trb", band, win)
    return Y.reshape(T * R, Xp.shape[1]).to(Xp.dtype)


def check_rect_band_apply_args(band, offs, Xp, spans=None):
    """Raise unless kernel B can take these arguments as they are."""
    if band.dtype != torch.float32 or Xp.dtype != torch.float32:
        raise TypeError(f"rect_band_apply kernel takes f32 band and X, got "
                        f"{band.dtype}, {Xp.dtype}")
    if band.dim() != 3 or Xp.dim() != 2:
        raise ValueError("band must be (T, R, W) and Xp (n, B)")
    T = band.shape[0]
    if offs.dtype != torch.int32 or tuple(offs.shape) != (T,):
        raise ValueError("offs must be (T,) int32")
    if Xp.shape[1] < 1:
        raise ValueError(f"B={Xp.shape[1]}: Xp needs at least one column")
    _check_cuda_f32("rect_band_apply", band, [band, offs, Xp], Xp.device)
    _check_spans("rect_band_apply", band, spans, Xp.device)


def rect_band_apply(band, offs, Xp, spans=None):
    """Kernel B: Y (T*R, B) = rect_band @ Xp; Xp zero-padded by the caller
    to the plan's ``n_cols_pad`` rows.  ``spans`` (``band_spans(band)``) is
    required on CUDA tensors; the plain version ignores it."""
    if Xp.device.type == "cpu":
        return rect_band_apply_plain(band, offs, Xp)
    check_rect_band_apply_args(band, offs, Xp, spans)
    T, R, W = band.shape
    Y = torch.empty((T * R, Xp.shape[1]), dtype=Xp.dtype, device=Xp.device)
    err = _build.library().feu_rect_band_apply(
        band.data_ptr(), spans.data_ptr(), offs.data_ptr(), Xp.data_ptr(),
        Y.data_ptr(), T, R, W, Xp.shape[0], Xp.shape[1],
        _build.raw_stream(Xp.device.index))
    _build.check(err, "rect_band_apply")
    rect_band_apply.launches += 1
    return Y


rect_band_apply.launches = 0
