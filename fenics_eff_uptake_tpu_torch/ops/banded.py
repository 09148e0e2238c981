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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .band_plans import BandPlan, RectBandPlan
from .elemspmv import make_segment_plan, planned_segment_sum

__all__ = ["band_from_elements", "rect_band_values", "band_apply",
           "band_apply_plain", "check_band_apply_args", "rect_band_apply",
           "rect_band_apply_plain", "check_rect_band_apply_args"]


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


def check_band_apply_args(band, X, coef=None):
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


def band_apply(band, X, coef=None):
    """Kernel A: Y = A @ X from the (T, R, W) band, ``coef`` (B,) fused."""
    if X.device.type == "cpu":
        return band_apply_plain(band, X, coef)
    check_band_apply_args(band, X, coef)
    T, R, W = band.shape
    Y = torch.empty_like(X)
    err = _build.library().feu_band_apply(
        band.data_ptr(), X.data_ptr(),
        None if coef is None else coef.data_ptr(), Y.data_ptr(),
        T, R, W, X.shape[1], _build.stream_of(X))
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


def check_rect_band_apply_args(band, offs, Xp):
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


def rect_band_apply(band, offs, Xp):
    """Kernel B: Y (T*R, B) = rect_band @ Xp; Xp zero-padded by the caller
    to the plan's ``n_cols_pad`` rows."""
    if Xp.device.type == "cpu":
        return rect_band_apply_plain(band, offs, Xp)
    check_rect_band_apply_args(band, offs, Xp)
    T, R, W = band.shape
    Y = torch.empty((T * R, Xp.shape[1]), dtype=Xp.dtype, device=Xp.device)
    err = _build.library().feu_rect_band_apply(
        band.data_ptr(), offs.data_ptr(), Xp.data_ptr(), Y.data_ptr(),
        T, R, W, Xp.shape[0], Xp.shape[1], _build.stream_of(Xp))
    _build.check(err, "rect_band_apply")
    rect_band_apply.launches += 1
    return Y


rect_band_apply.launches = 0
