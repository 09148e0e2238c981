"""The least device time a batched transport solve needs, from the problem.

A frozen copy of the port's cost arithmetic (``utils/roofline.py``:
``_band_cost``, ``_elem_cost``, ``ml_cg_iteration_cost``), kept here so that
a change to the program cannot change the yardstick, and extended to the
BiCGStab iteration.  It counts the least work, where the port counts its
kernels' traffic:

* a band counts its nonzero entries, the operator itself, where the port
  counts the dense band T x R x W (kernel A reads only the band's column
  spans: its fine-K apply at B = 20 takes 0.1008 ms against a dense-band
  bound of 0.1618 ms, so a dense count would read above 100%);
* each input is read once and each output written once: X in and Y out
  per apply (the port: three (n, B) streams), and per Krylov iteration the
  state read and written (x, r, p for CG; x, r, p, v and the shadow
  residual for BiCGStab; the port: 13 streams).

Peaks: NVIDIA's H100 SXM data sheet (dense rates, 700 W).
"""

from __future__ import annotations

import torch

__all__ = ["PEAKS", "chip_peaks", "iteration_cost", "solve_cost",
           "bound_seconds"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "f64_tflops": 34.0, "bf16_tflops": 989.0},
}

F32, F64 = 4, 8
# the (n, B) Krylov state each iteration reads and writes once
VEC_STREAMS = {"cg": 6.0, "bicgstab": 9.0}
# operator applies and preconditioner cycles per iteration
APPLIES = {"cg": 1, "bicgstab": 2}


def chip_peaks(kind):
    """The peaks of the card named ``kind``; raises for a card without a
    row (a share of another chip's peaks would mean nothing)."""
    for prefix, row in PEAKS.items():
        if kind.startswith(prefix):
            return row
    raise ValueError(f"no published peaks for {kind!r}")


def _nonzeros(band):
    return int(torch.count_nonzero(band))


def _band_cost(entries, rows, B, dtype_bytes=F32):
    """One banded apply: ``entries`` band entries read once, X in and Y
    out ((rows, B) each), 2 FLOPs per entry and column."""
    flops = 2.0 * entries * B
    bytes_ = entries * dtype_bytes + 2.0 * rows * B * dtype_bytes
    return bytes_, flops


def _elem_cost(A_shape, B, dtype_bytes=F32):
    """Element-path apply: element matrices read once, X gathered and Y
    scattered per element entry."""
    N, nd, _ = [int(s) for s in A_shape]
    flops = 2.0 * N * nd * nd * B
    bytes_ = (N * nd * nd * dtype_bytes
              + 2.0 * N * nd * B * dtype_bytes)
    return bytes_, flops


def _apply_cost(sys_l, B, dtype_bytes=F32):
    """One operator apply of a level: its stiffness band's nonzeros and
    its advection band's, or its element matrices."""
    if sys_l.Kband is None:
        return _elem_cost(sys_l.K.A64.shape, B, dtype_bytes)
    n = _nonzeros(sys_l.Kband)
    if sys_l.Advband is not None:
        n += _nonzeros(sys_l.Advband)
    T, R, _ = sys_l.Kband.shape
    return _band_cost(n, int(T) * int(R), B, dtype_bytes)


def iteration_cost(sys_t, ml, B, krylov, cycle, n_smooth=1):
    """Bytes and FLOPs of ONE preconditioned f32 ``krylov`` ("cg" or
    "bicgstab") iteration under ``cycle``: its fine operator applies and
    multigrid cycles (2 ``n_smooth`` applies per smoothed level, none on a
    level the cycle treats additively; the transfers; the dense coarsest
    solve), and its Krylov state.  Returns the totals and a breakdown by
    component."""
    k = APPLIES[krylov]
    parts = {}
    by, fl = _apply_cost(sys_t, B)
    parts["krylov_apply"] = (k * by, k * fl)

    tb_by = tb_fl = lv_by = lv_fl = 0.0
    for il, lev in enumerate(ml.levels):
        s = lev.sys
        aby, afl = _apply_cost(s, B)
        if cycle == "add" or (cycle == "hybrid" and il == 0):
            aby = afl = 0.0
        lv_by += 2 * n_smooth * aby
        lv_fl += 2 * n_smooth * afl
        if lev.bands is not None:
            for band in (lev.bands.p, lev.bands.r):
                T, R, _ = band.shape
                b2, f2 = _band_cost(_nonzeros(band), int(T) * int(R), B)
                tb_by += b2
                tb_fl += f2
        else:
            n_f = int(s.ndofs)
            tb_by += 2 * (3 * n_f * (4 + F32) + 3 * n_f * B * F32)
            tb_fl += 2 * (2.0 * 3 * n_f * B)
    parts["vcycle_applies"] = (k * lv_by, k * lv_fl)
    parts["vcycle_transfers"] = (k * tb_by, k * tb_fl)

    nc = int(ml.Ainv.shape[-1])
    parts["coarse_dense"] = (k * B * nc * nc * F32, k * 2.0 * B * nc * nc)
    parts["krylov_vectors"] = (
        VEC_STREAMS[krylov] * int(sys_t.ndofs) * B * F32, 0.0)

    return {"bytes_per_iter": sum(b for b, _ in parts.values()),
            "flops_per_iter": sum(f for _, f in parts.values()),
            "breakdown": {k: {"bytes": b, "flops": f}
                          for k, (b, f) in parts.items()}}


def solve_cost(sys_t, ml, B, iters, passes, krylov, cycle, n_smooth=1):
    """The least work of one mixed-precision solve: ``iters`` f32 Krylov
    iterations executed (the batch's most: every column does the work
    while any is active) and ``passes`` f64 defect residuals (one f64
    apply each); ``n_smooth`` as ``solve_sweep``'s.  Returns {"bytes",
    "flops_f32", "flops_f64"}."""
    it = iteration_cost(sys_t, ml, B, krylov, cycle, n_smooth)
    b64, f64 = _apply_cost(sys_t, B, F64)
    return {"bytes": iters * it["bytes_per_iter"] + passes * b64,
            "flops_f32": iters * it["flops_per_iter"],
            "flops_f64": passes * f64}


def bound_seconds(cost, peaks):
    """The roofline: the larger of the bytes over the memory rate and the
    FLOPs over the arithmetic rates."""
    return max(cost["bytes"] / (peaks["hbm_gbps"] * 1e9),
               cost["flops_f32"] / (peaks["f32_tflops"] * 1e12)
               + cost["flops_f64"] / (peaks["f64_tflops"] * 1e12))
