"""Roofline accounting for the hot solve path (counterpart of
``utils/roofline.py``).

A static byte / FLOP model of one preconditioned Krylov iteration of the
batched transport solve (fine operator apply, the multigrid cycle, the
vector work) and of one system assembly, held against the card's peak
memory rate and arithmetic rate: the JAX package's model, evaluated on
the port's ``TransportSystem`` and ``MultilevelData``.  It counts the
dominant streams only (operator and transfer bands, coarse inverses, ~13
(n, B) vector passes), so it is a lower bound on the traffic, and the
achieved GB/s it reports is a lower bound too.

``chip_peaks`` reads the card's own published peaks from ``PEAKS``, keyed
by the start of ``torch.cuda.get_device_name``; a card without a row
raises (a share against another chip's peaks would mean nothing).
"""

from __future__ import annotations

import torch

__all__ = ["PEAKS", "chip_peaks", "ml_cg_iteration_cost", "assembly_cost",
           "roofline_summary"]

# Published peaks: HBM GB/s and TFLOP/s by operand type (NVIDIA's H100 SXM
# data sheet, dense rates: bf16 on the tensor cores, f32 and f64 outside
# them).  f32_matmul_tflops is the rate the f32 solve is held to: the
# port's f32 products run on the CUDA cores (TF32 is off).  The "cpu" row
# is the JAX package's nominal one (no published rate: f32 and f64 None).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                              "f32_tflops": 67.0, "f64_tflops": 34.0,
                              "f32_matmul_tflops": 67.0},
    "cpu": {"hbm_gbps": 50.0, "bf16_tflops": 1.0, "f32_tflops": None,
            "f64_tflops": None, "f32_matmul_tflops": 1.0 / 6.0},
}


def chip_peaks(device="cuda", kind=None):
    """The peaks of ``device`` (its card's name, or "cpu" for a CPU
    device), or of the card named ``kind``, with that name under
    ``kind``; raises ValueError for a card without a row in ``PEAKS``."""
    if kind is None:
        device = torch.device(device)
        kind = ("cpu" if device.type == "cpu"
                else torch.cuda.get_device_name(device))
    for prefix, row in PEAKS.items():
        if kind.startswith(prefix):
            return {"kind": kind, **row}
    raise ValueError(f"no published peaks for {kind!r}: add its row to "
                     "utils/roofline.py PEAKS")


def _band_cost(band_shape, B, dtype_bytes=4):
    """One banded apply Y = band @ X_window: the band read once (the
    dominant stream), X / Y vector traffic, 2 T R W B FLOPs."""
    T, R, W = [int(s) for s in band_shape]
    flops = 2.0 * T * R * W * B
    bytes_ = T * R * W * dtype_bytes + 3.0 * T * R * B * dtype_bytes
    return bytes_, flops


def _elem_cost(A_shape, B, dtype_bytes=4):
    """Element-path apply: element matrices read once, X gathered and Y
    scattered per element entry."""
    N, nd, _ = [int(s) for s in A_shape]
    flops = 2.0 * N * nd * nd * B
    bytes_ = (N * nd * nd * dtype_bytes
              + 2.0 * N * nd * B * dtype_bytes)
    return bytes_, flops


def ml_cg_iteration_cost(sys_t, ml, B, n_smooth=1, cycle="mult",
                         dtype_bytes=4, transfer_dtype=None):
    """Modelled bytes and FLOPs of ONE preconditioned iteration of the
    batched transport solve: one fine operator apply, the multigrid cycle
    (2 n_smooth applies per smoothed level, none on a level the cycle
    treats additively; the transfers; the dense coarsest solve) and ~13
    fine (n, B) vector streams.

    sys_t: the fine ``TransportSystem``; ml: its ``MultilevelData``;
    transfer_dtype: ``torch.bfloat16`` where the cycle's transfer bands
    are bf16 (``solve_sweep``'s option of that name).  Returns the totals
    and a breakdown by component."""
    parts = {}

    def _apply_cost(sys_l):
        if sys_l.Kband is not None:
            return _band_cost(sys_l.Kband.shape, B, dtype_bytes)
        return _elem_cost(sys_l.K.A64.shape, B, dtype_bytes)

    parts["cg_apply"] = _apply_cost(sys_t)

    applies_per_level = 2 * n_smooth  # residual + mirrored post-smooth
    tb_bytes = 2 if transfer_dtype == torch.bfloat16 else dtype_bytes
    tb_by = tb_fl = lv_by = lv_fl = 0.0
    for il, lev in enumerate(ml.levels):
        s = lev.sys
        aby, afl = _apply_cost(s)
        if cycle == "add" or (cycle == "hybrid" and il == 0):
            # additive: no level applies; hybrid: the fine level is
            # additive (scaled Jacobi and the coarse term only)
            aby = afl = 0.0
        lv_by += applies_per_level * aby
        lv_fl += applies_per_level * afl
        if lev.bands is not None:
            for band in (lev.bands.p, lev.bands.r):
                b2, f2 = _band_cost(band.shape, B, tb_bytes)
                tb_by += b2
                tb_fl += f2
        else:
            n_f = int(s.ndofs)
            tb_by += 2 * (3 * n_f * (4 + dtype_bytes)
                          + 3 * n_f * B * dtype_bytes)
            tb_fl += 2 * (2.0 * 3 * n_f * B)
    parts["vcycle_applies"] = (lv_by, lv_fl)
    parts["vcycle_transfers"] = (tb_by, tb_fl)

    nc = int(ml.Ainv.shape[-1])
    parts["coarse_dense"] = (B * nc * nc * dtype_bytes, 2.0 * B * nc * nc)

    n_fine = int(sys_t.ndofs)
    vec_streams = 13.0
    parts["cg_vectors"] = (vec_streams * n_fine * B * dtype_bytes, 0.0)

    total_bytes = sum(b for b, _ in parts.values())
    total_flops = sum(f for _, f in parts.values())
    return {"bytes_per_iter": total_bytes,
            "flops_per_iter": total_flops,
            "breakdown": {k: {"bytes": b, "flops": f}
                          for k, (b, f) in parts.items()}}


def assembly_cost(sys_t, dtype_bytes=8):
    """Modelled device bytes of ONE transport-system assembly: cell
    coordinates, the f64 element matrices (K, M and the Robin block) and
    the band's scatter (band written once, values and column ids read
    once).  Host work (dof maps, plans) is not modelled."""
    N, nd, _ = [int(s) for s in sys_t.K.A64.shape]
    by = (N * 3 * 2 * dtype_bytes          # cell coords
          + 2 * N * nd * nd * dtype_bytes  # element matrices out (K, M)
          + N * nd * nd * dtype_bytes)     # robin / aux block
    if sys_t.Kband is not None:
        T, R, W = [int(s) for s in sys_t.Kband.shape]
        by += T * R * W * 4                # band written (f32)
        by += N * nd * nd * (4 + 4)        # values + flat ids read
    return {"bytes": by}


def roofline_summary(cost, iters_executed, wall_s, passes_f64=0,
                     sys_t=None, B=1, peaks=None):
    """Achieved GB/s and TFLOP/s of a measured solve against the card's
    peaks (``chip_peaks()`` when ``peaks`` is None).

    cost: ``ml_cg_iteration_cost``'s; iters_executed: the Krylov
    iterations executed (the batch's most: every column does the work
    while any is active); wall_s: the solve's measured seconds;
    passes_f64: outer defect-correction passes, each one f64 element
    apply."""
    if peaks is None:
        peaks = chip_peaks()
    total_bytes = cost["bytes_per_iter"] * iters_executed
    total_flops = cost["flops_per_iter"] * iters_executed
    if passes_f64 and sys_t is not None:
        b64, f64_fl = _elem_cost(sys_t.K.A64.shape, B, dtype_bytes=8)
        total_bytes += passes_f64 * b64
        total_flops += passes_f64 * f64_fl
    gbps = total_bytes / max(wall_s, 1e-12) / 1e9
    tflops = total_flops / max(wall_s, 1e-12) / 1e12
    return {
        "chip": peaks["kind"],
        "modeled_bytes_per_iter_mb": round(
            cost["bytes_per_iter"] / 2**20, 2),
        "achieved_hbm_gbps": round(gbps, 1),
        "hbm_roofline_pct": round(100.0 * gbps / peaks["hbm_gbps"], 1),
        "achieved_tflops": round(tflops, 2),
        "mfu_pct": round(
            100.0 * tflops / peaks["f32_matmul_tflops"], 1),
        "peak_hbm_gbps": peaks["hbm_gbps"],
        "peak_f32_matmul_tflops": round(peaks["f32_matmul_tflops"], 1),
    }
