#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the port's CUDA kernels from
   fenics_eff_uptake_tpu_torch/ops/csrc into build/kernels/.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the mu sweep gives it (h = 0.02, B = 20), with the stated
   tolerance.  Times are device times per call, from torch.profiler's CUDA
   records (every kernel, copy and fill one call puts on the card, summed
   over 20 calls after 3 warm-up calls, divided by 20): the kernel's
   (``ms``), the plain version's and that of the one library call that
   computes the same function (kernels A and B: the cuBLAS bmm of the
   plain version on windows built before the timing; kernel C: a cuSPARSE
   CSR product of the assembled matrix, coef folded into X before the
   timing, ``addmm`` onto ``out`` in the out= form).  Beside them the
   per-call time (``call_ms``: median over 20 calls of a CUDA event
   interval around the Python call, which includes the wrapper's host
   work before the launch), and the least time the card could take (the
   larger of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s in f32, 34 TFLOP/s
   in f64): for A and B both over the whole band (dense) and over the
   column spans these inputs need (span), with the share of the span
   bound that the kernel's device time reaches.  Kernel C runs in both
   forms: the full output (f64 K, the defect residual's) and out=, added
   into the Robin block's own rows (every Robin apply of both paths).
   The flow path's cases follow (``phase_kernels_flow``, on the solved
   Stokes velocity): kernel A on the advection band at B = 3 and on the
   Stokes velocity band at B = 2; kernel B on the fine restriction and
   prolongation of the advective hierarchy at B = 3 and of the velocity
   hierarchy at B = 2; kernels A and B at B = 96 (the coarse-pressure
   deflation's one wide apply); kernel C in f64 on the nonsymmetric
   advection block at B = 3, and in the out= form on the fine and first
   mid-level Robin blocks at B = 3, the path's most launched C call.
   Last the adv-diff path's cases (``phase_kernels_advdiff``, on the
   rectangle's system and step-mu hierarchy at h = 0.02, B = 9): kernel
   C's per-sample form (one Robin matrix set per column, no coef) in f64
   on the fine block in both forms, in f32 on the fine block and on both
   mid levels' blocks in the out= form; the library call is one cuSPARSE
   CSR product too, of the columns' matrices stacked into one matrix of
   n B rows, applied to the batch-minor X seen as one long column; and
   kernel A in f32 on the rectangle's fine advection band at B = 9, two
   thirds of that batch's solve.
   The bf16 operand forms run beside them on the same bands and blocks
   (A and B on the tensor cores, ``mma.sync`` m16n8k16, and labelled so): A
   (band, X, coef, Y in bf16) on the mid and fine K bands at B = 20 and,
   at B = 3, on the fine advection band and the first mid level's K and
   advection bands; B in both forms (bf16 band with f32 X and Y; all bf16)
   on the fine restriction and prolongation at B = 20 and on the
   transport hierarchy's at B = 3; C (A, X, coef, out in bf16) in the out=
   form on the fine Robin block at B = 20, on the fine and mid Robin
   blocks at B = 3, and in the per-sample form at B = 9: each bf16 form
   at the largest shapes and at both batch widths at which the configs
   phase launches it.  Bounds count 2-byte bands and X;
   the library calls are the cuBLAS bmm on bf16 windows (f32 output where
   the kernel's is) and, for C, the f32 cuSPARSE call on upcast operands.
   Tolerances: an f32 output within 1e-5 of the row's sum of |terms|; a
   bf16 output equal to plain's in >= 99% of the entries and within one
   bf16 ulp of it (or, where cancellation leaves a result far below its
   terms, within that f32 bound).
4. slice: the 20-point Phase-A mu sweep at h = 0.02 through
   studies.phase_a.run_mu_sweep, twice (first and steady run).  Checks that
   every kernel (C in both forms) was launched by the first run, the true f64 relative
   residuals (<= 1e-11), the inner iterations (<= 40 per column), and the
   CSV columns against the committed JAX artifact
   examples/phase_a_tpu_h0.02 (1e-6 relative).
5. no_uptake: the no-uptake study on the reference geometry (w = 0.5,
   d = 1.0 mm) and the rectangle at h = 0.02, Pe = 0.1, 1, 10, through
   studies.no_uptake.run_geometry_study, twice (first and steady run):
   Stokes MINRES+MG, then one batched BiCGStab over the three Pe.  Prints
   the seconds of every stage; checks that kernels A, B and C (C in both
   forms) were launched by the first run, the true f64 relative residuals (Stokes <= 1e-9,
   transport <= 1e-11 in every column), the iteration bounds, the six CSV
   rows against the committed JAX artifact examples/no_uptake_tpu_h0.02
   (1e-6 relative; the signed net fluxes 1e-6 |Mouth Q_in| absolute), and
   that the steady run's rows equal the first run's.

6. adv_diff: the adv-diff step-mu validation at h = 0.02 on the full
   3 x 3 Pe x mu grid through studies.adv_diff.run_advdiff_step_validation,
   twice (first and steady run): per domain one Stokes solve; the 9 sulcus
   columns as one batched BiCGStab with mu per column; the 9 rectangular
   surrogates as a second one with per-column Robin matrices.  Checks the
   true f64 relative residuals (Stokes <= 1e-9, both batches <= 1e-11),
   the iteration bounds, that kernels A and B were launched by both
   batches and C's per-sample form by the rectangle batch (and by it
   alone), and the 18 rows against the committed JAX artifact
   examples/advdiff_tpu_h0.02 (1e-6 relative; the rectangle's
   advective_flux 1e-6 |total_flux| and flux_error_pct 1e-4 absolute).
7. no_adv_studies: Phase-A's mu_eff study (0.5 x 1.0 mm sulcus, 3 mu)
   against the 3 rows of examples/phase_a_tpu_h0.02, and Phase-B on the
   ``reference`` and ``square_medium`` geometries (sulcus and rectangle,
   mu factors 0.1, 0.5, 1.0) against their 6 rows of
   examples/phase_b_tpu_h0.02: 1e-6 relative (flux_error_pct 1e-4
   absolute), CG <= 40 per column, residuals <= 1e-11.

8. configs: ``solve_sweep`` on the mu-sweep system (h = 0.02, B = 20,
   built once) under each configuration the JAX package offers: the
   default, bf16 transfer bands, the bf16 cycle, the add and mult cycles,
   the mult cycle in bf16 (its fine band applies inside M), no cheap
   pass, the f64 solve with the f64 mult cycle, and Newton-Schulz coarsest
   inverses.  Each is run three times (launch counts; steady seconds;
   device busy time), is held to a true f64 relative residual <= 1e-11
   and to max |X - X_default| < 1e-8, and prints its iterations, passes,
   steady solve seconds, device busy time and idle share, and launches;
   the bf16 forms must be launched where asked and nowhere else.  Then
   the no-uptake transport solve (reference geometry, B = 3) with the
   mult cycle in f32 (held to the gates) and in bf16 (reported: BiCGStab
   need not converge under a cycle that rounds to bf16).  Before every
   configuration with a bf16 form, one application of its cycle through
   the kernels is held against the same cycle through the kernels' plain
   versions on the card (``cycle_vs_plain``), so that a solve that breaks
   down cannot be a wrong kernel.  Last the Jacobi branch
   (``run_mu_sweep`` at h = 0.08, no hierarchy), held to the residual
   gate.

With ``--profile``, a last phase profiles the paths once more: cProfile of
one steady ``no_adv_batch`` and one steady no-uptake study (where the host
setup goes), and ``torch.profiler`` of one mu-sweep CG solve, one Stokes
saddle solve, one BiCGStab solve of the no-uptake study and one of the
adv-diff study's rectangle batch (device busy time by kernel, and the
device's idle share against the unprofiled solve's wall time).  Full
reports go to build/chip_smoke/profile_*.txt and *_trace.json.

Then prints one JSON line of per-kernel results and, last, the device line.
Imports nothing of JAX.  Run alone, without the repository around it, it
exits 1 before touching the card.
"""

import argparse
import cProfile
import csv
import io
import json
import os
import pstats
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_CSV = (ROOT / "examples" / "phase_a_tpu_h0.02"
              / "Mu Parameter Sweep Analysis"
              / "mu_parameter_sweep_results.csv")
GOLDEN_NU_CSV = (ROOT / "examples" / "no_uptake_tpu_h0.02"
                 / "Geometry Comparison Analysis"
                 / "geometry_comparison_results.csv")
GOLDEN_AD_CSV = (ROOT / "examples" / "advdiff_tpu_h0.02" / "Results Data"
                 / "advdiff_validation_step_pe_x_mu.csv")
GOLDEN_MUEFF_CSV = (ROOT / "examples" / "phase_a_tpu_h0.02"
                    / "Mu_Eff Spatial Analysis Analysis"
                    / "mu_eff_analysis_results.csv")
GOLDEN_PB_CSV = (ROOT / "examples" / "phase_b_tpu_h0.02"
                 / "no_adv_mu_sweep_results.csv")
OUT_DIR = ROOT / "build" / "chip_smoke"
B_SWEEP = 20
BENCH_CELLS = 50647
PECLET = [0.1, 1.0, 10.0]
# MINRES bound of the flow phases: twice a CPU run of the port's path at
# h = 0.035 (130 over 2 passes; an H100 reads 124 and 112 at h = 0.02).
MINRES_BOUND = 260
# BiCGStab bounds: 1.5 times what an H100 read at h = 0.02 in every run so
# far (no-uptake [15, 28, 171] and [15, 28, 170] per Pe column; adv-diff
# columns Pe-major, Pe 0.1, 1, 10, each with mu factors 0.1, 1, 10: sulcus
# [15, 15, 14, 23, 18, 15, 136, 85, 75], rectangle [15, 13, 13, 24, 19, 15,
# 129, 90, 76]), rounded up.  1.5 is the spread of the f32 summation order
# alone: the same commit's
#   python -m fenics_eff_uptake_tpu_torch.studies.no_uptake \
#       --geometries reference --mesh-size 0.035 --device cpu
# prints, at Pe = 10, 151 / 162 / 166 / 158 (sulcus) and 172 / 168 / 226 /
# 154 (rectangle) under OMP_NUM_THREADS = 1 / 2 / 4 / 8 (the thread count
# changes how PyTorch's CPU sums are split;
# scripts/bicgstab_count_spread.py), while the card's counts, whose sums have
# one fixed order, have not moved.
BICGSTAB_BOUND = [23, 42, 257]
AD_BICGSTAB_BOUND = {
    "sulcus": [23, 23, 21, 35, 27, 23, 204, 128, 113],
    "rectangular": [23, 20, 20, 36, 29, 23, 194, 135, 114]}
# CSV columns held to 1e-6 relative, and the signed net fluxes held to
# 1e-6 |Mouth Q_in| absolute (differences of much larger fluxes)
NU_REL_COLUMNS = ("Total Mass", "Avg Concentration",
                  "Sulcus Avg Concentration", "Mouth E_L1", "Mouth Q_in",
                  "Max_Ux_mid_channel", "Avg_Ux_mid_channel",
                  "Concentration_Ratio")
NU_NET_COLUMNS = ("Mouth_Flux_Total", "Inlet-Outlet Flux")
# adv-diff CSV columns held to 1e-6 relative; the rectangle's advective
# flux (0 but for rounding) is held to 1e-6 |total_flux|, flux_error_pct (a
# difference of fluxes, in percent) to 1e-4 absolute
AD_REL_COLUMNS = ("total_flux", "diffusive_flux", "uptake_flux",
                  "mu_eff_arc", "mu_eff_sim", "mu_eff_open", "avg_conc",
                  "CR", "flux_ratio")
MUEFF_COLUMNS = ("Mu_Value", "Mu_base_nondim", "Mu_Eff_Simulation",
                 "Mu_Eff_Analytical", "Mu_Eff_Enhanced", "Mu_Eff_Opening",
                 "Ratio_Sim", "Ratio_Opening", "Mu_Mean_Bottom")
PB_COLUMNS = ("avg_conc_sulc", "avg_conc_rect", "flux_sulc_y0",
              "flux_rect_bottom", "CR", "flux_ratio")
PB_GEOMETRIES = ["reference", "square_medium"]
CG_BOUND = 40
PALLAS = "fenics_eff_uptake_tpu/ops/pallas_kernels.py"
JAX_SWEEP = "fenics_eff_uptake_tpu/parallel/sweep.py"
CSRC = "fenics_eff_uptake_tpu_torch/ops/csrc"
# the label of the bf16 forms of kernels A and B: products on the tensor
# cores (mma.sync m16n8k16, bf16 in, f32 accumulate)
TC = "(tensor cores)"
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s, and
# FLOP/s by the operands' element size (bf16: the dense tensor-core rate;
# f32 and f64 outside the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {2: 989e12, 4: 67e12, 8: 34e12}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def _profiled_us(fn, cpu=True):
    """Summed durations (us) of the CUDA records (kernels, copies, fills)
    that torch.profiler takes while fn() runs, the device synced at the
    end.  ``cpu`` False leaves the host's operator records out: the same
    device records (a whole solve's sum within 1%), and a third of the
    time to take and read the trace of a solve of 100,000 launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(e.device_type).endswith("CUDA"))


def device_ms(fn, calls=20, warmup=3):
    """Device time of one call of fn: the durations of the CUDA records
    (kernels, copies, fills) that torch.profiler takes over ``calls``
    calls, summed, over the calls.

    The profiler now and then returns a trace without any CUDA record; it
    is taken again, at most twice.  Where it stays empty (the profiler of
    this process has stopped recording the card) the device time is not
    measured: None, here and, without a retake, in every later call."""
    for _ in range(warmup):
        fn()

    def many():
        for _ in range(calls):
            fn()

    for attempt in range(1 if device_ms.profiler_lost else 3):
        us = _profiled_us(many)
        if us > 0:
            device_ms.profiler_lost = False
            return us / calls / 1e3
        print(f"[kernels] profiler trace {attempt + 1} holds no CUDA record",
              flush=True)
    if not device_ms.profiler_lost:
        print("[kernels] FINDING: torch.profiler records no device time in "
              "this process; device times from here on are not measured "
              "(ms null), and event_ms gives the CUDA event interval over "
              "back-to-back calls instead", flush=True)
    device_ms.profiler_lost = True
    return None


device_ms.profiler_lost = False


def back_to_back_ms(fn, calls=20):
    """The CUDA event interval around ``calls`` calls of fn queued back to
    back, over the calls: an upper bound of the device time per call (for
    a kernel of a few microseconds it is the host's launch rate).  Taken
    only where the profiler gave no device time, under its own key."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def median_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes, flops, elem_size):
    """(least ms the card could take, "bytes" or "operations")."""
    tb = nbytes / HBM_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS[elem_size] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def span_elements(band, spans):
    """Band elements inside the column spans (what these inputs need)."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.banded import SPAN_COLS, SPAN_ROWS
    T, R, W = band.shape
    nb = spans.shape[1]
    rows = torch.clamp(R - SPAN_ROWS * torch.arange(nb, device=band.device),
                       max=SPAN_ROWS)
    cols = (torch.clamp(spans[..., 1] * SPAN_COLS, max=W)
            - spans[..., 0] * SPAN_COLS).clamp(min=0)
    return int((cols * rows).sum())


def band_bounds(band, spans, n_in, n_out, B, extra_bytes=0, x_size=4,
                y_size=4):
    """Dense and span bounds of a band apply: the band (whole, or its
    spans' elements) read once, X (n_in, B) read once, Y (n_out, B)
    written once, each at its element size, 2 * B FLOPs per band element at
    the rate of the band's type."""
    bs = band.element_size()
    io = B * (x_size * n_in + y_size * n_out) + extra_bytes
    dense = band.numel()
    sp = span_elements(band, spans)
    return {"dense": bound_ms(bs * dense + io, 2 * B * dense, bs),
            "span": bound_ms(bs * sp + io + spans.numel() * 4, 2 * B * sp,
                             bs),
            "span_fill": sp / dense}


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in bf16 steps, elementwise."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def compare(label, kernel, plain, rtol, library=None, bounds=None,
            check=None, terms=None):
    """Kernel vs plain on the same inputs: errors, device times per call
    of the kernel, the plain version and the library call, the kernel's
    per-call time, and the bounds (``bounds``: "span" and, for the band
    kernels, "dense" (ms, what binds) pairs).  ``check``, where given,
    makes the two outputs compared (the out= form's calls accumulate).
    ``terms`` (the bf16 forms): each output's sum of |terms|; an f32 output
    is then held to rtol of it elementwise, and a bf16 output to >= 99%
    equal entries, each within one bf16 ulp of plain's or within rtol of
    its terms (a result that cancellation left far below them)."""
    import torch
    yk, yp = check() if check is not None else (kernel(), plain())
    torch.cuda.synchronize()
    if not bool(torch.isfinite(yk).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    extra = {}
    if terms is not None:
        diff = (yk.float() - yp.float()).abs()
        ok = diff <= rtol * terms
        if yk.dtype == torch.bfloat16:
            d = bf16_ulps(yk, yp)
            ok |= d <= 1
            extra = {"max_ulps": int(d.max()),
                     "equal_share": float((d == 0).float().mean())}
            print(f"[kernels] {label}: bf16 output, {extra['max_ulps']} ulp "
                  f"at most from plain, {100 * extra['equal_share']:.3f}% "
                  "of the entries equal", flush=True)
            if not extra["equal_share"] >= 0.99:
                raise AssertionError(f"{label}: only "
                                     f"{extra['equal_share']:.4f} equal")
        if not bool(ok.all()):
            raise AssertionError(
                f"{label}: {int((~ok).sum())} entries off plain by more "
                f"than one ulp and {rtol} of their terms")
        yk, yp = yk.float(), yp.float()
    abs_err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    ms = device_ms(kernel)
    call_ms = median_ms(kernel)
    plain_ms = device_ms(plain)
    lib_ms = None if library is None else device_ms(library)
    event_ms = back_to_back_ms(kernel) if ms is None else None
    span, by = bounds["span"]
    share = None if ms is None else span / ms

    def f(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    out = {"case": label, "max_abs_err": abs_err, "max_rel_err": rel,
           "ms": ms, "event_ms": event_ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": span,
           "bound_by": by, "share": share, **extra}
    text = (f"[kernels] {label}: max_abs_err {abs_err:.3e} max_rel_err "
            f"{rel:.3e} (tol {rtol:.0e}) device: kernel {f(ms)}"
            + ("" if event_ms is None
               else f" (events, back to back: {event_ms:.4f} ms)")
            + f" plain {f(plain_ms)} library "
            + ("none" if library is None else f(lib_ms))
            + f"; per call {call_ms:.4f} ms")
    if "dense" in bounds:
        d, dby = bounds["dense"]
        out.update(dense_bound_ms=d, dense_bound_by=dby,
                   span_fill=bounds["span_fill"])
        text += (f"; bound dense {d:.4f} ms ({dby}), span {span:.4f} ms "
                 f"({by}, {100 * bounds['span_fill']:.1f}% of the band)")
    else:
        text += f"; bound {span:.4f} ms ({by})"
    print(text + "; share of the bound "
          + ("not measured" if share is None else f"{share:.3f}"), flush=True)
    if terms is None and not rel <= rtol:
        raise AssertionError(f"{label}: relative error {rel:.3e} > {rtol}")
    return out


def band_case(label, band, spans, X, coef, rtol=1e-5):
    """Kernel A on one band: kernel, plain, and the plain version's one
    cuBLAS call (bmm on the windows, built before the timing)."""
    import torch
    import torch.nn.functional as F
    from fenics_eff_uptake_tpu_torch.ops.banded import (band_apply,
                                                        band_apply_plain)
    T, R, W = band.shape
    halo = (W // R - 1) // 2
    win = F.pad(X, (0, 0, halo * R, halo * R)).unfold(0, W, R).contiguous()
    n, B = X.shape
    xs = X.element_size()
    terms = None
    if band.dtype == torch.bfloat16:     # bf16 operands, bf16 Y
        terms = band_apply_plain(band.float().abs(), X.float().abs(),
                                 None if coef is None else coef.float())
    return compare(
        label, lambda: band_apply(band, X, coef, spans=spans),
        lambda: band_apply_plain(band, X, coef), rtol,
        library=lambda: torch.bmm(band, win.transpose(1, 2)),
        bounds=band_bounds(band, spans, n, n, B,
                           0 if coef is None else xs * B, xs, xs),
        terms=terms)


def rect_case(label, band, offs, spans, Xq, rtol=1e-5):
    """Kernel B on one transfer band: kernel, plain, and the plain
    version's one cuBLAS call (bmm on the gathered windows, the gather
    before the timing)."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.banded import (
        rect_band_apply, rect_band_apply_plain)
    T, R, W = band.shape
    idx = offs.long()[:, None] + torch.arange(W, device=Xq.device)
    win = Xq.to(band.dtype)[idx].contiguous()
    xs = Xq.element_size()
    terms, library = None, lambda: torch.bmm(band, win)
    if band.dtype == torch.bfloat16:
        terms = rect_band_apply_plain(band.float().abs(), offs,
                                      Xq.to(band.dtype).float().abs())
        if Xq.dtype == torch.float32:    # form 1: f32 out of bf16 operands
            try:
                torch.bmm(band, win, out_dtype=torch.float32)

                def library():
                    return torch.bmm(band, win, out_dtype=torch.float32)
            except (TypeError, RuntimeError):
                print(f"[kernels] {label}: this PyTorch's bmm has no f32 "
                      "output for bf16 operands; library time is the bf16 "
                      "output's", flush=True)
    return compare(
        label, lambda: rect_band_apply(band, offs, Xq, spans),
        lambda: rect_band_apply_plain(band, offs, Xq), rtol,
        library=library,
        bounds=band_bounds(band, spans, Xq.shape[0], T * R, Xq.shape[1],
                           4 * T, xs, xs),
        terms=terms)


def element_case(label, blk, X, coef, rtol, form="full"):
    """Kernel C on one element block in X's dtype, through the block's
    bound kernel, in the full or the out= form: kernel, plain, and one
    cuSPARSE CSR product of the assembled matrix (built, and coef folded
    into X, before the timing; ``addmm`` onto out in the out= form).  For a
    per-sample block (``_Block.per_sample``: one matrix set per column, no
    coef) that matrix stacks the columns' matrices into one CSR of n B
    rows, M[d B + b, c B + b] = A_b[d, c], applied to the batch-minor X
    seen as one column of n B entries (a view).
    The bound counts what the function needs: A (every column's set), dofs,
    the X rows the block reads (its touched rows), coef, and the rows of
    Y: all of them written in the full form, the touched rows read and
    written in the out= form; not the plans derived from dofs.  The out=
    form starts from a random out: the rows the block does not touch must
    keep its bits, and the block's part (the result less out) is held to
    rtol of its own size."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import element_apply_plain
    if X.dtype == torch.bfloat16:
        return element_case_bf16(label, blk, X, coef, rtol, form)
    A = blk.A64 if X.dtype == torch.float64 else blk.A32
    per_sample = A.dim() == 4
    N, nd, _ = A.shape[-3:]
    n, B = X.shape
    dofs = blk.dofs.long()
    rows = dofs[:, :, None].expand(N, nd, nd)
    cols = dofs[:, None, :].expand(N, nd, nd)
    Xc = X if coef is None else X * coef
    size = n
    if per_sample:
        b = torch.arange(B, device=X.device)[:, None, None, None]
        rows, cols, size = rows * B + b, cols * B + b, n * B
        Xc = Xc.reshape(-1, 1)

    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_coo_tensor(
            torch.stack([rows.reshape(-1), cols.reshape(-1)]),
            A.reshape(-1), (size, size),
            check_invariants=False).coalesce().to_sparse_csr()
        lib = torch.sparse.mm(csr, Xc).reshape(n, B)
    ref = element_apply_plain(A, blk.dofs, blk.scatter, X, coef)
    if not float((lib - ref).abs().max()) <= rtol * float(ref.abs().max()):
        raise AssertionError(f"{label}: the library call's matrix does not "
                             "compute the block's product")
    ds = A.element_size()
    touched = blk.scatter.tiles.rows.numel()
    nbytes = (A.numel() * ds + 4 * N * nd
              + touched * B * ds + (0 if coef is None else B * ds)
              + (n if form == "full" else 2 * touched) * B * ds)
    bounds = {"span": bound_ms(nbytes, 2 * N * nd * nd * B, ds)}
    label = (f"C per-sample {label} A{tuple(A.shape)} {form}" if per_sample
             else f"C {label} A{tuple(A.shape)} B={B} {form}")
    if form == "full":
        return compare(
            label, lambda: blk.apply_batched(X, coef),
            lambda: element_apply_plain(A, blk.dofs, blk.scatter, X, coef),
            rtol, bounds=bounds, library=lambda: torch.sparse.mm(csr, Xc))
    g = torch.Generator(device=X.device).manual_seed(n + B)
    out0 = torch.rand((n, B), generator=g, device=X.device, dtype=X.dtype)
    ok, op, ol = out0.clone(), out0.clone(), out0.clone()
    untouched = torch.ones(n, dtype=torch.bool, device=X.device)
    untouched[blk.scatter.tiles.rows.long()] = False

    def check():
        yk = blk.apply_batched(X, coef, out=out0.clone())
        yp = element_apply_plain(A, blk.dofs, blk.scatter, X, coef,
                                 out=out0.clone())
        if not torch.equal(yk[untouched], out0[untouched]):
            raise AssertionError(f"{label}: rows the block does not touch "
                                 "changed")
        return yk - out0, yp - out0

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compare(
            label, lambda: blk.apply_batched(X, coef, out=ok),
            lambda: element_apply_plain(A, blk.dofs, blk.scatter, X, coef,
                                        out=op),
            rtol, bounds=bounds, check=check,
            library=lambda: torch.addmm(ol.view_as(Xc), csr, Xc))


def element_case_bf16(label, blk, X, coef, rtol, form):
    """Kernel C's bf16 form in the out= form on a block that carries bf16
    matrices (``_Block.with_bf16``): A, X, coef and out in bf16.  Held to
    plain by the bf16 criterion of ``compare``; the library call is the f32
    cuSPARSE ``addmm`` on the upcast operands (per-sample: the columns'
    matrices stacked, as in ``element_case``); the bound counts 2-byte A,
    X, coef and out rows."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import element_apply_plain
    if form != "out":
        raise ValueError("the bf16 cases run the out= form")
    A = blk.A16
    per_sample = A.dim() == 4
    N, nd, _ = A.shape[-3:]
    n, B = X.shape
    dofs = blk.dofs.long()
    rows = dofs[:, :, None].expand(N, nd, nd)
    cols = dofs[:, None, :].expand(N, nd, nd)
    Xc = X.float() if coef is None else X.float() * coef.float()
    size = n
    if per_sample:
        b = torch.arange(B, device=X.device)[:, None, None, None]
        rows, cols, size = rows * B + b, cols * B + b, n * B
        Xc = Xc.reshape(-1, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = torch.sparse_coo_tensor(
            torch.stack([rows.reshape(-1), cols.reshape(-1)]),
            A.float().reshape(-1), (size, size),
            check_invariants=False).coalesce().to_sparse_csr()
    touched = blk.scatter.tiles.rows.numel()
    nbytes = (A.numel() * 2 + 4 * N * nd + touched * B * 2
              + (0 if coef is None else B * 2) + 2 * touched * B * 2)
    bounds = {"span": bound_ms(nbytes, 2 * N * nd * nd * B, 2)}
    label = (f"C bf16 per-sample {label} A{tuple(A.shape)} out" if per_sample
             else f"C bf16 {label} A{tuple(A.shape)} B={B} out")
    g = torch.Generator(device=X.device).manual_seed(n + B)
    out0 = torch.rand((n, B), generator=g,
                      device=X.device).to(torch.bfloat16)
    ok, op, ol = out0.clone(), out0.clone(), out0.float()
    untouched = torch.ones(n, dtype=torch.bool, device=X.device)
    untouched[blk.scatter.tiles.rows.long()] = False
    terms = out0.float() + element_apply_plain(
        A.float().abs(), blk.dofs, blk.scatter, X.float().abs(),
        None if coef is None else coef.float())

    def check():
        yk = blk.apply_batched(X, coef, out=out0.clone())
        yp = element_apply_plain(A, blk.dofs, blk.scatter, X, coef,
                                 out=out0.clone())
        if not torch.equal(yk[untouched], out0[untouched]):
            raise AssertionError(f"{label}: rows the block does not touch "
                                 "changed")
        return yk, yp

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compare(
            label, lambda: blk.apply_batched(X, coef, out=ok),
            lambda: element_apply_plain(A, blk.dofs, blk.scatter, X, coef,
                                        out=op),
            rtol, bounds=bounds, check=check, terms=terms,
            library=lambda: torch.addmm(ol.view_as(Xc), csr, Xc))


def phase_kernels(dev):
    """Each kernel against its plain version at the sweep's own shapes."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params)

    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    mesh = make_mesh(geom)
    sys_ = build_transport_system(mesh, dev)
    mus = np.linspace(0.1, 150.0, B_SWEEP)
    ml = build_multilevel_for(sys_, mesh, [geom.D] * B_SWEEP, mus)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(n, dtype):
        return torch.rand((n, B_SWEEP), generator=g, device=dev,
                          dtype=dtype) * 2 - 1

    coef32 = torch.rand(B_SWEEP, generator=g, device=dev) + 0.5
    out = {"band_apply": [], "rect_band_apply": [], "element_apply": []}
    # A: the fine operator band and the first mid-level band (f32 accumulate
    # over up to W terms in another order than cuBLAS: 1e-5 of max |Y|)
    for label, s in (("fine", sys_), ("mid", ml.levels[1].sys)):
        band = s.Kband
        X = rnd(band.shape[0] * band.shape[1], torch.float32)
        out["band_apply"].append(band_case(
            f"A {label} band {tuple(band.shape)} B={B_SWEEP}", band,
            s.Kspans, X, coef32))
    # B: the fine level's restriction and prolongation bands
    tb = ml.levels[0].bands
    for label, band, offs, spans, rows in (
            ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
            ("prolong", tb.p, tb.po, tb.ps, tb.pad_p)):
        Xq = rnd(rows, torch.float32)
        out["rect_band_apply"].append(rect_case(
            f"B fine {label} {tuple(band.shape)} B={B_SWEEP}", band, offs,
            spans, Xq))
    # C: f64 K in the full form (the defect residual's), the Robin blocks
    # (P2 facets carrying their cells' dofs, nd=6; the mid level's P1,
    # nd=3) in the out= form, as the sweep applies them, and f32 Robin in
    # the full form too; 1e-12 in f64, 2e-5 in f32 (summation order)
    mid_R = ml.levels[1].sys.R
    for label, blk, dtype, rtol, form in (
            ("f64 K", sys_.K, torch.float64, 1e-12, "full"),
            ("f64 R", sys_.R, torch.float64, 1e-12, "out"),
            ("f32 R", sys_.R, torch.float32, 2e-5, "full"),
            ("f32 R", sys_.R, torch.float32, 2e-5, "out"),
            ("f32 mid R", mid_R, torch.float32, 2e-5, "out")):
        out["element_apply"].append(element_case(
            label, blk, rnd(blk.ndofs, dtype), coef32.to(dtype), rtol,
            form))
    # the bf16 operand forms on the same bands and blocks: A on the mid K
    # band (the hybrid cycle's) and the fine K band (the mult cycle's), B
    # in both forms on the fine transfers, C on the fine Robin block in
    # the out= form (tolerances: compare's ``terms``)
    bf16 = torch.bfloat16
    out["band_apply bf16"] = [band_case(
        f"A bf16 {TC} {label} band {tuple(s.Kband.shape)} B={B_SWEEP}",
        s.Kband.to(bf16), s.Kspans,
        rnd(s.Kband.shape[0] * s.Kband.shape[1], bf16), coef32.to(bf16))
        for label, s in (("mid", ml.levels[1].sys), ("fine", sys_))]
    out["rect_band_apply bf16"] = []
    for label, band, offs, spans, rows in (
            ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
            ("prolong", tb.p, tb.po, tb.ps, tb.pad_p)):
        for xd, form in ((torch.float32, "bf16 band, f32 X"),
                         (bf16, "all bf16")):
            out["rect_band_apply bf16"].append(rect_case(
                f"B {form} {TC} fine {label} {tuple(band.shape)} "
                f"B={B_SWEEP}",
                band.to(bf16), offs, spans, rnd(rows, xd)))
    out["element_apply bf16"] = [element_case(
        "R", sys_.R.with_bf16(), rnd(sys_.ndofs, bf16), coef32.to(bf16),
        1e-5, "out")]
    del sys_, ml
    torch.cuda.empty_cache()
    return out


def phase_kernels_flow(dev):
    """The kernels at the no-uptake path's shapes (reference geometry,
    h = 0.02): the advection band and block under the solved Stokes
    velocity and the advective hierarchy's fine transfers (B = 3), the
    Stokes velocity band and its fine transfers (B = 2), and the
    deflation's wide apply (B = 96)."""
    import torch
    from fenics_eff_uptake_tpu_torch.models.stokes_flow import (
        VELOCITY_DIRICHLET)
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, build_multilevel_for, level_meshes_for)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, stokes_for_study)

    p = _make_params(PECLET[0], 0.5, 1.0, 0.02)
    mesh = make_mesh(p, "sulcus")
    u, _ = stokes_for_study(mesh, p.H, dev)
    D = [1.0 / pe for pe in PECLET]
    adv = build_transport_system(mesh, dev, u_values=u.values,
                                 u_space=u.space)
    aml = build_multilevel_for(adv, mesh, D, [0.0] * len(D), u_fine=u)
    vel = build_transport_system(mesh, dev, dirichlet=VELOCITY_DIRICHLET,
                                 with_robin=False)
    vml = build_multilevel(vel, level_meshes_for(mesh), np.ones(2),
                           np.zeros(2), dirichlet=VELOCITY_DIRICHLET,
                           with_robin=False)
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(n, B, dtype=torch.float32):
        return torch.rand((n, B), generator=g, device=dev,
                          dtype=dtype) * 2 - 1

    out = {"band_apply": [], "rect_band_apply": [], "element_apply": []}
    # A: 1e-5 of max |Y| (f32 sums in another order than cuBLAS)
    for label, band, spans, B, coef in (
            ("Adv band", adv.Advband, adv.Advspans, 3, None),
            ("velocity band", vel.Kband, vel.Kspans, 2,
             torch.ones(2, device=dev)),
            ("velocity band", vel.Kband, vel.Kspans, 96,
             torch.rand(96, generator=g, device=dev) + 0.5)):
        X = rnd(band.shape[0] * band.shape[1], B)
        out["band_apply"].append(band_case(
            f"A {label} {tuple(band.shape)} B={B}", band, spans, X, coef))
    # B: each hierarchy's fine restriction and prolongation at the widths
    # the path gives them (transport cycles, Stokes cycles, deflation)
    for label, tb, B in (("transport", aml.levels[0].bands, 3),
                         ("velocity", vml.levels[0].bands, 2),
                         ("velocity", vml.levels[0].bands, 96)):
        for way, band, offs, spans, rows in (
                ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
                ("prolong", tb.p, tb.po, tb.ps, tb.pad_p)):
            Xq = rnd(rows, B)
            out["rect_band_apply"].append(rect_case(
                f"B {label} {way} {tuple(band.shape)} B={B}", band, offs,
                spans, Xq))
    # C: the f64 Adv block in the full form (1e-12), and the f32 fine and
    # mid Robin blocks in the out= form (2e-5), every cycle's Robin apply
    # (the study's mu is 0; a random coef here, as the time is the same)
    out["element_apply"].append(element_case(
        "f64 Adv", adv.Adv, rnd(adv.ndofs, 3, torch.float64), None, 1e-12))
    for label, blk in (("f32 R", adv.R), ("f32 mid R", aml.levels[1].sys.R)):
        out["element_apply"].append(element_case(
            label, blk, rnd(blk.ndofs, 3),
            torch.rand(3, generator=g, device=dev) + 0.5, 2e-5, "out"))
    # the bf16 forms at the shapes the mult cycle of this path gives them
    # at B = 3 (an odd B takes the kernels' scalar stores and plain or
    # 4-byte X copies): A on the fine advection band and on the first mid
    # level's K (with coef) and advection bands, B in both forms on the
    # fine transfers, C on the fine and mid Robin blocks in the out= form
    bf16 = torch.bfloat16
    mid = aml.levels[1].sys
    coef3 = torch.rand(3, generator=g, device=dev) + 0.5
    out["band_apply bf16"] = [band_case(
        f"A bf16 {TC} {label} {tuple(band.shape)} B=3", band.to(bf16), spans,
        rnd(band.shape[0] * band.shape[1], 3, bf16),
        None if coef is None else coef.to(bf16))
        for label, band, spans, coef in (
            ("Adv band", adv.Advband, adv.Advspans, None),
            ("mid K band", mid.Kband, mid.Kspans, coef3),
            ("mid Adv band", mid.Advband, mid.Advspans, None))]
    tb = aml.levels[0].bands
    out["rect_band_apply bf16"] = [rect_case(
        f"B {form} {TC} transport {way} {tuple(band.shape)} B=3",
        band.to(bf16),
        offs, spans, rnd(rows, 3, xd))
        for way, band, offs, spans, rows in (
            ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
            ("prolong", tb.p, tb.po, tb.ps, tb.pad_p))
        for xd, form in ((torch.float32, "bf16 band, f32 X"),
                         (bf16, "all bf16"))]
    out["element_apply bf16"] = [element_case(
        label, blk.with_bf16(), rnd(blk.ndofs, 3, bf16), coef3.to(bf16),
        1e-5, "out") for label, blk in (("R", adv.R), ("mid R", mid.R))]
    del adv, aml, vel, vml
    torch.cuda.empty_cache()
    return out


def golden_steps():
    """The adv-diff grid's cells, diffusivities and step profiles, the
    steps' mouth values taken from the committed artifact's sulcus rows
    (as the study takes them from its own sulcus batch)."""
    from fenics_eff_uptake_tpu_torch.params import StepUptakeOpen
    from fenics_eff_uptake_tpu_torch.studies.adv_diff import (
        MU_FACTORS, PE_VALUES, STEP_GAMMA, create_base_parameters)
    with open(GOLDEN_AD_CSV, newline="") as f:
        opening = {(float(r["Pe"]), float(r["mu_factor"])):
                   float(r["mu_eff_open"]) for r in csv.DictReader(f)
                   if r["domain_type"] == "sulcus"}
    cells = [(float(pe), float(mf)) for pe in PE_VALUES for mf in MU_FACTORS]
    p = create_base_parameters(cells[0][0], 1.0, 0.02)
    steps = [StepUptakeOpen(
        mu_base=mf, mu_eff_target=opening[(pe, mf)],
        sulcus_left_x=p.L / 2 - p.sulci_w / 2,
        sulcus_right_x=p.L / 2 + p.sulci_w / 2, L_c=0.1 * p.sulci_w,
        Gamma=STEP_GAMMA) for pe, mf in cells]
    return p, [1.0 / pe for pe, _ in cells], steps


def rect_step_setup(dev):
    """The adv-diff study's rectangle batch, up to the solve: the mesh, its
    Stokes velocity, the advective system, the 9 columns' fine Robin batch
    and the step-mu hierarchy.  Returns (sys, ml, robin_matrices, D)."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, robin_matrices_for_mu)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, stokes_for_study)
    p, D, steps = golden_steps()
    mesh = make_mesh(p, "rectangular")
    u, _ = stokes_for_study(mesh, p.H, dev)
    sys_ = build_transport_system(mesh, dev, u_values=u.values,
                                  u_space=u.space)
    Rb = torch.stack([robin_matrices_for_mu(sys_, s) for s in steps])
    ml = build_multilevel_for(sys_, mesh, D, u_fine=u, mu_callables=steps,
                              robin_matrices_fine=Rb)
    return sys_, ml, Rb, D


def phase_kernels_advdiff(dev):
    """Kernel C's per-sample form at the adv-diff path's shapes (the
    rectangle at h = 0.02, B = 9): the fine Robin batch in f64 (the true
    residuals'; out= and full) and in f32 (every inner apply and fine
    smoothing), and both mid levels' batches in f32 (their smoothing).
    f64 1e-12, f32 2e-5 (summation order), as C's other cases.  Then the
    fine batch in bf16, and kernel A in f32 on the rectangle's fine
    advection band at B = 9.  Returns (per-sample cases, A's case, C's
    bf16 case)."""
    import torch
    sys_, ml, Rb, D = rect_step_setup(dev)
    B = len(D)
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(n, dtype):
        return torch.rand((n, B), generator=g, device=dev,
                          dtype=dtype) * 2 - 1

    fine = ml.levels[0].R_batch
    cases = []
    for label, blk, dtype, rtol, form in (
            ("f64 R", fine, torch.float64, 1e-12, "out"),
            ("f64 R", fine, torch.float64, 1e-12, "full"),
            ("f32 R", fine, torch.float32, 2e-5, "out"),
            ("f32 mid R", ml.levels[1].R_batch, torch.float32, 2e-5, "out"),
            ("f32 mid2 R", ml.levels[2].R_batch, torch.float32, 2e-5,
             "out")):
        cases.append(element_case(label, blk, rnd(blk.ndofs, dtype), None,
                                  rtol, form))
    c16 = element_case("R", fine.with_bf16(),
                       rnd(fine.ndofs, torch.bfloat16), None, 1e-5, "out")
    band = sys_.Advband
    a9 = band_case(f"A rectangle Adv band {tuple(band.shape)} B={B}", band,
                   sys_.Advspans,
                   rnd(band.shape[0] * band.shape[1], torch.float32), None)
    del sys_, ml, Rb
    torch.cuda.empty_cache()
    return cases, a9, c16


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _worst(tag, got, want, rel_cols, abs_cols=None):
    """Worst error per column of ``got`` rows (dicts of numbers) against
    ``want`` (the artifact's rows, text), both keyed alike: ``rel_cols``
    relative, ``abs_cols`` {column: scale(want row)} absolute over that
    scale.  Raises on a column above 1e-6."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"rows {sorted(got)} vs golden {sorted(want)}")
    worst = {c: 0.0 for c in (*rel_cols, *(abs_cols or {}))}
    for key, r in got.items():
        gr = want[key]
        for col in worst:
            if gr[col] == "":
                if r.get(col) is not None:
                    raise AssertionError(f"{key} {col}: {r[col]} where the "
                                         "artifact has none")
                continue
            v, ref = float(r[col]), float(gr[col])
            if not np.isfinite(v):
                raise AssertionError(f"{key} {col}: {v}")
            scale = abs(ref) if col in rel_cols else abs_cols[col](gr)
            worst[col] = max(worst[col], abs(v - ref) / scale)
    for col, e in worst.items():
        print(f"[{tag}] {col}: worst diff vs golden {e:.3e} (tol 1e-6)",
              flush=True)
    bad = {k: v for k, v in worst.items() if not v <= 1e-6}
    if bad:
        raise AssertionError(f"CSV columns off the golden artifact: {bad}")
    return worst


def check_against_golden(rows, stats):
    golden = _csv_rows(GOLDEN_CSV)
    if len(rows) != len(golden):
        raise AssertionError(f"{len(rows)} rows vs {len(golden)} golden")
    if stats["cells"] != BENCH_CELLS:
        print(f"[slice] FINDING: the mesher made {stats['cells']} cells on "
              f"this host, not the {BENCH_CELLS}-cell mesh of the golden "
              "CSV", flush=True)
    worst = {}
    for col in ("Mu_Eff_Simulation", "Total_Mass", "Mouth_Flux_Total"):
        errs = []
        for r, gr in zip(rows, golden):
            if r["Config"] != gr["Config"]:
                raise AssertionError(f"row order {r['Config']} vs "
                                     f"{gr['Config']}")
            v, ref = float(r[col]), float(gr[col])
            if not np.isfinite(v):
                raise AssertionError(f"{col} {r['Config']}: {v}")
            errs.append(abs(v - ref) / abs(ref))
        worst[col] = max(errs)
        print(f"[slice] {col}: worst rel diff vs golden {worst[col]:.3e} "
              f"(tol 1e-6)", flush=True)
    bad = {k: v for k, v in worst.items() if not v <= 1e-6}
    if bad:
        raise AssertionError(f"CSV columns off the golden artifact: {bad}")
    return worst


def zero_launches():
    """Set every wrapper's launch count to 0."""
    from fenics_eff_uptake_tpu_torch.ops.banded import (band_apply,
                                                        rect_band_apply)
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import ElementKernel
    band_apply.launches = rect_band_apply.launches = 0
    band_apply.launches_bf16 = rect_band_apply.launches_bf16 = 0
    rect_band_apply.launches_bf16_band = 0
    ElementKernel.launches = ElementKernel.launches_out = 0
    ElementKernel.launches_sample = ElementKernel.launches_bf16 = 0


PER_SAMPLE = "element_apply per-sample"
# the bf16 forms' counts (among each kernel's launches); B's two forms
# together, and the bf16-band, f32-X form apart
BF16_KEYS = ("band_apply bf16", "rect_band_apply bf16",
             "rect_band_apply bf16 band", "element_apply bf16")


def read_launches():
    """Launch counts by kernel; kernel C's split by form too (the keys
    ``element_apply full`` and ``element_apply out``), and its per-sample
    launches (of either form) among them."""
    from fenics_eff_uptake_tpu_torch.ops.banded import (band_apply,
                                                        rect_band_apply)
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import ElementKernel
    return {"band_apply": band_apply.launches,
            "rect_band_apply": rect_band_apply.launches,
            "element_apply": ElementKernel.launches,
            "element_apply out": ElementKernel.launches_out,
            "element_apply full": (ElementKernel.launches
                                   - ElementKernel.launches_out),
            PER_SAMPLE: ElementKernel.launches_sample,
            "band_apply bf16": band_apply.launches_bf16,
            "rect_band_apply bf16": (rect_band_apply.launches_bf16
                                     + rect_band_apply.launches_bf16_band),
            "rect_band_apply bf16 band": rect_band_apply.launches_bf16_band,
            "element_apply bf16": ElementKernel.launches_bf16}


def never_launched(launches, per_sample=False):
    """Names of the kernels a path never launched; C's per-sample form
    counts only on a path that has per-sample blocks.  The earlier paths
    run the default configuration: a bf16 launch there is a fault."""
    stray = [n for n in BF16_KEYS if launches[n] != 0]
    if stray:
        raise AssertionError(f"bf16 forms launched by a default "
                             f"configuration: {stray} in {launches}")
    return [n for n, c in launches.items()
            if c <= 0 and n not in BF16_KEYS
            and (per_sample or n != PER_SAMPLE)]


def phase_slice(dev):
    from fenics_eff_uptake_tpu_torch.studies.phase_a import run_mu_sweep

    zero_launches()
    rows, stats = run_mu_sweep(dev, 0.02, base_dir=str(OUT_DIR / "first"),
                               verbose=True)
    launches = read_launches()
    print(f"[slice] launches in the first run: {launches}", flush=True)
    rows2, stats2 = run_mu_sweep(dev, 0.02,
                                 base_dir=str(OUT_DIR / "steady"),
                                 verbose=False)
    print(f"[slice] cells {stats['cells']} ndofs {stats['ndofs']} "
          f"(padded {stats['ndofs_padded']})", flush=True)
    for tag, s in (("first", stats), ("steady", stats2)):
        print(f"[slice] {tag}: mesh {s['mesh_s']:.3f}s assembly "
              f"{s['assembly_s']:.3f}s ml_setup {s['ml_setup_s']:.3f}s "
              f"solve {s['solve_s']:.3f}s metrics {s['metrics_s']:.3f}s "
              f"total {s['total_s']:.3f}s = "
              f"{s['total_s'] / B_SWEEP:.4f} s/point", flush=True)
    print(f"[slice] iters {stats['iters']} passes {stats['passes']} "
          f"max_rel_resnorm {max(stats['rel_resnorm']):.3e}", flush=True)
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the sweep: "
                             f"{missing}")
    if not stats["multilevel"]:
        raise AssertionError("the sweep did not use the multigrid path")
    for s in (stats, stats2):
        if not max(s["rel_resnorm"]) <= 1e-11:
            raise AssertionError(f"max rel resnorm "
                                 f"{max(s['rel_resnorm']):.3e} > 1e-11")
        if not max(s["iters"]) <= 40:
            raise AssertionError(f"inner iterations {s['iters']} > 40")
    if stats2["iters"] != stats["iters"]:
        raise AssertionError(f"iterations differ between runs: "
                             f"{stats['iters']} vs {stats2['iters']}")
    worst = check_against_golden(rows, stats)
    for r, r2 in zip(rows, rows2):
        if r != r2:
            raise AssertionError(f"steady run differs: {r} vs {r2}")
    return launches, stats, stats2, worst


def check_no_uptake_golden(rows):
    """The six rows (reference sulcus and rectangle, each Pe) against the
    committed artifact's; returns the worst error per column."""
    golden = [r for r in _csv_rows(GOLDEN_NU_CSV)
              if r["Domain"] == "rectangle"
              or (r["Sulcus Width (mm)"], r["Sulcus Depth (mm)"])
              == ("0.5", "1.0")]

    def key(r):
        return r["Domain"], round(float(r["Peclet"]), 9)

    if len(golden) != 6:
        raise AssertionError(f"{len(golden)} golden rows, not 6")
    q_in = {key(r)[1]: abs(float(r["Mouth Q_in"]))
            for r in golden if r["Domain"] == "sulcus"}
    return _worst("no_uptake", {key(r): r for r in rows},
                  {key(r): r for r in golden}, NU_REL_COLUMNS,
                  {col: lambda gr: q_in[key(gr)[1]]
                   for col in NU_NET_COLUMNS})


def phase_no_uptake(dev):
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import \
        run_geometry_study

    zero_launches()
    rows, stats = run_geometry_study(["reference"], PECLET, 0.02,
                                     base_dir=str(OUT_DIR / "nu_first"),
                                     device=dev)
    launches = read_launches()
    print(f"[no_uptake] launches in the first run: {launches}", flush=True)
    rows2, stats2 = run_geometry_study(["reference"], PECLET, 0.02,
                                       base_dir=str(OUT_DIR / "nu_steady"),
                                       device=dev, verbose=False)
    for tag, st in (("first", stats), ("steady", stats2)):
        for s in st:
            print(f"[no_uptake] {tag} {s['geometry']} ({s['cells']} cells, "
                  f"{s['ndofs']} P2 dofs): mesh {s['mesh_s']:.3f}s "
                  f"stokes_setup {s['stokes_setup_s']:.3f}s stokes_solve "
                  f"{s['stokes_solve_s']:.3f}s assembly "
                  f"{s['assembly_s']:.3f}s ml_setup {s['ml_setup_s']:.3f}s "
                  f"solve {s['solve_s']:.3f}s metrics {s['metrics_s']:.3f}s "
                  f"total {s['total_s']:.3f}s", flush=True)
    for s in stats:
        print(f"[no_uptake] {s['geometry']}: MINRES {s['minres_iters']} "
              f"iters in {s['minres_passes']} passes, rel residual "
              f"{s['stokes_rel_resnorm']:.3e}; BiCGStab iters {s['iters']} "
              f"in {s['passes']} passes, max rel residual "
              f"{max(s['rel_resnorm']):.3e}", flush=True)
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the no-uptake "
                             f"study: {missing}")
    for s in stats + stats2:
        if not s["multilevel"]:
            raise AssertionError("the transport solve did not use the "
                                 "multigrid path")
        if not s["stokes_rel_resnorm"] <= 1e-9:
            raise AssertionError(f"Stokes rel residual "
                                 f"{s['stokes_rel_resnorm']:.3e} > 1e-9")
        if not max(s["rel_resnorm"]) <= 1e-11:
            raise AssertionError(f"transport rel residual "
                                 f"{max(s['rel_resnorm']):.3e} > 1e-11")
        if not s["minres_iters"] <= MINRES_BOUND:
            raise AssertionError(f"MINRES iterations {s['minres_iters']} > "
                                 f"{MINRES_BOUND}")
        if not all(i <= b for i, b in zip(s["iters"], BICGSTAB_BOUND)):
            raise AssertionError(f"BiCGStab iterations {s['iters']} above "
                                 f"{BICGSTAB_BOUND}")
    worst = check_no_uptake_golden(rows)
    if rows2 != rows:
        raise AssertionError("steady run's rows differ from the first's")
    return launches, stats, stats2, worst


def phase_adv_diff(dev):
    from fenics_eff_uptake_tpu_torch.studies import adv_diff

    # the study's two transport batches (sulcus, then rectangle) are told
    # apart by reading the counts around each of its transport_batch calls
    batch_launches = []
    transport_batch = adv_diff.transport_batch

    def counted(*args, **kwargs):
        n0 = read_launches()
        out = transport_batch(*args, **kwargs)
        batch_launches.append({k: v - n0[k]
                               for k, v in read_launches().items()})
        return out

    adv_diff.transport_batch = counted
    try:
        zero_launches()
        rows, stats = adv_diff.run_advdiff_step_validation(
            str(OUT_DIR / "ad_first"), 0.02, device=dev)
        launches = read_launches()
        print(f"[adv_diff] launches in the first run: {launches}",
              flush=True)
        rows2, stats2 = adv_diff.run_advdiff_step_validation(
            str(OUT_DIR / "ad_steady"), 0.02, device=dev, verbose=False)
    finally:
        adv_diff.transport_batch = transport_batch
    if len(batch_launches) != 4:
        raise AssertionError(f"{len(batch_launches)} transport batches in "
                             "two runs of the study, not 4")
    for s, n in zip(stats + stats2, batch_launches):
        s["launches"] = n
    for tag, st in (("first", stats), ("steady", stats2)):
        for s in st:
            print(f"[adv_diff] {tag} {s['domain']} ({s['cells']} cells, "
                  f"{s['ndofs']} P2 dofs): mesh {s['mesh_s']:.3f}s "
                  f"stokes_setup {s['stokes_setup_s']:.3f}s stokes_solve "
                  f"{s['stokes_solve_s']:.3f}s assembly "
                  f"{s['assembly_s']:.3f}s ml_setup {s['ml_setup_s']:.3f}s "
                  f"solve {s['solve_s']:.3f}s metrics {s['metrics_s']:.3f}s "
                  f"total {s['total_s']:.3f}s", flush=True)
    for s in stats:
        print(f"[adv_diff] {s['domain']}: MINRES {s['minres_iters']} iters "
              f"in {s['minres_passes']} passes, rel residual "
              f"{s['stokes_rel_resnorm']:.3e}; BiCGStab iters {s['iters']} "
              f"in {s['passes']} passes, max rel residual "
              f"{max(s['rel_resnorm']):.3e}; launches {s['launches']}",
              flush=True)
    missing = never_launched(launches, per_sample=True)
    if missing:
        raise AssertionError(f"kernels never launched by the adv-diff "
                             f"study: {missing}")
    for s in stats + stats2:
        if not s["multilevel"]:
            raise AssertionError("the transport solve did not use the "
                                 "multigrid path")
        if not s["stokes_rel_resnorm"] <= 1e-9:
            raise AssertionError(f"Stokes rel residual "
                                 f"{s['stokes_rel_resnorm']:.3e} > 1e-9")
        if not max(s["rel_resnorm"]) <= 1e-11:
            raise AssertionError(f"{s['domain']} transport rel residual "
                                 f"{max(s['rel_resnorm']):.3e} > 1e-11")
        if not s["minres_iters"] <= MINRES_BOUND:
            raise AssertionError(f"MINRES iterations {s['minres_iters']} > "
                                 f"{MINRES_BOUND}")
        bound = AD_BICGSTAB_BOUND[s["domain"]]
        if not all(i <= b for i, b in zip(s["iters"], bound)):
            raise AssertionError(f"{s['domain']} BiCGStab iterations "
                                 f"{s['iters']} above {bound}")
        # A and B by both batches; C's per-sample form by the rectangle's,
        # and by it alone (the sulcus batch shares one Robin block)
        n = s["launches"]
        rect = s["domain"] == "rectangular"
        if (n["band_apply"] <= 0 or n["rect_band_apply"] <= 0
                or n["element_apply out"] <= 0
                or (n[PER_SAMPLE] > 0) != rect):
            raise AssertionError(f"{s['domain']} batch launches: {n}")

    def key(r):
        return (round(float(r["Pe"]), 9), round(float(r["mu_factor"]), 9),
                r["domain_type"])

    def flux(gr):
        return abs(float(gr["total_flux"]))

    golden = _csv_rows(GOLDEN_AD_CSV)
    if len(rows) != 18 or len(golden) != 18:
        raise AssertionError(f"{len(rows)} rows vs {len(golden)} golden")
    worst = _worst("adv_diff", {key(r): r for r in rows},
                   {key(r): r for r in golden}, AD_REL_COLUMNS,
                   {"advective_flux": flux,
                    "flux_error_pct": lambda gr: 100.0})
    if rows2 != rows:
        raise AssertionError("steady run's rows differ from the first's")
    return launches, stats, stats2, worst


def phase_no_adv_studies(dev):
    """Phase-A's mu_eff study and Phase-B on two geometries, against the
    committed artifacts' rows."""
    from fenics_eff_uptake_tpu_torch.studies.phase_a import (
        run_mu_eff_analysis)
    from fenics_eff_uptake_tpu_torch.studies.phase_b import (
        run_no_adv_mu_sweep)

    zero_launches()
    me_rows, me_stats = run_mu_eff_analysis(
        dev, base_dir=str(OUT_DIR / "mu_eff"), verbose=False)
    pb_rows, pb_stats = run_no_adv_mu_sweep(
        dev, str(OUT_DIR / "phase_b"), geometries=PB_GEOMETRIES,
        verbose=False)
    launches = read_launches()
    print(f"[no_adv_studies] launches: {launches}", flush=True)
    stats = [dict(me_stats, study="mu_eff")] + [
        dict(s, study=f"phase_b {s['geometry']} {s['domain']}")
        for s in pb_stats]
    for s in stats:
        print(f"[no_adv_studies] {s['study']} ({s['cells']} cells): mesh "
              f"{s['mesh_s']:.3f}s assembly {s['assembly_s']:.3f}s ml_setup "
              f"{s['ml_setup_s']:.3f}s solve {s['solve_s']:.3f}s metrics "
              f"{s['metrics_s']:.3f}s total {s['total_s']:.3f}s; CG iters "
              f"{s['iters']} in {s['passes']} passes, max rel residual "
              f"{max(s['rel_resnorm']):.3e}", flush=True)
        if not s["multilevel"]:
            raise AssertionError(f"{s['study']} did not use the multigrid "
                                 "path")
        if not max(s["rel_resnorm"]) <= 1e-11:
            raise AssertionError(f"{s['study']}: rel residual "
                                 f"{max(s['rel_resnorm']):.3e} > 1e-11")
        if not max(s["iters"]) <= CG_BOUND:
            raise AssertionError(f"{s['study']}: CG iterations "
                                 f"{s['iters']} > {CG_BOUND}")
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the no-advection "
                             f"studies: {missing}")
    worst = _worst("no_adv_studies mu_eff",
                   {r["Config"]: r for r in me_rows},
                   {r["Config"]: r for r in _csv_rows(GOLDEN_MUEFF_CSV)},
                   MUEFF_COLUMNS)

    def key(r):
        return r["geometry"], round(float(r["mu_factor"]), 9)

    golden = [r for r in _csv_rows(GOLDEN_PB_CSV)
              if r["geometry"] in PB_GEOMETRIES]
    if len(pb_rows) != 6 or len(golden) != 6:
        raise AssertionError(f"{len(pb_rows)} Phase-B rows vs "
                             f"{len(golden)} golden")
    worst.update(_worst("no_adv_studies phase_b",
                        {key(r): r for r in pb_rows},
                        {key(r): r for r in golden}, PB_COLUMNS,
                        {"flux_error_pct": lambda gr: 100.0}))
    return launches, stats, worst


def _busy_ms(fn):
    """Device busy time of one fn(): torch.profiler's CUDA records summed
    (device records only); None where two traces in a row hold none."""
    us = _profiled_us(fn, cpu=False) or _profiled_us(fn, cpu=False)
    return us / 1e3 if us > 0 else None


def cycle_vs_plain(name, ml, R, **cycle_kw):
    """One application M(R) of a hierarchy's cycle through the kernels on
    the card against the same cycle through their plain versions on the
    card (``band_apply_plain``, ``rect_band_apply_plain``,
    ``element_apply_plain`` put in the wrappers' places for that one
    call), so that a solve that does not converge under this cycle cannot
    be a wrong kernel at these shapes.  Raises unless every entry of the
    kernels' result is finite and, for a cycle that rounds its vectors to
    bf16 (the bf16 cycle, or bf16 transfers, which round each transfer's
    input), >= 99% of the entries equal plain's and all lie within 4 bf16
    steps of max |M r| (2^-6) of it; for an f32 cycle, within 1e-4 of max
    |M r|.  The bf16 band kernels sum on the tensor cores in another order
    than the plain versions, and a difference in the last f32 bit can flip
    a later rounding to bf16 by one step, which the cycle carries on: a
    cycle with bf16 transfers is held to the bf16 bounds, not to the f32
    cycle's."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops import banded, elemspmv
    from fenics_eff_uptake_tpu_torch.parallel import sweep
    from fenics_eff_uptake_tpu_torch.solvers import multilevel

    M = multilevel.make_ml_preconditioner(ml, **cycle_kw)
    Mk = M(R)

    def plain_block(self, X, coef=None, out=None):
        return elemspmv.element_apply_plain(
            self.matrices(X.dtype), self.dofs, self.scatter, X, coef, out)

    kept = (multilevel.band_apply, multilevel.rect_band_apply,
            sweep._Block.apply_batched)
    n0 = read_launches()
    multilevel.band_apply = (
        lambda band, X, coef=None, spans=None:
        banded.band_apply_plain(band, X, coef))
    multilevel.rect_band_apply = (
        lambda band, offs, Xq, spans=None:
        banded.rect_band_apply_plain(band, offs, Xq))
    sweep._Block.apply_batched = plain_block
    try:
        Mp = M(R)
    finally:
        (multilevel.band_apply, multilevel.rect_band_apply,
         sweep._Block.apply_batched) = kept
    torch.cuda.synchronize()
    if read_launches() != n0:
        raise AssertionError(f"{name}: the plain cycle launched a kernel")
    if not bool(torch.isfinite(Mk).all() and torch.isfinite(Mp).all()):
        raise AssertionError(f"{name}: M(R) is not finite")
    scale = float(Mp.abs().max())
    err = float((Mk - Mp).abs().max()) / scale
    equal = float((Mk == Mp).float().mean())
    lowp = torch.bfloat16 in (cycle_kw.get("dtype"),
                              cycle_kw.get("transfer_dtype"))
    tol = 2.0 ** -6 if lowp else 1e-4
    print(f"[configs] {name}: one cycle M(R) on {tuple(R.shape)}, kernels "
          f"against plain on the card: max |diff| / max |M r| {err:.3e} "
          f"(tol {tol:.1e}), {100 * equal:.3f}% of the entries equal",
          flush=True)
    if not err <= tol or (lowp and not equal >= 0.99):
        raise AssertionError(f"{name}: the cycle through the kernels is "
                             f"{err:.3e} of max |M r| off the plain cycle, "
                             f"{equal:.4f} of the entries equal")
    return {"cycle_vs_plain_err": err, "cycle_vs_plain_equal": equal}


def run_config(tag, name, solve, X_ref=None, gate=True):
    """One configuration of a solve, three times: the first run counts the
    launches, the second is timed (steady solve seconds, device synced on
    both sides), the third is profiled (device busy ms; idle share of the
    steady seconds).  Held to a true f64 relative residual <= 1e-11 and,
    against ``X_ref``, to max |X - X_ref| < 1e-8.  ``gate`` False: a solve
    that does not converge is reported as a finding (one run, no times)
    and not raised."""
    import torch
    t_row = time.time()
    zero_launches()
    X, info = solve()
    launches = read_launches()
    torch.cuda.synchronize()
    if not gate and not bool(np.all(info["converged"])):
        row = {"config": name, "iters": np.asarray(info["iters"]).tolist(),
               "passes": info.get("passes"), "converged": False,
               "true_rel_resnorm": [float(v) for v in
                                    info["true_rel_resnorm"]],
               "launches": launches}
        print(f"[{tag}] FINDING {name}: did not converge: iters "
              f"{row['iters']} passes {row['passes']} true rel residuals "
              f"{row['true_rel_resnorm']} launches {launches}", flush=True)
        return X, row
    t0 = time.time()
    X2, info2 = solve()
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    busy = _busy_ms(solve)
    if not torch.equal(X, X2):
        raise AssertionError(f"{name}: two runs of the solve differ")
    res = float(np.max(info["true_rel_resnorm"]))
    dx = None if X_ref is None else float((X - X_ref).abs().max())
    row = {"config": name, "iters": np.asarray(info["iters"]).tolist(),
           "passes": info.get("passes"), "converged": True,
           "solve_s": solve_s,
           "device_busy_ms": busy,
           "idle_share": None if busy is None else 1 - busy / 1e3 / solve_s,
           "max_true_rel_resnorm": res, "max_dx": dx, "launches": launches,
           "row_s": time.time() - t_row}
    print(f"[{tag}] {name}: iters max {max(row['iters'])} "
          f"min {min(row['iters'])} passes {row['passes']} steady solve "
          f"{solve_s:.4f}s "
          + ("device busy and idle share not measured (no CUDA record) "
             if busy is None else
             f"device busy {busy:.2f} ms idle share {row['idle_share']:.3f} ")
          + f"max true rel residual {res:.3e} "
          f"max |X - X_default| {dx if dx is None else f'{dx:.3e}'} "
          f"launches {launches} ({row['row_s']:.1f}s for the row)",
          flush=True)
    if not res <= 1e-11:
        raise AssertionError(f"{name}: true rel residual {res:.3e} > 1e-11")
    if dx is not None and not dx < 1e-8:
        raise AssertionError(f"{name}: max |X - X_default| {dx:.3e} >= 1e-8")
    return X, row


def check_bf16_launches(name, launches, transfers=False, cycle=False):
    """The bf16 forms a configuration must have launched, and no other:
    ``transfers``: B's bf16-band, f32-X form alone; ``cycle``: A, B (all
    bf16) and C in bf16, and not the f32-X form."""
    want = {"band_apply bf16": cycle, "element_apply bf16": cycle,
            "rect_band_apply bf16 band": transfers,
            "rect_band_apply bf16": cycle or transfers}
    bad = {k: launches[k] for k, w in want.items()
           if (launches[k] > 0) != w}
    if cycle and launches["rect_band_apply bf16 band"] != 0:
        bad["rect_band_apply bf16 band"] = launches[
            "rect_band_apply bf16 band"]
    if bad:
        raise AssertionError(f"{name}: bf16 launches {bad} (expected "
                             f"{want}) in {launches}")


def phase_configs(dev):
    """Every solver configuration on the mu-sweep system at full width,
    the no-uptake transport solve under the mult cycle in f32 and bf16,
    and the Jacobi branch.  Returns (rows, summed launches)."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, operator_args, operator_rhs, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, stokes_for_study, sweep_mus)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    from fenics_eff_uptake_tpu_torch.studies.phase_a import (
        MU_SWEEP_REGIMES, run_mu_sweep)

    bf16 = torch.bfloat16

    def opening_residual(s, D, mu):
        # the f32 residual that opens the solve's first pass, and a seeded
        # random vector on the free rows beside it
        a64 = operator_args(s, D, mu, f32=False)
        G = s.bc_values[:, None].expand(-1, len(D)).contiguous()
        R = torch.where(s.free[:, None], operator_rhs(a64, G), 0.0).float()
        g = torch.Generator(device=dev).manual_seed(len(D))
        Z = torch.rand(R.shape, generator=g, device=dev) * 2 - 1
        return R, torch.where(s.free[:, None], Z, 0.0)

    def held_to_plain(name, h, Rs, kw):
        # every configuration with a bf16 form: its cycle through the
        # kernels against the cycle through their plain versions
        ckw = {("dtype" if k == "ml_dtype" else k): v for k, v in kw.items()
               if k in ("cycle", "ml_dtype", "transfer_dtype")}
        if bf16 not in ckw.values():
            return {}
        out = [cycle_vs_plain(f"{name}, {tag}", h, R, **ckw)
               for tag, R in zip(("opening residual", "random"), Rs)]
        return {k: (max if k.endswith("err") else min)(o[k] for o in out)
                for k in out[0]}

    factors = [f for r in MU_SWEEP_REGIMES.values() for f in r]
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    mesh = make_mesh(geom)
    mus = sweep_mus(geom, factors)
    D = [geom.D] * len(mus)
    sys_ = build_transport_system(mesh, dev)
    build_s = {}
    hier = {}
    # each hierarchy once (the earlier phases have built the like of it)
    for name, kw in (("lapack", {}),
                     ("newton_schulz", {"coarse_inverse": "newton_schulz"})):
        torch.cuda.synchronize()
        t0 = time.time()
        hier[name] = build_multilevel_for(sys_, mesh, D, mus, **kw)
        torch.cuda.synchronize()
        build_s[name] = time.time() - t0
    ml, ml_ns = hier["lapack"], hier["newton_schulz"]
    ns = ml_ns.info["coarse_inverse"]
    rel = float((ml_ns.Ainv - ml.Ainv).abs().max() / ml.Ainv.abs().max())
    print(f"[configs] hierarchy build seconds by coarsest inverse: "
          f"{ {k: round(v, 4) for k, v in build_s.items()} }; Newton-Schulz "
          f"{ns['iters']} iterations on {tuple(ml_ns.Ainv.shape)}, worst "
          f"max|I - A X| {ns['worst_residual']:.3e}, {rel:.3e} of max "
          f"|Ainv| from LAPACK's", flush=True)
    if not ns["worst_residual"] <= 1e-3:
        raise AssertionError(f"Newton-Schulz residual {ns}")

    configs = [
        ("default", ml, {}),
        ("transfer_dtype=bf16", ml, {"transfer_dtype": bf16}),
        ("ml_dtype=bf16", ml, {"ml_dtype": bf16}),
        ("cycle=add", ml, {"cycle": "add"}),
        ("cycle=mult", ml, {"cycle": "mult"}),
        ("cycle=mult ml_dtype=bf16", ml, {"cycle": "mult",
                                          "ml_dtype": bf16}),
        ("cheap_passes=0", ml, {"cheap_passes": 0}),
        ("precision=f64 cycle=mult", ml, {"precision": "f64",
                                          "cycle": "mult"}),
        ("coarse_inverse=newton_schulz", ml_ns, {}),
    ]
    rows, X_ref = [], None
    Rs = opening_residual(sys_, D, mus)
    for name, h, kw in configs:
        held = held_to_plain(name, h, Rs, kw)
        X, row = run_config(
            "configs", name,
            lambda: solve_sweep(sys_, D, mus, multilevel=h, **kw), X_ref)
        row.update(held)
        X_ref = X if X_ref is None else X_ref
        check_bf16_launches(name, row["launches"],
                            transfers=name == "transfer_dtype=bf16",
                            cycle=name.endswith("ml_dtype=bf16"))
        rows.append(dict(row, path="mu_sweep"))
    f64 = next(r for r in rows
               if r["config"].startswith("precision=f64"))["launches"]
    if f64["band_apply"] or f64["rect_band_apply"] or not f64[
            "element_apply full"]:
        raise AssertionError(f"the f64 solve's launches: {f64}")
    rows[0]["hierarchy_build_s"] = build_s
    del sys_, ml, ml_ns, hier, X_ref, Rs
    torch.cuda.empty_cache()

    # the no-uptake transport solve: the mult cycle's fine band applies
    # sit inside M, in f32 and in bf16 side by side.  BiCGStab needs a
    # fixed linear M; a cycle that rounds its vectors to bf16 is neither,
    # and the solve may stall or break down: the f32 row is held to the
    # gates, the bf16 rows are reported as they come
    p0 = _make_params(PECLET[0], 0.5, 1.0, 0.02)
    mesh = make_mesh(p0, "sulcus")
    u, _ = stokes_for_study(mesh, p0.H, dev)
    D = [1.0 / pe for pe in PECLET]
    mu0 = [0.0] * len(D)
    adv = build_transport_system(mesh, dev, u_values=u.values,
                                 u_space=u.space)
    aml = build_multilevel_for(adv, mesh, D, mu0, u_fine=u)
    X_ref = None
    Rs = opening_residual(adv, D, mu0)
    for name, kw in (("no_uptake mult f32", {}),
                     ("no_uptake mult bf16", {"ml_dtype": bf16}),
                     ("no_uptake mult bf16 transfers",
                      {"transfer_dtype": bf16})):
        held = held_to_plain(name, aml, Rs, dict(kw, cycle="mult"))
        X, row = run_config(
            "configs", name,
            lambda: solve_sweep(adv, D, mu0, multilevel=aml, **kw), X_ref,
            gate=not kw)
        row.update(held)
        X_ref = X if X_ref is None else X_ref
        check_bf16_launches(name, row["launches"],
                            transfers=name.endswith("transfers"),
                            cycle=name.endswith("bf16"))
        rows.append(dict(row, path="no_uptake"))
        if not kw and row["iters"] != [15, 28, 171]:
            print(f"[configs] FINDING: the f32 mult solve read "
                  f"{row['iters']}, not the study's [15, 28, 171]",
                  flush=True)
    del adv, aml, X_ref, Rs
    torch.cuda.empty_cache()

    # the Jacobi branch: no hierarchy at h >= 0.08
    zero_launches()
    _, st = run_mu_sweep(dev, 0.08, base_dir=str(OUT_DIR / "jacobi"),
                         verbose=False)
    jl = read_launches()
    print(f"[configs] Jacobi branch (h = 0.08, {st['cells']} cells): CG "
          f"iters max {max(st['iters'])} in {st['passes']} passes, solve "
          f"{st['solve_s']:.3f}s, max rel residual "
          f"{max(st['rel_resnorm']):.3e}, launches {jl}", flush=True)
    if st["multilevel"]:
        raise AssertionError("h = 0.08 built a hierarchy")
    if not max(st["rel_resnorm"]) <= 1e-11:
        raise AssertionError(f"Jacobi branch: rel residual "
                             f"{max(st['rel_resnorm']):.3e} > 1e-11")
    if jl["rect_band_apply"] or not jl["band_apply"]:
        raise AssertionError(f"Jacobi branch launches: {jl}")
    rows.append({"config": "jacobi h=0.08", "path": "mu_sweep",
                 "iters": st["iters"], "passes": st["passes"],
                 "converged": True, "solve_s": st["solve_s"], "launches": jl,
                 "max_true_rel_resnorm": max(st["rel_resnorm"])})
    total = {k: sum(r["launches"][k] for r in rows)
             for k in rows[0]["launches"]}
    return rows, total


def _cprofile(tag, fn):
    """cProfile of fn(): the top 40 entries by cumulative time printed,
    60 written to build/chip_smoke/profile_<tag>.txt; returns fn()."""
    pr = cProfile.Profile()
    pr.enable()
    out = fn()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(60)
    (OUT_DIR / f"profile_{tag}.txt").write_text(buf.getvalue())
    rows = []
    for (fname, line, func), (_, nc, tt, ct, _) in pstats.Stats(
            pr).stats.items():
        rows.append((ct, tt, nc, f"{Path(fname).name}:{line}({func})"))
    for ct, tt, nc, name in sorted(rows, reverse=True)[:40]:
        print(f"[profile {tag}] cum {ct:8.3f}s own {tt:8.3f}s {nc:7d}x "
              f"{name}", flush=True)
    return out


def _device_profile(tag, fn):
    """fn() twice to warm, three unprofiled walls, then torch.profiler of
    one more: device busy time, idle share of the median wall, and device
    time by kernel (top 15 printed, all in build/chip_smoke/
    profile_<tag>.txt, the timeline in <tag>_trace.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, per = 0.0, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if str(e.device_type).endswith("CUDA") and us > 0:
            busy += us
            n_us = per.setdefault(e.name[:70], [0, 0.0])
            n_us[0] += 1
            n_us[1] += us
    wall = float(np.median(walls))
    print(f"[profile {tag}] steady wall {[round(w, 4) for w in walls]} s "
          f"(unprofiled); device busy {busy / 1e3:.3f} ms -> idle share "
          f"{1 - busy / 1e6 / wall:.3f} of the median wall", flush=True)
    table = sorted(per.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in table[:15]:
        print(f"[profile {tag}] device {us / 1e3:8.3f} ms {n:6d}x {name}",
              flush=True)
    (OUT_DIR / f"profile_{tag}.txt").write_text("".join(
        f"{us / 1e3:10.3f} ms {n:7d}x {name}\n"
        for name, (n, us) in table))
    prof.export_chrome_trace(str(OUT_DIR / f"{tag}_trace.json"))


def phase_profile(dev):
    """Host cProfile of one steady mu sweep and one steady no-uptake study
    (reference geometry and rectangle); device profiles of one steady
    mu-sweep CG solve, one Stokes saddle solve, one BiCGStab solve of
    the reference geometry, and the step-mu BiCGStab solve of the adv-diff
    study's rectangle batch."""
    import torch
    from fenics_eff_uptake_tpu_torch.models.stokes_flow import (
        saddle_solve, stokes_setup)
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, no_adv_batch, stokes_for_study,
        sweep_mus)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import (
        _make_params, run_geometry_study)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import MU_SWEEP_REGIMES

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    factors = [f for r in MU_SWEEP_REGIMES.values() for f in r]
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    _, st = _cprofile("sweep", lambda: no_adv_batch(geom, factors, "sulcus",
                                                    dev, verbose=False))
    print("[profile sweep] stages: " + " ".join(
        f"{k} {st[k]:.3f}s" for k in ("mesh_s", "assembly_s", "ml_setup_s",
                                      "solve_s", "metrics_s", "total_s")),
        flush=True)
    mesh = make_mesh(geom)
    mus = sweep_mus(geom, factors)
    D = [geom.D] * len(mus)
    sys_ = build_transport_system(mesh, dev)
    ml = build_multilevel_for(sys_, mesh, D, mus)
    _device_profile("solve", lambda: solve_sweep(sys_, D, mus,
                                                 multilevel=ml))
    del sys_, ml

    _cprofile("no_uptake", lambda: run_geometry_study(
        ["reference"], PECLET, 0.02, base_dir=str(OUT_DIR / "nu_profile"),
        device=dev, verbose=False))
    p0 = _make_params(PECLET[0], 0.5, 1.0, 0.02)
    mesh = make_mesh(p0, "sulcus")
    stk = stokes_setup(mesh, p0.H, dev)
    _device_profile("stokes", lambda: saddle_solve(stk))
    del stk
    u, _ = stokes_for_study(mesh, p0.H, dev)
    D = [1.0 / pe for pe in PECLET]
    mu0 = [0.0] * len(D)
    sys_ = build_transport_system(mesh, dev, u_values=u.values,
                                  u_space=u.space)
    ml = build_multilevel_for(sys_, mesh, D, mu0, u_fine=u)
    _device_profile("bicgstab", lambda: solve_sweep(sys_, D, mu0,
                                                    multilevel=ml))
    del sys_, ml
    # the adv-diff study's rectangle batch: 9 columns, per-sample Robin
    sys_, ml, Rb, D = rect_step_setup(dev)
    _device_profile("bicgstab_stepmu", lambda: solve_sweep(
        sys_, D, multilevel=ml, robin_matrices=Rb))
    del sys_, ml, Rb
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile both paths (host and device)")
    args = ap.parse_args(argv)
    t_start = time.time()
    if not (ROOT / "fenics_eff_uptake_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenics_eff_uptake_tpu_torch/ is not "
                         f"beside this script in {ROOT}; run it from a "
                         "checkout of the repository")
    card = phase_device()
    os.environ.setdefault("FEU_CACHE_DIR", str(ROOT / "build" / "cache"))
    sys.path.insert(0, str(ROOT))
    import torch
    from fenics_eff_uptake_tpu_torch.device import setup
    from fenics_eff_uptake_tpu_torch.ops import _build

    dev = setup("cuda")
    t0 = time.time()
    lib_path = _build.build()
    _build.library()
    build_s = time.time() - t0
    print(f"[build] {lib_path.name} ready in {build_s:.1f}s", flush=True)

    phase_s = {"build": build_s}

    def timed(name, fn):
        t = time.time()
        out = fn(dev)
        phase_s[name] = time.time() - t
        print(f"[time] {name}: {phase_s[name]:.1f}s", flush=True)
        return out

    cases = timed("kernels", phase_kernels)
    for name, cs in timed("kernels_flow", phase_kernels_flow).items():
        cases[name] += cs
    cases[PER_SAMPLE], a9, c16 = timed("kernels_advdiff",
                                       phase_kernels_advdiff)
    cases["band_apply"].append(a9)
    cases["element_apply bf16"].append(c16)
    launches, stats, stats2, worst = timed("slice", phase_slice)
    nu_launches, nu_stats, nu_stats2, nu_worst = timed("no_uptake",
                                                       phase_no_uptake)
    ad_launches, ad_stats, ad_stats2, ad_worst = timed("adv_diff",
                                                       phase_adv_diff)
    na_launches, na_stats, na_worst = timed("no_adv_studies",
                                            phase_no_adv_studies)
    cfg_rows, cfg_launches = timed("configs", phase_configs)
    if args.profile:
        phase_profile(dev)

    # the per-sample form is kernel C's source and its own row: the JAX
    # package has no Pallas kernel for it, only the unrolled multiply-adds
    # of _Block.apply_batched
    meta = {
        "band_apply": ("band_apply.cu", f"{PALLAS}:155"),
        "rect_band_apply": ("band_apply.cu", f"{PALLAS}:274"),
        "element_apply": ("element_apply.cu", f"{PALLAS}:51"),
        PER_SAMPLE: ("element_apply.cu", f"{JAX_SWEEP}:104"),
        # the bf16 operand forms: the TPU kernels' bf16 branches; launched
        # by the configs phase alone
        "band_apply bf16": ("band_apply.cu", f"{PALLAS}:138"),
        "rect_band_apply bf16": ("band_apply.cu", f"{PALLAS}:258"),
        "element_apply bf16": ("element_apply.cu", f"{PALLAS}:51"),
    }
    by_path = {"mu_sweep": launches, "no_uptake": nu_launches,
               "adv_diff": ad_launches, "no_adv_studies": na_launches,
               "configs": cfg_launches}
    unlaunched = [n for n in meta if sum(p[n] for p in by_path.values()) <= 0]
    if unlaunched:
        raise AssertionError(f"kernels no path launched: {unlaunched}")
    kernels = []
    for name, (src, replaces) in meta.items():
        cs = cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": replaces,
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {k: n[name] for k, n in by_path.items()},
            **({"launches_by_form": {
                form: sum(n[f"{name} {form}"] for n in by_path.values())
                for form in ("full", "out")}}
               if name == "element_apply" else {}),
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "max_rel_err": max(c["max_rel_err"] for c in cs),
            # the kernel's first case (the first with a device time,
            # should the profiler have been lost on the way)
            **{k: next((c for c in cs if c["ms"] is not None), cs[0])[k]
               for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")},
            "cases": cs})
    summary = {"card": card, "build_s": build_s, "kernels": kernels,
               "first": stats, "steady": stats2, "golden_worst": worst,
               "no_uptake_first": nu_stats, "no_uptake_steady": nu_stats2,
               "no_uptake_golden_worst": nu_worst,
               "adv_diff_first": ad_stats, "adv_diff_steady": ad_stats2,
               "adv_diff_golden_worst": ad_worst,
               "no_adv_studies": na_stats,
               "no_adv_studies_golden_worst": na_worst,
               "configs": cfg_rows, "phase_s": phase_s,
               "wall_s": time.time() - t_start}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"[done] wall {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
