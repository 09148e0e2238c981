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
   n B rows, applied to the batch-minor X seen as one long column.
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
# iteration bounds of the no-uptake phase: twice an early CPU run of the
# port's path (reference geometry, h = 0.035, the finest run on the CPU:
# MINRES 130 over 2 passes; BiCGStab per Pe column 16, 29, 158), kept as
# they were set.  Today
#   python -m fenics_eff_uptake_tpu_torch.studies.no_uptake \
#       --geometries reference --mesh-size 0.035 --device cpu
# prints MINRES 132 (sulcus) and 123 (rectangle), BiCGStab [16, 29, 166]
# and [16, 29, 226]
MINRES_BOUND = 260
BICGSTAB_BOUND = [32, 58, 316]
# iteration bounds of the adv-diff phase: twice what
#   python -m fenics_eff_uptake_tpu_torch.studies.adv_diff \
#       --mesh-size 0.035 --device cpu
# prints for the full 3 x 3 grid (columns Pe-major: Pe 0.1, 1, 10, each with
# mu factors 0.1, 1, 10): MINRES 132 (sulcus) and 123 (rectangle), within
# MINRES_BOUND; BiCGStab, 4 passes each,
# sulcus [16, 15, 16, 25, 19, 16, 106, 67, 64] and
# rectangle [15, 15, 14, 24, 19, 16, 108, 72, 66]
AD_BICGSTAB_BOUND = {
    "sulcus": [32, 30, 32, 50, 38, 32, 212, 134, 128],
    "rectangular": [30, 30, 28, 48, 38, 32, 216, 144, 132]}
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
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s, and
# FLOP/s outside the tensor cores by element size
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


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


def device_ms(fn, calls=20, warmup=3):
    """Device time of one call of fn: the durations of the CUDA records
    (kernels, copies, fills) that torch.profiler takes over ``calls``
    calls, summed, over the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if str(e.device_type).endswith("CUDA"))
    if not us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / calls / 1e3


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


def band_bounds(band, spans, n_in, n_out, B, extra_bytes=0):
    """Dense and span bounds of a band apply: the band (whole, or its
    spans' elements) read once, X (n_in, B) read once, Y (n_out, B)
    written once, 2 * B FLOPs per band element."""
    io = 4 * B * (n_in + n_out) + extra_bytes
    dense = band.numel()
    sp = span_elements(band, spans)
    return {"dense": bound_ms(4 * dense + io, 2 * B * dense, 4),
            "span": bound_ms(4 * sp + io + spans.numel() * 4, 2 * B * sp,
                             4),
            "span_fill": sp / dense}


def compare(label, kernel, plain, rtol, library=None, bounds=None,
            check=None):
    """Kernel vs plain on the same inputs: errors, device times per call
    of the kernel, the plain version and the library call, the kernel's
    per-call time, and the bounds (``bounds``: "span" and, for the band
    kernels, "dense" (ms, what binds) pairs).  ``check``, where given,
    makes the two outputs compared (the out= form's calls accumulate)."""
    import torch
    yk, yp = check() if check is not None else (kernel(), plain())
    torch.cuda.synchronize()
    if not bool(torch.isfinite(yk).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    abs_err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    ms = device_ms(kernel)
    call_ms = median_ms(kernel)
    plain_ms = device_ms(plain)
    lib_ms = None if library is None else device_ms(library)
    span, by = bounds["span"]
    out = {"case": label, "max_abs_err": abs_err, "max_rel_err": rel,
           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": span, "bound_by": by,
           "share": span / ms}
    text = (f"[kernels] {label}: max_abs_err {abs_err:.3e} max_rel_err "
            f"{rel:.3e} (tol {rtol:.0e}) device: kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
            + f"; per call {call_ms:.4f} ms")
    if "dense" in bounds:
        d, dby = bounds["dense"]
        out.update(dense_bound_ms=d, dense_bound_by=dby,
                   span_fill=bounds["span_fill"])
        text += (f"; bound dense {d:.4f} ms ({dby}), span {span:.4f} ms "
                 f"({by}, {100 * bounds['span_fill']:.1f}% of the band)")
    else:
        text += f"; bound {span:.4f} ms ({by})"
    print(f"{text}; share of the bound {span / ms:.3f}", flush=True)
    if not rel <= rtol:
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
    return compare(
        label, lambda: band_apply(band, X, coef, spans=spans),
        lambda: band_apply_plain(band, X, coef), rtol,
        library=lambda: torch.bmm(band, win.transpose(1, 2)),
        bounds=band_bounds(band, spans, n, n, B,
                           0 if coef is None else 4 * B))


def rect_case(label, band, offs, spans, Xq, rtol=1e-5):
    """Kernel B on one transfer band: kernel, plain, and the plain
    version's one cuBLAS call (bmm on the gathered windows, the gather
    before the timing)."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.banded import (
        rect_band_apply, rect_band_apply_plain)
    T, R, W = band.shape
    idx = offs.long()[:, None] + torch.arange(W, device=Xq.device)
    win = Xq[idx].contiguous()
    return compare(
        label, lambda: rect_band_apply(band, offs, Xq, spans),
        lambda: rect_band_apply_plain(band, offs, Xq), rtol,
        library=lambda: torch.bmm(band, win),
        bounds=band_bounds(band, spans, Xq.shape[0], T * R, Xq.shape[1],
                           4 * T))


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
    f64 1e-12, f32 2e-5 (summation order), as C's other cases."""
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
    del sys_, ml, Rb
    torch.cuda.empty_cache()
    return cases


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
    ElementKernel.launches = ElementKernel.launches_out = 0
    ElementKernel.launches_sample = 0


PER_SAMPLE = "element_apply per-sample"


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
            PER_SAMPLE: ElementKernel.launches_sample}


def never_launched(launches, per_sample=False):
    """Names of the kernels a path never launched; C's per-sample form
    counts only on a path that has per-sample blocks."""
    return [n for n, c in launches.items()
            if c <= 0 and (per_sample or n != PER_SAMPLE)]


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

    cases = phase_kernels(dev)
    for name, cs in phase_kernels_flow(dev).items():
        cases[name] += cs
    cases[PER_SAMPLE] = phase_kernels_advdiff(dev)
    launches, stats, stats2, worst = phase_slice(dev)
    nu_launches, nu_stats, nu_stats2, nu_worst = phase_no_uptake(dev)
    ad_launches, ad_stats, ad_stats2, ad_worst = phase_adv_diff(dev)
    na_launches, na_stats, na_worst = phase_no_adv_studies(dev)
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
    }
    by_path = {"mu_sweep": launches, "no_uptake": nu_launches,
               "adv_diff": ad_launches, "no_adv_studies": na_launches}
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
            **{k: cs[0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
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
