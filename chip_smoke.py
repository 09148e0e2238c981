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
   in f64: the card's row of the port's utils/roofline.PEAKS, which has
   only the H100 SXM's, so another card stops the run here): for A and B
   both over the whole band (dense) and over the
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
   phase launches it.  At B = 1, the per-run models' width: A on the
   mu sweep's fine K band (with and without coef), on its mid band and on
   the rectangle's advection band; B on the fine restriction and
   prolongation; C in f64 on K (full) and on the Robin block (out=), and
   the per-sample f64 Robin block of one column (out=).  At the sharded
   phase's shapes, on the element chunks its last rank holds
   (``sharded_solve._split_block``: ceil(N / 2) elements padded with zero
   matrices at a repeated dummy dof, bound with every row of the full
   vector): C in f64 on the mu sweep's K chunk (full) and R chunk (out=)
   at B = 10, on the replicated mid level's K and R at B = 10, on the
   reference geometry's velocity K and advection chunks at B = 2 (full),
   and the per-sample form on the rectangle's Robin chunk at the last
   sweep row's B = 5 columns (out= and full); the full form of every C
   case must write zeros on the rows its block does not touch.
   Bounds count 2-byte bands and X;
   the library calls are the cuBLAS bmm on bf16 windows (f32 output where
   the kernel's is) and, for C, the f32 cuSPARSE call on upcast operands.
   Tolerances: an f32 output within 1e-5 of the row's sum of |terms|; a
   bf16 output equal to plain's in >= 99% of the entries and within one
   bf16 ulp of it (or, where cancellation leaves a result far below its
   terms, within that f32 bound).
   Last the graded cases (``phase_kernels_graded``): the w0.4/d2.0
   sulcus at h = 0.02 with its mouth refined 8 times (92,995 cells, hmin
   1.85e-3, the fine K band (735, 256, 2816)), under its solved Stokes
   velocity, at the E_L1 ladder's B = 3: A on the fine K band (with coef)
   and the fine advection band, B on the fine restriction and
   prolongation and on the first mid level's restriction (the graded P1
   mesh into the ungraded P1 mesh at 3h, in windows wider than the JAX
   package's width menu of at most 4,096 columns: ops/band_plans.py), C
   in f64 on the K block (full, 1e-12) and in f32 on the Robin block
   (out=, 2e-5), each with its library call, span fill and bound.
4. slice: the 20-point Phase-A mu sweep at h = 0.02 through
   studies.phase_a.run_mu_sweep, twice (first and steady run).  Checks that
   every kernel (C in both forms) was launched by the first run, the true f64 relative
   residuals (<= 1e-11), the inner iterations (<= 40 per column), and the
   CSV columns against the committed JAX artifact
   examples/phase_a_tpu_h0.02 (1e-6 relative).  Prints, on a line of its
   own with the card's name and power limit, ``roofline_summary`` of the
   steady run's solve (utils/roofline.py's model of one iteration on the
   sweep's system and hierarchy, over the solve's seconds).
4b. twolevel: the same workload (the ``bench.py`` sweep: h = 0.02, B =
   20) in mixed precision under the two-level preconditioner of
   solvers/twolevel.py on the coarse mesh at h = 0.08
   (``simulation.get_coarse_mesh``'s), per-sample coarse inverses and
   then the Woodbury form, each built cold and solved twice: every
   column's true f64 relative residual <= 1e-11, X within 1e-8 of max |X|
   of the multigrid solve of the same system (the slice's, solved again),
   the Woodbury X within 1e-8 of the per-sample X, the second solve equal
   to the first, and kernels A and C (both forms) launched by the solve,
   B and the bf16 forms not.  Prints the iterations, passes, setup and
   solve seconds, the coarse inverses' MB on the card and the launches of
   A and C on a line per form.
5. no_uptake: the no-uptake study on the reference geometry (w = 0.5,
   d = 1.0 mm), the profile geometries ``largest`` (1.0 x 2.0) and
   ``square_small`` (0.2 x 0.2) and the rectangle at h = 0.02, Pe = 0.1,
   1, 10, through studies.no_uptake.run_geometry_study, twice (first and
   steady run): Stokes MINRES+MG, then one batched BiCGStab over the three
   Pe.  Prints the seconds of every stage; checks that kernels A, B and C
   (C in both forms) were launched by the first run, the true f64
   relative residuals (Stokes <= 1e-9, transport <= 1e-11 in every
   column), the iteration bounds (reference and rectangle, which have
   card records; the two profile geometries' counts are printed), the 12
   CSV rows against the committed JAX artifact
   examples/no_uptake_tpu_h0.02 (1e-6 relative; the signed net fluxes
   1e-6 max(|Mouth Q_in|, 1e-3) absolute, studies/artifacts.py), the two
   geometries' Profiles/ CSVs against
   the artifact's (every row; sample coordinates to 1e-12, c and the line
   statistics to 1e-6 of max(|c|, 1e-3), sample counts exactly), and that
   the steady run's rows and profile CSVs equal the first run's.

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

9. mesh_convergence: studies.mesh_convergence.run_mesh_convergence with
   the default ladder (h = 0.08, 0.057, 0.04, 0.028, 0.02 on the 0.5 x 1.0
   mm sulcus, mu factors 0.1, 1, 10) and the realisation check (a second
   mesh at h = 0.0201): residuals <= 1e-11 on every rung, CG <= 40 on the
   multigrid rungs (h = 0.08 takes Jacobi), every kernel launched, the 15
   rows against examples/mesh_convergence_tpu_h0.02 (1e-6 relative), the
   Richardson orders and extrapolated limits against its
   study_metadata.json (1e-4 relative); the realisation floors printed
   beside the artifact's.

9b. el1: the E_L1 refinement ladder of the w = 0.05, d = 1.0 mm sulcus at
   h = 0.02 through studies.el1_convergence.run_rung at exactly the
   committed (factor, Pe) pairs of examples/el1_convergence (factors 1, 2
   and 4 at Pe 0.1, 1, 10; factor 8 at Pe 0.1), the memos released after
   each rung: every rung's Stokes and transport solves converged (true f64
   relative residuals <= 1e-9 and <= 1e-11), A, B and C (both forms)
   launched by every rung, every rung held to the committed JAX rungs of
   the same (factor, Pe) (cells exactly, hmin 1e-12, E_L1, Q_in, Q_out
   1e-6 relative, J_open_total 1e-6 of max(|Q_in|, 1e-3)) and its
   factor-1 rungs to the no-uptake artifact's rows, and every committed
   summary (E* 1e-3 relative, rate 0.02, the same verdict).  Prints per
   rung the cells, hmin, bands (T, R, W) and span fills, MINRES and
   BiCGStab iterations and passes, stage seconds and peak card memory.

10. setup_cache: the mu sweep and the no-uptake study on the reference
   geometry (with its rectangle), run (a) cold in a child process on an
   empty cache directory, (b) disk-warm in a second child process on the
   directory (a) filled, and in this process (c) once more on that
   directory with the memos emptied (disk-warm, in-process) and (d) again
   (memo-warm).  Prints each run's stage seconds, s/point and s/geometry,
   the cache's hits per tag and the seconds its reads and writes took;
   checks that X (every column of both studies), the iterations, passes
   and CSV rows are bit-equal across the four runs and that the warm runs
   hit (disk hits in (b) and (c), memo hits in (d)) and missed nothing.

11. per_run: ``simulation.run_simulation`` at h = 0.02 in its three
   modes, each run twice (cold, then memo-warm, its timings printed):
   no-adv on the mu sweep's sulcus for three rows of
   examples/phase_a_tpu_h0.02 (Mu_Eff_Simulation, Mu_Eff_Opening,
   Total_Mass, Mouth_Flux_Total within 1e-6 relative; CG <= 40), no-uptake
   on the reference geometry at Pe = 1 against its row of
   examples/no_uptake_tpu_h0.02 (the phase-5 gates; BiCGStab within the
   Pe = 1 bound), adv-diff there at Pe = 1, mu factor 1 against the port's
   batched path on the same mesh, velocity and coefficients (1e-9
   relative); every transport residual <= 1e-11, the warm run's c equal
   to the cold's; kernels A, B and C (full and out=) launched by the three
   modes at B = 1.  The memo-warm runs of the first no-adv row and of
   no-uptake write their ParaView files (``save_paraview=True``), read
   back: every grid's POINTS is the mesh's vertex count, the c, p and u
   values are the run's own vertex values as %.16g wrote them (exactly;
   within 1e-15 relative of the f64 values: 16 digits do not round-trip
   every f64), and the paraview stage's seconds are printed;
   ``plot=True`` must raise ImportError where matplotlib is absent (as on
   the card's machine) and write the figures where it is present.  Then
   GMRES (``advdiff_solve(solver="auto")``, Pe = 40,
   the 16 x 8 rectangle) against BiCGStab (1e-8) with its true residual
   <= 1e-13, and the Stokes options on the 5 x 1 sulcus at h = 0.15: the
   Schur fallback (f64) against MINRES + MG (u 1e-8, p 1e-6),
   the outlet pin (p 1e-5 of max |p|, u 1e-5), and f64 against mixed
   MINRES at h = 0.05 on the reference geometry (u 1e-8, p 1e-6 of max
   |p|).

12. sharded: the sharded path (``parallel/sharded_solve.py``) on the one
   card: 4 rank processes (2 sweep rows x 2 cells ranks, gloo, the CUDA
   tensors all-reduced where they lie) started once for the phase, then
   (a) the Phase-A mu sweep at h = 0.02 through ``run_mu_sweep(shard=)``
   (B = 20, 10 columns per sweep row): rows within 1e-8 of
   examples/phase_a_tpu_h0.02, X within 1e-9 of the unsharded solve of the
   same system built on the card (the study builds a sharded batch's
   system and hierarchy on the CPU and sends host copies), each rank
   holding half the fine element arrays; (b) the
   no-uptake study on the reference geometry and the rectangle (sharded
   f64 MINRES, then Pe 0.1, 1, 10 padded to 4): rows within 1e-8 of
   examples/no_uptake_tpu_h0.02 (compare_sharded_study.py's floors), u and
   p within 1e-7 of the unsharded field; (c) the adv-diff validation on
   both domains (B = 9 padded to 10, per-sample Robin on the rectangle;
   the Stokes fields are (b)'s, from the setup cache): rows within 1e-7 of
   the adv_diff phase's.  All-reduces per iteration must be 3 (MG-CG), 3
   (MINRES) and 6 (BiCGStab); kernel C's full, out= and per-sample forms
   must launch in the ranks (every block apply there a launch, checked in
   each rank), and nothing else; the launches come back as the
   ``sharded`` path.  Last the mu sweep's solve again at world size 1 on
   nccl (X within 1e-9).  Prints iterations, true residuals, all-reduces
   per iteration, spawn and solve seconds and the per-rank bytes of the
   fine element arrays against the unsharded system's, and what the
   parent process holds on the card (its Stokes setup's peak; its bytes
   while the ranks solve).  The study's sharded calls are read from the
   rank group's ``log``.

Every study phase (4, 4b, 5-7, 9, 9b, 11) starts on an empty cache directory
of its own with the memos emptied, so its first run is cold and its
steady run warm;
the directories lie under a fresh build/cache/run-* of this run, removed
at its end.

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
import shutil
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
# the rows of every study are held to the committed artifacts through
# fenics_eff_uptake_tpu_torch/studies/artifacts.py (its columns and
# tolerances), which the study runner run_studies.py uses too
PB_GEOMETRIES = ["reference", "square_medium"]
# the no-uptake phase's geometries: the reference and the profile ones
# (studies.no_uptake.PROFILE_GEOMETRIES), by key and (width, depth) in mm
NU_GEOMETRIES = {"reference": (0.5, 1.0), "largest": (1.0, 2.0),
                 "square_small": (0.2, 0.2)}
# the cache tags whose entries a warm run reads from the disk
DISK_TAGS = ("port-mesh", "port-tsys", "port-mltransfer", "port-tbandplan",
             "port-stokes")
CG_BOUND = 40
PALLAS = "fenics_eff_uptake_tpu/ops/pallas_kernels.py"
JAX_SWEEP = "fenics_eff_uptake_tpu/parallel/sweep.py"
CSRC = "fenics_eff_uptake_tpu_torch/ops/csrc"
# the label of the bf16 forms of kernels A and B: products on the tensor
# cores (mma.sync m16n8k16, bf16 in, f32 accumulate)
TC = "(tensor cores)"
# the card's published peaks, its row of the port's utils/roofline.PEAKS
# (the H100 SXM's: 3.35 TB/s; bf16 989 TFLOP/s, the dense tensor-core rate;
# f32 67 and f64 34 TFLOP/s outside the tensor cores), set by card_peaks in
# _main: HBM bytes/s, and FLOP/s by the operands' element size
CARD = {}


def card_peaks(dev):
    from fenics_eff_uptake_tpu_torch.utils.roofline import chip_peaks
    pk = chip_peaks(dev)
    CARD.update(peaks=pk, hbm_bytes_s=pk["hbm_gbps"] * 1e9,
                flops={2: pk["bf16_tflops"] * 1e12,
                       4: pk["f32_tflops"] * 1e12,
                       8: pk["f64_tflops"] * 1e12})
    return pk


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA device")
    from fenics_eff_uptake_tpu_torch.device import card_line
    card = card_line("cuda")
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
    tb = nbytes / CARD["hbm_bytes_s"] * 1e3
    tf = flops / CARD["flops"][elem_size] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def band_bounds(band, spans, n_in, n_out, B, extra_bytes=0, x_size=4,
                y_size=4):
    """Dense and span bounds of a band apply: the band (whole, or its
    spans' elements) read once, X (n_in, B) read once, Y (n_out, B)
    written once, each at its element size, 2 * B FLOPs per band element at
    the rate of the band's type."""
    from fenics_eff_uptake_tpu_torch.ops.banded import span_elements
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
    rtol of its own size.  The full form must write zeros on the rows the
    block does not touch (an element chunk of the sharded path writes all
    of the full vector's rows)."""
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
    untouched = torch.ones(n, dtype=torch.bool, device=X.device)
    untouched[blk.scatter.tiles.rows.long()] = False
    if form == "full":
        def check_full():
            yk = blk.apply_batched(X, coef)
            if bool(yk[untouched].any()):
                raise AssertionError(f"{label}: rows the block does not "
                                     "touch are not zero")
            return yk, element_apply_plain(A, blk.dofs, blk.scatter, X,
                                           coef)

        return compare(
            label, lambda: blk.apply_batched(X, coef),
            lambda: element_apply_plain(A, blk.dofs, blk.scatter, X, coef),
            rtol, bounds=bounds, check=check_full,
            library=lambda: torch.sparse.mm(csr, Xc))
    g = torch.Generator(device=X.device).manual_seed(n + B)
    out0 = torch.rand((n, B), generator=g, device=X.device, dtype=X.dtype)
    ok, op, ol = out0.clone(), out0.clone(), out0.clone()

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


def shard_layout(dev):
    """The layout of the sharded phase's last rank: the last sweep row's
    last cells rank, whose element chunks carry the padding (zero
    matrices at a repeated dummy dof) when the elements do not divide
    over tp."""
    from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import _Layout
    dp = SHARD_RANKS // SHARD_TP
    return _Layout(dev, dp, SHARD_TP, dp - 1, SHARD_TP - 1, None, None)


def chunk_case(label, blk, lay, X, coef, form, per_sample=None):
    """Kernel C on the element chunk of ``blk`` that the rank of ``lay``
    holds (``sharded_solve._split_block``: ceil(N / tp) elements, padded,
    bound with the full number of rows), in f64 at 1e-12; with
    ``per_sample`` (B_all, N, nd, nd), the rank's columns and chunk of
    those matrices on it (``_split_batch_matrices``)."""
    from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import (
        _chunk, _split_batch_matrices, _split_block)
    N = blk.dofs.shape[0]
    ch = _split_block(blk, lay, blk.ndofs)
    pad = _chunk(N, lay)[1] - N
    if per_sample is not None:
        ch = ch.per_sample(_split_batch_matrices(
            per_sample, lay, lay.columns(per_sample.shape[0])))
    return element_case(f"{label} chunk {lay.cells_index + 1}/{lay.tp} "
                        f"({max(pad, 0)} padding)", ch, X, coef, 1e-12, form)


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
    # B = 1, the per-run models' width (run_simulation): A on the fine K
    # band with and without coef and on the mid band, B on the fine
    # transfers, C on f64 K (full) and the f64 Robin block (out=); the
    # same tolerances as at B = 20
    coef1 = torch.rand(1, generator=g, device=dev) + 0.5

    def rnd1(n, dtype):
        return torch.rand((n, 1), generator=g, device=dev,
                          dtype=dtype) * 2 - 1

    for label, s, coef in (("fine", sys_, coef1), ("fine", sys_, None),
                           ("mid", ml.levels[1].sys, coef1)):
        band = s.Kband
        out["band_apply"].append(band_case(
            f"A {label} band {tuple(band.shape)} B=1"
            + ("" if coef is not None else " no coef"), band, s.Kspans,
            rnd1(band.shape[0] * band.shape[1], torch.float32), coef))
    for label, band, offs, spans, rows in (
            ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
            ("prolong", tb.p, tb.po, tb.ps, tb.pad_p)):
        out["rect_band_apply"].append(rect_case(
            f"B fine {label} {tuple(band.shape)} B=1", band, offs, spans,
            rnd1(rows, torch.float32)))
    for label, blk, form in (("f64 K", sys_.K, "full"),
                             ("f64 R", sys_.R, "out")):
        out["element_apply"].append(element_case(
            label, blk, rnd1(blk.ndofs, torch.float64),
            coef1.to(torch.float64), 1e-12, form))
    # the sharded path (phase 12): the last rank's f64 chunks of K (full
    # form, coef D) and R (out=, coef mu) at its B = 10 columns, and the
    # replicated first mid level's K and R at that width
    lay = shard_layout(dev)
    bs = B_SWEEP // lay.dp
    coef_s = coef32[:bs].double()
    for label, blk, form in (("f64 K", sys_.K, "full"),
                             ("f64 R", sys_.R, "out")):
        out["element_apply"].append(chunk_case(
            label, blk, lay, rnd(blk.ndofs, torch.float64)[:, :bs]
            .contiguous(), coef_s, form))
    for label, blk, form in (("f64 mid K", ml.levels[1].sys.K, "full"),
                             ("f64 mid R", mid_R, "out")):
        out["element_apply"].append(element_case(
            label, blk, rnd(blk.ndofs, torch.float64)[:, :bs].contiguous(),
            coef_s, 1e-12, form))
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
    # the sharded Stokes saddle apply: the last rank's chunk of the
    # velocity K in f64 at B = 2 (no coef), and the sharded BiCGStab's
    # f64 advection chunk at its B = 2 columns
    lay = shard_layout(dev)
    for label, blk in (("f64 velocity K", vel.K), ("f64 Adv", adv.Adv)):
        out["element_apply"].append(chunk_case(
            label, blk, lay, rnd(blk.ndofs, 2, torch.float64), None, "full"))
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
    f64 1e-12, f32 2e-5 (summation order), as C's other cases; the fine
    block of one column (B = 1) in f64 out=.  Then the fine batch in bf16,
    and kernel A in f32 on the rectangle's fine advection band at B = 9
    and B = 1.  Returns (per-sample cases, A's cases, C's bf16 case)."""
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
    # B = 1: one run with a callable mu (its per-sample Robin block, f64
    # out=, the true residuals')
    one = sys_.R.per_sample(Rb[:1])
    X1 = rnd(one.ndofs, torch.float64)[:, :1].contiguous()
    cases.append(element_case("f64 R B=1", one, X1, None, 1e-12, "out"))
    # the sharded step-mu batch: B = 9 padded to 10 with the last column,
    # the last rank's 5 columns on its chunk of the fine Robin block (out=,
    # as the sharded operator adds it; full for its rows left zero)
    lay = shard_layout(dev)
    Rb_p = torch.cat([Rb, Rb[-1:]]).double()
    bs = Rb_p.shape[0] // lay.dp
    for form in ("out", "full"):
        cases.append(chunk_case(
            "f64 R", sys_.R, lay, rnd(sys_.ndofs, torch.float64)[:, :bs]
            .contiguous(), None, form, per_sample=Rb_p))
    c16 = element_case("R", fine.with_bf16(),
                       rnd(fine.ndofs, torch.bfloat16), None, 1e-5, "out")
    band = sys_.Advband
    X = rnd(band.shape[0] * band.shape[1], torch.float32)
    a_cases = [band_case(f"A rectangle Adv band {tuple(band.shape)} B={nb}",
                         band, sys_.Advspans, X[:, :nb].contiguous(), None)
               for nb in (B, 1)]
    del sys_, ml, Rb
    torch.cuda.empty_cache()
    return cases, a_cases, c16


# the graded kernel cases: the w0.4/d2.0 family at h = 0.02, its mouth
# refined 8 times (92,995 cells; hmin 1.85e-3), the widest band of a rung
# the JAX package reached
GRADED = (0.4, 2.0, 8)


def phase_kernels_graded(dev):
    """The kernels on a mouth-refined mesh (``GRADED``) at the E_L1
    ladder's shapes (B = 3, one column per Pe): A on the fine K band (with
    coef) and the fine advection band, B on the advective hierarchy's fine
    restriction and prolongation and the first mid level's restriction
    (the graded P1 mesh into the ungraded P1 mesh at 3h, in windows past
    the JAX width menu), C in f64 on the K block (full) and in f32 on the
    Robin block (out=)."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system)
    from fenics_eff_uptake_tpu_torch.simulation import get_mesh
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import stokes_for_study
    from fenics_eff_uptake_tpu_torch.studies.el1_convergence import release
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params

    w, d, factor = GRADED
    p = _make_params(PECLET[0], w, d, 0.02)
    p.refinement_factor = factor
    mesh = get_mesh(p, "sulcus")
    u, _ = stokes_for_study(mesh, p.H, dev)
    D = [1.0 / pe for pe in PECLET]
    adv = build_transport_system(mesh, dev, u_values=u.values,
                                 u_space=u.space)
    aml = build_multilevel_for(adv, mesh, D, [0.0] * len(D), u_fine=u)
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(n, dtype=torch.float32):
        return torch.rand((n, 3), generator=g, device=dev,
                          dtype=dtype) * 2 - 1

    tag = f"graded w{w:g}/d{d:g} x{factor}"
    print(f"[kernels] {tag}: {mesh.num_cells} cells, hmin "
          f"{mesh.hmin():.6g}", flush=True)
    out = {"band_apply": [], "rect_band_apply": [], "element_apply": []}
    coef = torch.rand(3, generator=g, device=dev) + 0.5
    for label, band, spans, cf in (
            ("K band", adv.Kband, adv.Kspans, coef),
            ("Adv band", adv.Advband, adv.Advspans, None)):
        out["band_apply"].append(band_case(
            f"A {tag} {label} {tuple(band.shape)} B=3", band, spans,
            rnd(band.shape[0] * band.shape[1]), cf))
    tb, mid = aml.levels[0].bands, aml.levels[1].bands
    for way, band, offs, spans, rows in (
            ("restrict", tb.r, tb.ro, tb.rs, tb.pad_r),
            ("prolong", tb.p, tb.po, tb.ps, tb.pad_p),
            ("mid restrict", mid.r, mid.ro, mid.rs, mid.pad_r)):
        out["rect_band_apply"].append(rect_case(
            f"B {tag} {way} {tuple(band.shape)} B=3", band, offs, spans,
            rnd(rows)))
    out["element_apply"] += [
        element_case(f"{tag} f64 K", adv.K, rnd(adv.ndofs, torch.float64),
                     None, 1e-12),
        element_case(f"{tag} f32 R", adv.R, rnd(adv.ndofs), coef, 2e-5,
                     "out")]
    del adv, aml, u, mesh
    release(dev)
    return out


def _artifacts():
    from fenics_eff_uptake_tpu_torch.studies import artifacts
    return artifacts


def _csv_rows(path):
    return _artifacts().read_rows(path)


def _worst(tag, got, want, rel_cols, abs_cols=None, tol=1e-6):
    """Worst error per column of ``got`` rows against ``want`` (the
    artifact's rows, text), both keyed alike: ``rel_cols`` relative,
    ``abs_cols`` {column: scale(want row)} absolute over that scale
    (``artifacts.worst_errors``).  Raises on a column above ``tol``."""
    abs_cols = abs_cols or {}
    return _artifacts().worst_errors(
        tag, got, want, tuple(rel_cols), tuple(abs_cols),
        lambda col, gr: abs_cols[col](gr), tol)


def check_against_golden(rows, stats, tol=1e-6, tag="slice"):
    """The mu sweep's 20 rows against the artifact's, in its order."""
    golden = _csv_rows(GOLDEN_CSV)
    if [r["Config"] for r in rows] != [r["Config"] for r in golden]:
        raise AssertionError(f"row order {[r['Config'] for r in rows]}")
    if stats["cells"] != BENCH_CELLS:
        print(f"[{tag}] FINDING: the mesher made {stats['cells']} cells on "
              f"this host, not the {BENCH_CELLS}-cell mesh of the golden "
              "CSV", flush=True)
    return _artifacts().check_rows("phase_a_mu", rows, tag, tol=tol)


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
    """Launch counts by kernel in this process; kernel C's split by form
    too (the keys ``element_apply full`` and ``element_apply out``), and
    its per-sample launches (of either form) among them.  A rank group's
    ``launches`` has the same keys."""
    from fenics_eff_uptake_tpu_torch.parallel.sharding import \
        kernel_launches
    return kernel_launches()


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


def fresh_cache(name):
    """An empty cache directory ``name`` under this run's cache root as
    FEU_CACHE_DIR, every memo and cache count emptied: what follows
    starts cold."""
    from fenics_eff_uptake_tpu_torch.utils import diskcache
    d = Path(os.environ["FEU_SMOKE_CACHE_ROOT"]) / name
    d.mkdir(parents=True, exist_ok=False)
    os.environ["FEU_CACHE_DIR"] = str(d)
    diskcache.clear_memos()
    diskcache.reset_stats()
    return d


def cache_counts():
    """{tag: {memo, disk, miss, read_s, write_s}} since the last reset."""
    from fenics_eff_uptake_tpu_torch.utils import diskcache
    out = {t: dict(n) for t, n in diskcache.CACHE_STATS.items()}
    for t, sec in diskcache.CACHE_SECONDS.items():
        out.setdefault(t, {"memo": 0, "disk": 0, "miss": 0}).update(
            read_s=sec["read"], write_s=sec["write"])
    return out


def phase_slice(dev):
    from fenics_eff_uptake_tpu_torch.studies.phase_a import run_mu_sweep

    fresh_cache("slice")
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
    stats2["roofline"] = slice_roofline(dev, stats2)
    return launches, stats, stats2, worst


# the two-level phase: the coarse mesh's h (the bench's, and
# simulation.get_coarse_mesh's at h = 0.02) and the solves' tolerance
TL_COARSE_FACTOR = 4.0
TL_RTOL = 1e-11


def phase_twolevel(dev):
    """The bench workload (the mu sweep's system and 20 mu, h = 0.02) in
    mixed precision under the two-level preconditioner on the coarse mesh
    at h = 0.08: per-sample coarse inverses, then the Woodbury form, each
    set up cold and solved; held to the multigrid solve of the same system
    (the slice phase's, solved again here)."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        build_multilevel_for
    from fenics_eff_uptake_tpu_torch.solvers.twolevel import build_twolevel
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, sweep_mus)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import MU_SWEEP_REGIMES

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    fresh_cache("twolevel")
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    mesh = make_mesh(geom, "sulcus")
    coarse = make_mesh(geom, "sulcus", coarsen=TL_COARSE_FACTOR)
    mus = sweep_mus(geom, [f for fs in MU_SWEEP_REGIMES.values()
                           for f in fs])
    D = [geom.D] * len(mus)
    sys_t = build_transport_system(mesh, dev, element="P2")
    ml = build_multilevel_for(sys_t, mesh, D, mu_values=mus)
    X_ml, i_ml = solve_sweep(sys_t, D, mus, rtol=1e-12, multilevel=ml)
    del ml
    rec = {"cells": int(len(mesh.cells)), "ndofs_padded": int(sys_t.ndofs),
           "coarse_vertices": int(len(coarse.vertices)),
           "ml_iters": i_ml["iters"].tolist()}
    runs = {}
    for form in ("per_sample", "woodbury"):
        t0 = synced()
        tl = build_twolevel(sys_t, coarse, D, mus,
                            woodbury=form == "woodbury")
        setup_s = synced() - t0
        if (tl.Ainv is None) != (form == "woodbury"):
            raise AssertionError(f"{form}: the build took the other form")
        zero_launches()
        t0 = synced()
        X, info = solve_sweep(sys_t, D, mus, rtol=TL_RTOL, twolevel=tl)
        solve_s = synced() - t0
        launches = read_launches()
        t0 = synced()
        X2, info2 = solve_sweep(sys_t, D, mus, rtol=TL_RTOL, twolevel=tl)
        steady_s = synced() - t0
        coarse_mb = sum(t.numel() * t.element_size() for t in (
            tl.Ainv, tl.A0inv, tl.Z, tl.W, tl.Cinv) if t is not None) / 2**20
        del tl
        runs[form] = (X, info)
        rel = info["true_rel_resnorm"]
        dx = float((X - X_ml).abs().max() / X_ml.abs().max())
        r = {"setup_s": setup_s, "solve_s": solve_s, "steady_solve_s":
             steady_s, "iters": info["iters"].tolist(),
             "passes": info["passes"], "max_true_rel_resnorm": float(
                 rel.max()), "x_vs_ml": dx, "coarse_mb": coarse_mb,
             "launches": launches}
        rec[form] = r
        print(f"[twolevel] {form}: iters {r['iters']} in {r['passes']} "
              f"passes, setup {setup_s:.3f}s (coarse inverses "
              f"{coarse_mb:.1f} MB on the card), solve {solve_s:.3f}s, "
              f"steady {steady_s:.3f}s, launches A "
              f"{launches['band_apply']} C {launches['element_apply']} "
              f"(out= {launches['element_apply out']}) B "
              f"{launches['rect_band_apply']}; max true rel residual "
              f"{r['max_true_rel_resnorm']:.3e}; |X - X_ml| / max|X_ml| "
              f"{dx:.3e} (multigrid iters {rec['ml_iters']})", flush=True)
        if not rel.max() <= TL_RTOL:
            raise AssertionError(f"{form}: true rel residual "
                                 f"{rel.max():.3e} > {TL_RTOL:g}")
        if not dx <= 1e-8:
            raise AssertionError(f"{form}: X {dx:.3e} of max |X| from the "
                                 "multigrid solve")
        if info2["iters"].tolist() != r["iters"] or not torch.equal(X2, X):
            raise AssertionError(f"{form}: the second solve differs")
        if (launches["band_apply"] <= 0 or launches["element_apply full"] <= 0
                or launches["element_apply out"] <= 0
                or launches["rect_band_apply"] != 0
                or any(launches[k] for k in BF16_KEYS)):
            raise AssertionError(f"{form}: launches {launches} (A and C "
                                 "in both forms, nothing else)")
    dw = float((runs["woodbury"][0] - runs["per_sample"][0]).abs().max()
               / runs["per_sample"][0].abs().max())
    rec["woodbury_vs_per_sample"] = dw
    print(f"[twolevel] Woodbury against per-sample: |dX| / max|X| {dw:.3e} "
          "(tol 1e-8)", flush=True)
    if not dw <= 1e-8:
        raise AssertionError(f"Woodbury X {dw:.3e} from the per-sample X")
    return rec["per_sample"]["launches"], rec


def slice_roofline(dev, stats):
    """The roofline of the steady sweep solve: utils/roofline.py's model of
    one iteration on the sweep's system and hierarchy (rebuilt from the
    memos the runs filled), over the solve's seconds."""
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        build_multilevel_for
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, sweep_mus)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import MU_SWEEP_REGIMES
    from fenics_eff_uptake_tpu_torch.utils.roofline import (
        ml_cg_iteration_cost, roofline_summary)
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    mesh = make_mesh(geom, "sulcus")
    mus = sweep_mus(geom, [f for fs in MU_SWEEP_REGIMES.values()
                           for f in fs])
    sys_t = build_transport_system(mesh, dev, element="P2")
    ml = build_multilevel_for(sys_t, mesh, [geom.D] * len(mus),
                              mu_values=mus)
    cost = ml_cg_iteration_cost(sys_t, ml, len(mus), cycle="hybrid")
    roof = roofline_summary(cost, iters_executed=max(stats["iters"]),
                            wall_s=stats["solve_s"],
                            passes_f64=int(stats["passes"]) + 1,
                            sys_t=sys_t, B=len(mus), peaks=CARD["peaks"])
    print(f"[slice] roofline of the steady solve (utils/roofline.py, "
          f"{max(stats['iters'])} iterations in {stats['solve_s']:.3f}s; "
          f"{CARD['name']}): {json.dumps(roof)}", flush=True)
    return roof


def _nu_key(r):
    """(domain, width, depth, Pe) of a no-uptake row (CSV text or numbers);
    None width and depth for the rectangle."""
    return _artifacts().nu_key(r)


def check_no_uptake_golden(rows):
    """The 12 rows (the three geometries and the rectangle, each Pe)
    against the committed artifact's; returns the worst error per
    column."""
    dims = {tuple(round(x, 9) for x in wd) for wd in NU_GEOMETRIES.values()}
    return _artifacts().check_rows(
        "no_uptake", rows, "no_uptake",
        subset=lambda k: k[0] == "rectangle" or k[1:3] in dims)


def phase_no_uptake(dev):
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import \
        run_geometry_study
    from fenics_eff_uptake_tpu_torch.utils import diskcache

    geometries = list(NU_GEOMETRIES)
    fresh_cache("no_uptake")
    zero_launches()
    rows, stats = run_geometry_study(geometries, PECLET, 0.02,
                                     base_dir=str(OUT_DIR / "nu_first"),
                                     device=dev)
    launches = read_launches()
    hits = cache_counts()
    print(f"[no_uptake] launches in the first run: {launches}", flush=True)
    diskcache.reset_stats()
    rows2, stats2 = run_geometry_study(geometries, PECLET, 0.02,
                                       base_dir=str(OUT_DIR / "nu_steady"),
                                       device=dev, verbose=False)
    hits2 = cache_counts()
    print(f"[no_uptake] cache, first run: {hits}", flush=True)
    print(f"[no_uptake] cache, steady run: {hits2}", flush=True)
    for tag, st in (("first", stats), ("steady", stats2)):
        for s in st:
            print(f"[no_uptake] {tag} {s['geometry']} ({s['cells']} cells, "
                  f"{s['ndofs']} P2 dofs): mesh {s['mesh_s']:.3f}s "
                  f"stokes_setup {s['stokes_setup_s']:.3f}s stokes_solve "
                  f"{s['stokes_solve_s']:.3f}s assembly "
                  f"{s['assembly_s']:.3f}s ml_setup {s['ml_setup_s']:.3f}s "
                  f"solve {s['solve_s']:.3f}s metrics {s['metrics_s']:.3f}s "
                  f"profiles {s['profiles_s']:.3f}s total "
                  f"{s['total_s']:.3f}s ({s['stokes_method']})", flush=True)
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
        # the count bounds come from the card's records, which exist for
        # the reference geometry and the rectangle
        if s["geometry"] not in ("reference", "rectangle"):
            continue
        if not s["minres_iters"] <= MINRES_BOUND:
            raise AssertionError(f"MINRES iterations {s['minres_iters']} > "
                                 f"{MINRES_BOUND}")
        if not all(i <= b for i, b in zip(s["iters"], BICGSTAB_BOUND)):
            raise AssertionError(f"BiCGStab iterations {s['iters']} above "
                                 f"{BICGSTAB_BOUND}")
    for s, s2 in zip(stats, stats2):
        if s2["iters"] != s["iters"]:
            raise AssertionError(f"{s['geometry']}: iterations differ "
                                 f"between runs: {s['iters']} vs "
                                 f"{s2['iters']}")
    worst = check_no_uptake_golden(rows)
    if rows2 != rows:
        raise AssertionError("steady run's rows differ from the first's")
    sub = Path("Geometry Comparison Analysis") / "Profiles"
    worst["profiles"] = _artifacts().check_profiles(OUT_DIR / "nu_first"
                                                    / sub)
    for f in sorted((OUT_DIR / "nu_first" / sub).glob("*.csv")):
        if f.read_bytes() != (OUT_DIR / "nu_steady" / sub
                              / f.name).read_bytes():
            raise AssertionError(f"steady run's {f.name} differs from the "
                                 "first's")
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
    fresh_cache("adv_diff")
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

    worst = _artifacts().check_rows("adv_diff", rows)
    if rows2 != rows:
        raise AssertionError("steady run's rows differ from the first's")
    return launches, stats, stats2, worst


PER_RUN_CONFIGS = ("small_uptake_mu_0.1x", "small_uptake_mu_1.0x",
                   "high_uptake_mu_150.0x")
# the no-uptake row of the reference geometry at Pe = 1 in the artifact
PER_RUN_NU_KEY = ("sulcus", 0.5, 1.0, 1.0)
PER_RUN_STAGES = ("mesh", "stokes", "transport", "metrics", "mu_eff",
                  "mesh_io", "paraview")
# the memo-warm runs that write their ParaView files
PER_RUN_PARAVIEW = (PER_RUN_CONFIGS[0], "no-uptake")


def _vtk_points_and_values(path):
    """(the POINTS count, the POINT_DATA values as rows) of a legacy-VTK
    file of utils/vtk.py."""
    lines = Path(path).read_text().splitlines()
    n = int(next(l for l in lines if l.startswith("POINTS")).split()[1])
    k = next(i for i, l in enumerate(lines) if l.startswith("POINT_DATA"))
    k += 2 if lines[k + 1].startswith("VECTORS") else 3
    return n, np.array([[float(x) for x in l.split()] for l in lines[k:]])


def check_paraview(tag, res, pv_dir):
    """The ParaView files of a run read back: every grid's POINTS is the
    mesh's vertex count, and each field's values are the run's own vertex
    values as written (%.16g, read back exactly; within 1e-15 of the f64
    values, since 16 digits do not round-trip every f64)."""
    from fenics_eff_uptake_tpu_torch.utils.vtk import vertex_values
    V = len(res["mesh_results"]["mesh"].vertices)
    worst = 0.0
    for name, fn in (("concentration.vtk", res["c"]),
                     ("pressure.vtk", res["p"]),
                     ("velocity.vtk", res["u"])):
        n, got = _vtk_points_and_values(pv_dir / name)
        want = vertex_values(fn).reshape(V, -1)
        if want.shape[1] == 2:
            want = np.concatenate([want, np.zeros((V, 1))], axis=1)
        if n != V or got.shape != want.shape:
            raise AssertionError(f"{tag} {name}: POINTS {n}, values "
                                 f"{got.shape}, mesh {V} vertices")
        written = np.vectorize(lambda v: float(f"{v:.16g}"))(want)
        if not np.array_equal(got, written):
            raise AssertionError(f"{tag} {name}: values differ from the "
                                 "run's")
        scale = max(float(np.abs(want).max()), 1e-300)
        worst = max(worst, float(np.abs(got - want).max()) / scale)
    if worst > 1e-15:
        raise AssertionError(f"{tag}: ParaView values {worst:.3e} off")
    for name in ("mesh_domains.vtk", "sulcus_mesh.vtk",
                 "sulcus_bc_markers.vtk"):
        n = int(next(l for l in (pv_dir / name).read_text().splitlines()
                     if l.startswith("POINTS")).split()[1])
        if n != V:
            raise AssertionError(f"{tag} {name}: POINTS {n} != {V}")
    normals = sorted(p.name for p in (pv_dir / "normals").iterdir())
    print(f"[per_run] {tag} ParaView files read back: {V} points, fields "
          f"as written, max rel diff to f64 {worst:.2e}; "
          f"{len(normals)} normals files; paraview stage "
          f"{res['timings']['paraview']:.3f}s", flush=True)
    return {"points": V, "max_rel": worst, "normals": len(normals),
            "seconds": res["timings"]["paraview"]}


def check_plot_flag(dev, params, root):
    """run_simulation(plot=True): the ImportError where matplotlib is
    absent (the card's machine); the figures where it is present."""
    import importlib.util
    from fenics_eff_uptake_tpu_torch.simulation import run_simulation
    have = importlib.util.find_spec("matplotlib") is not None
    try:
        run_simulation("no-adv", "Phase A", "plot", "sulcus", params,
                       device=dev, verbose=False, results_root=str(root),
                       plot=True)
    except ImportError as e:
        if have:
            raise
        print(f"[per_run] plot=True without matplotlib: ImportError "
              f"({e})", flush=True)
        return "ImportError"
    if not have:
        raise AssertionError("plot=True ran without matplotlib")
    pngs = list(Path(root).rglob("Analysis Plots/*.png"))
    if len(pngs) < 7:
        raise AssertionError(f"plot=True wrote {len(pngs)} figures")
    print(f"[per_run] plot=True wrote {len(pngs)} figures", flush=True)
    return f"{len(pngs)} figures"


def _per_run_timings(tag, res):
    t = res["timings"]
    print(f"[per_run] {tag}: " + " ".join(
        f"{k} {t[k]:.3f}s" for k in PER_RUN_STAGES if k in t)
        + f" total {sum(t.values()):.3f}s; solve {res['c'].solver_info}",
        flush=True)
    return {k: t.get(k) for k in PER_RUN_STAGES}


def _rel_walk(a, b, path=""):
    """Worst relative difference of two metric dicts of one key tree."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {set(a) ^ set(b)}")
        return max([0.0] + [_rel_walk(a[k], b[k], f"{path}/{k}")
                            for k in a])
    if a is None or b is None:
        if (a is None) != (b is None):
            raise AssertionError(f"{path}: {a} vs {b}")
        return 0.0
    a, b = float(a), float(b)
    if np.isnan(b):
        return 0.0 if np.isnan(a) else float("inf")
    return abs(a - b) / max(abs(b), 1e-300) if b != 0 else abs(a)


def phase_per_run(dev):
    """The per-run API at h = 0.02: run_simulation in its three modes
    (no-adv on three rows of the mu sweep, no-uptake and adv-diff on the
    reference geometry at Pe = 1), each cold and memo-warm, held against
    the artifacts and the port's batched path; then GMRES at Pe = 40 and
    the Stokes options (Schur, the outlet pin, f64 MINRES)."""
    import torch
    from fenics_eff_uptake_tpu_torch.analysis.batched_metrics import (
        build_sweep_metrics, metrics_to_dicts)
    from fenics_eff_uptake_tpu_torch.meshing.generator import (
        generate_mesh, structured_rectangle)
    from fenics_eff_uptake_tpu_torch.models.advdiff import advdiff_solve
    from fenics_eff_uptake_tpu_torch.models.stokes_flow import (
        stokes_solve, stokes_solve_mg, stokes_solve_schur)
    from fenics_eff_uptake_tpu_torch.simulation import run_simulation
    from fenics_eff_uptake_tpu_torch.studies.adv_diff import (
        create_base_parameters)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, transport_batch)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import (
        _make_params, _sulcus_row)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import _mu_eff_columns

    fresh_cache("per_run")
    root = OUT_DIR / "per_run"
    golden = {r["Config"]: r for r in _csv_rows(GOLDEN_CSV)}
    factors = {c: float(golden[c]["Mu_Factor"]) for c in PER_RUN_CONFIGS}
    nu_params = _make_params(1.0, *NU_GEOMETRIES["reference"], 0.02)
    ad_params = create_base_parameters(1.0, 1.0, 0.02)
    stats = {"timings": {}, "solver": {}}

    def no_adv_params(cfg):
        return make_no_adv_params(factors[cfg], sulci_w_dim=0.25,
                                  sulci_h_dim=0.25, mesh_size_dim=0.02)

    def runs(tag):
        out = {}
        for cfg in PER_RUN_CONFIGS:
            out[cfg] = run_simulation(
                "no-adv", "Phase A", cfg, "sulcus", no_adv_params(cfg),
                device=dev, verbose=False, results_root=str(root / tag),
                save_paraview=tag == "warm" and cfg in PER_RUN_PARAVIEW)
        out["no-uptake"] = run_simulation(
            "no-uptake", "Geometry", "reference_pe1", "sulcus", nu_params,
            device=dev, verbose=False, results_root=str(root / tag),
            save_paraview=tag == "warm")
        out["adv-diff"] = run_simulation(
            "adv-diff", "Validation", "sulcus_pe1_mu1", "sulcus", ad_params,
            device=dev, verbose=False, results_root=str(root / tag))
        for name, res in out.items():
            stats["timings"][f"{tag} {name}"] = _per_run_timings(
                f"{tag} {name}", res)
        return out

    zero_launches()
    cold = runs("cold")
    launches = read_launches()
    print(f"[per_run] launches of the three modes (cold): {launches}",
          flush=True)
    warm = runs("warm")
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the per-run "
                             f"path: {missing}")
    # the output stages: the ParaView files of two memo-warm runs read
    # back, and plot=True
    stats["paraview"] = {
        name: check_paraview(
            name, warm[name], root / "warm" / (
                "No Uptake Simulations/Geometry/reference_pe1"
                if name == "no-uptake" else
                f"No Advection Simulations/Phase A/{name}")
            / "ParaView Files")
        for name in PER_RUN_PARAVIEW}
    stats["plot"] = check_plot_flag(dev, no_adv_params(PER_RUN_CONFIGS[0]),
                                    root / "plot")

    # gates: residuals and counts, then the artifacts' rows
    for name, res in cold.items():
        info = res["c"].solver_info
        stats["solver"][name] = info
        if not (info["converged"] and info["rel_resnorm"] <= 1e-11):
            raise AssertionError(f"{name}: transport {info}")
        if not info["multilevel"]:
            raise AssertionError(f"{name}: no multigrid")
        if res is cold["no-uptake"] and not info["iters"] <= \
                BICGSTAB_BOUND[PECLET.index(1.0)]:
            raise AssertionError(f"no-uptake BiCGStab {info['iters']} > "
                                 f"{BICGSTAB_BOUND[PECLET.index(1.0)]}")
        if name in PER_RUN_CONFIGS and not info["iters"] <= CG_BOUND:
            raise AssertionError(f"{name}: CG {info['iters']} > {CG_BOUND}")
        if not torch.equal(torch.as_tensor(warm[name]["c"].values),
                           torch.as_tensor(res["c"].values)):
            raise AssertionError(f"{name}: the memo-warm run's c differs")
    worst = _worst("per_run no-adv",
                   {c: _mu_eff_columns(cold[c]) for c in PER_RUN_CONFIGS},
                   {c: golden[c] for c in PER_RUN_CONFIGS},
                   ("Mu_Eff_Simulation", "Mu_Eff_Opening", "Total_Mass",
                    "Mouth_Flux_Total"))
    nu = cold["no-uptake"]
    row = _sulcus_row(nu_params, nu["mass_metrics"], nu["flux_metrics"],
                      nu["vel_metrics"])
    nu_golden = {_nu_key(r): r for r in _csv_rows(GOLDEN_NU_CSV)}
    key = _nu_key(row)
    if key != PER_RUN_NU_KEY:
        raise AssertionError(f"no-uptake row key {key}")
    q_in = abs(float(nu_golden[key]["Mouth Q_in"]))
    worst.update(_worst(
        "per_run no-uptake", {key: row}, {key: nu_golden[key]},
        tuple(c for c in _artifacts().ARTIFACTS["no_uptake"].rel
              if c in row),
        {c: (lambda gr: q_in)
         for c in _artifacts().ARTIFACTS["no_uptake"].absolute}))

    # adv-diff against the port's batched path on the same mesh, velocity
    # and coefficients (B = 1, batched metrics)
    ad = cold["adv-diff"]
    mesh = make_mesh(ad_params, "sulcus")
    X, info, sys_, _ = transport_batch(mesh, ad["u"], [ad_params.D],
                                       [ad_params.mu], dev, rtol=1e-13)
    sm = build_sweep_metrics(sys_.space, mesh, ad_params.D, dev, u=ad["u"])
    fl, ml_, me = metrics_to_dicts(sm, mesh, X, [ad_params.mu], [ad_params])
    ad_err = {"flux": _rel_walk(ad["flux_metrics"], fl[0]),
              "mass": _rel_walk(ad["mass_metrics"], ml_[0]),
              "mu_eff": _rel_walk(ad["mu_eff_comparison"], me[0])}
    print(f"[per_run] adv-diff against the batched path: worst rel diff "
          f"{ad_err} (tol 1e-9)", flush=True)
    if not max(ad_err.values()) <= 1e-9:
        raise AssertionError(f"adv-diff off the batched path: {ad_err}")
    worst["adv_diff_vs_batched"] = ad_err

    # GMRES at Pe = 40 (the JAX test's case), against BiCGStab
    md = structured_rectangle(2.0, 1.0, 16, 8)
    u, _ = stokes_solve(md, 1.0, dev)
    t0 = time.time()
    c_g = advdiff_solve(md, u, dev, D=1.0 / 40.0, mu=1.0, solver="auto")
    torch.cuda.synchronize()
    t_g = time.time() - t0
    c_b = advdiff_solve(md, u, dev, D=1.0 / 40.0, mu=1.0, solver=None)
    gi = c_g.solver_info
    d_gb = float((c_g.values - c_b.values).abs().max())
    print(f"[per_run] GMRES at Pe = 40: {gi['iters']} iterations in "
          f"{t_g:.3f}s, true rel residual {gi['rel_resnorm']:.3e}; "
          f"|c_gmres - c_bicgstab| {d_gb:.3e} (tol 1e-8; BiCGStab "
          f"{c_b.solver_info['iters']} iterations)", flush=True)
    if gi.get("method") != "gmres" or not gi["converged"]:
        raise AssertionError(f"GMRES: {gi}")
    if not (d_gb < 1e-8 and gi["rel_resnorm"] <= 1e-13):
        raise AssertionError(f"GMRES off: diff {d_gb}, {gi}")
    stats["gmres"] = {"iters": gi["iters"], "seconds": t_g,
                      "rel_resnorm": gi["rel_resnorm"], "diff": d_gb}

    # the Stokes options on the JAX test's sulcus mesh, then f64 MINRES
    # at h = 0.05 on the reference geometry
    smesh = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.3,
                          sulcus_width=0.3, mesh_size=0.15,
                          refinement_factor=1, domain_type="sulcus")
    so = {}
    t0 = time.time()
    u1, p1 = stokes_solve_mg(smesh, 1.0, dev, rtol=1e-11)
    # the Schur path in f64 (its mixed form, 6x the inner iterations and
    # 17-30 s here, is held to MG by the card's tests:
    # test_stokes_schur_mixed_on_card_matches_mg)
    t1 = time.time()
    u0, p0 = stokes_solve_schur(smesh, 1.0, dev, precision="f64")
    du = float(np.abs(u0.values - u1.values).max())
    dp = float(np.abs(p0.values - p1.values).max())
    i0 = u0.solver_info
    print(f"[per_run] Stokes Schur f64 against MG: du {du:.3e} (tol 1e-8) "
          f"dp {dp:.3e} (tol 1e-6); outer {i0['outer_iters']} inner "
          f"{i0['inner_iters']} in {time.time() - t1:.3f}s", flush=True)
    if not (i0["converged"] and du < 1e-8 and dp < 1e-6):
        raise AssertionError(f"Stokes Schur: du {du} dp {dp} {i0}")
    so["schur f64"] = {"du": du, "dp": dp, "outer": i0["outer_iters"],
                       "inner": i0["inner_iters"], "s": time.time() - t1}
    u2, p2 = stokes_solve_mg(smesh, 1.0, dev, rtol=1e-11,
                             pin_outlet_pressure=True)
    scale = float(np.abs(p1.values).max())
    dp = float(np.abs(p2.values - p1.values).max()) / scale
    du = float(np.abs(u2.values - u1.values).max())
    print(f"[per_run] Stokes outlet pin: dp / max|p| {dp:.3e} du {du:.3e} "
          "(tol 1e-5 each)", flush=True)
    if not (dp < 1e-5 and du < 1e-5):
        raise AssertionError(f"Stokes pin: dp {dp} du {du}")
    so["pin"] = {"dp_rel": dp, "du": du}
    rmesh = make_mesh(_make_params(1.0, *NU_GEOMETRIES["reference"], 0.05),
                      "sulcus")
    res = {}
    for prec in ("mixed", "f64"):
        t1 = time.time()
        res[prec] = stokes_solve_mg(rmesh, 1.0, dev, rtol=1e-11,
                                    precision=prec)
        info = res[prec][0].solver_info
        print(f"[per_run] Stokes MG {prec} at h = 0.05: MINRES "
              f"{info['outer_iters']} in {info['passes']} passes, rel "
              f"residual {info['rel_resnorm']:.3e}, {time.time() - t1:.3f}s",
              flush=True)
        if not info["converged"]:
            raise AssertionError(f"Stokes {prec}: {info}")
        so[f"mg {prec}"] = {"iters": info["outer_iters"],
                            "rel_resnorm": info["rel_resnorm"],
                            "s": time.time() - t1}
    (um, pm), (uf, pf) = res["mixed"], res["f64"]
    du = float(np.abs(uf.values - um.values).max())
    dp = float(np.abs(pf.values - pm.values).max()
               / np.abs(pm.values).max())
    print(f"[per_run] Stokes f64 against mixed: du {du:.3e} (tol 1e-8) "
          f"dp / max|p| {dp:.3e} (tol 1e-6); options in "
          f"{time.time() - t0:.1f}s", flush=True)
    if not (du < 1e-8 and dp < 1e-6):
        raise AssertionError(f"Stokes f64 vs mixed: du {du} dp {dp}")
    so["f64 vs mixed"] = {"du": du, "dp_rel": dp}
    stats["stokes_options"] = so
    return launches, stats, worst


# the sharded phase: 4 gloo ranks on the one card, 2 sweep rows x 2 cells
# ranks; compare_sharded_study.py's tolerance and denominator floors
SHARD_RANKS, SHARD_TP = 4, 2
SHARD_H = 0.02
SHARD_TOL = 1e-8
SHARD_AD_TOL = 1e-7
NU_SHARD_COLUMNS = ("Avg Concentration", "Total Mass", "Mouth E_L1",
                    "Mouth_Flux_Total", "Concentration_Ratio")
NU_SHARD_FLOORS = {"Mouth_Flux_Total": 1e-1, "Mouth E_L1": 1e-4}
AD_SHARD_COLUMNS = ("total_flux", "diffusive_flux", "advective_flux",
                    "uptake_flux", "avg_conc", "CR", "mu_eff_open",
                    "mu_eff_sim", "flux_ratio", "flux_error_pct")
AD_SHARD_FLOORS = {"advective_flux": 1e-1, "flux_error_pct": 1.0}
AD_CSV = Path("Results Data") / "advdiff_validation_step_pe_x_mu.csv"
# the all-reduces of one iteration: MG-CG, BiCGStab under the cycle,
# Stokes MINRES (JAX's dry run)
ALL_REDUCES = {"cg": 3, "bicgstab": 6, "minres": 3}


def _floored(tag, got, want, cols, floors, tol):
    """``_worst`` with compare_sharded_study.py's measure: |a - b| over
    max(|b|, the column's floor)."""
    def scale(col):
        return lambda gr: max(abs(float(gr[col])), floors[col])
    return _worst(tag, got, want, [c for c in cols if c not in floors],
                  {c: scale(c) for c in cols if c in floors}, tol=tol)


def _ad_key(r):
    return (round(float(r["Pe"]), 9), round(float(r["mu_factor"]), 9),
            r["domain_type"])


def _json_info(info, **extra):
    """A sharded solve's report as JSON values."""
    return {**{k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in info.items()}, **extra}


def _print_transport(tag, info):
    print(f"[sharded] {tag}: CG/BiCGStab iters {info['iters'].tolist()} "
          f"in {info['chunks']} chunks (sweep row 0), max true rel residual "
          f"{info['true_rel_resnorm'].max():.3e}, all-reduces per "
          f"iteration {info['all_reduces_per_iter']:g}; solve "
          f"{info['solve_s']:.3f}s (ranks' setup {info['setup_s']:.3f}s; "
          f"seconds per chunk {np.round(info['chunk_s'], 3).tolist()}; "
          f"stages by rank {[r['stage_s'] for r in info['ranks']]})",
          flush=True)


def phase_sharded(dev):
    """The sharded path on the one card: 4 gloo ranks (sweep 2 x cells 2)
    started once, then (a) the mu sweep (rows against the artifact, X
    against the unsharded solve; X again at world size 1 on nccl), (b) the
    no-uptake study on the reference geometry and the rectangle (sharded
    Stokes, then Pe 0.1, 1, 10 padded to 4), (c) the adv-diff validation
    on both domains (B = 9 padded to 10, per-sample Robin on the
    rectangle) against the adv_diff phase's rows, which it reads from
    that phase's CSV."""
    import torch
    from fenics_eff_uptake_tpu_torch.parallel import sharded_solve as shs
    from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import \
        fine_element_bytes
    from fenics_eff_uptake_tpu_torch.parallel.sharding import RankGroup
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies import adv_diff, no_uptake
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, stokes_for_study)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import run_mu_sweep

    ad_ref = _csv_rows(OUT_DIR / "ad_first" / AD_CSV)   # the adv_diff phase's
    fresh_cache("sharded")
    rec = {}
    zero_launches()
    group = RankGroup(SHARD_RANKS, SHARD_TP, dev, backend="gloo")
    # every sharded call of the studies appends its inputs and results here
    group.log = []
    try:
        rec["spawn_s"] = group.spawn_s
        print(f"[sharded] {group}: spawned and joined in "
              f"{group.spawn_s:.2f}s", flush=True)
        # (a) the mu sweep: rows, and X against the unsharded solve of the
        # same system and hierarchy built on the card
        t = time.time()
        rows, stats = run_mu_sweep(dev, SHARD_H, verbose=False, shard=group,
                                   base_dir=str(OUT_DIR / "sh_mu"))
        rec["mu_sweep_study_s"] = time.time() - t
        rec["mu_sweep_rows_worst"] = check_against_golden(
            rows, stats, tol=SHARD_TOL, tag="sharded")
        (sweep,) = group.log
        sys_, D, mus, ml, X, info = (sweep[k] for k in (
            "sys", "D", "mu", "multilevel", "X", "info"))
        mesh_ = make_mesh(make_no_adv_params(
            1.0, sulci_w_dim=0.25, sulci_h_dim=0.25, mesh_size_dim=SHARD_H))
        sys_d = build_transport_system(mesh_, dev)
        X_ref, _ = solve_sweep(sys_d, D, mus, multilevel=build_multilevel_for(
            sys_d, mesh_, D, mus))
        dx = float((X - X_ref).abs().max())
        _print_transport("mu sweep (B = 20, 10 per sweep row)", info)
        full = fine_element_bytes(sys_d)
        ranks = info["ranks"]
        print(f"[sharded] fine element arrays per rank: "
              f"{[r['elements'] for r in ranks]} elements, "
              f"{[r['fine_bytes'] for r in ranks]} bytes against "
              f"{sys_d.K.A64.shape[0]} elements, {full} bytes unsharded "
              f"(system built on the card); the study's system and "
              f"hierarchy on {sys_.free.device}, the parent holding "
              f"{info['parent_device_bytes']} bytes on the card while the "
              f"ranks solved; |X - X_unsharded| {dx:.3e} (tol 1e-9)",
              flush=True)
        rec["mu_sweep"] = _json_info(info, dx=dx, unsharded_bytes=full)
        if not dx <= 1e-9:
            raise AssertionError(f"sharded X off the unsharded by {dx:.3e}")
        if info["all_reduces_per_iter"] != ALL_REDUCES["cg"]:
            raise AssertionError(f"{info['all_reduces_per_iter']} "
                                 "all-reduces per CG iteration")
        if not max(r["fine_bytes"] for r in ranks) < 0.6 * full:
            raise AssertionError("a rank holds more than its share of the "
                                 "fine element arrays")
        del sys_d
        # (b) the no-uptake study: sharded Stokes, then the Pe batch
        group.log = []
        t = time.time()
        nu_rows, nu_stats = no_uptake.run_geometry_study(
            ["reference"], PECLET, SHARD_H, device=dev, verbose=False,
            base_dir=str(OUT_DIR / "sh_nu"), shard=group)
        rec["no_uptake_study_s"] = time.time() - t
        golden = [r for r in _csv_rows(GOLDEN_NU_CSV)
                  if r["Domain"] == "rectangle" or _nu_key(r)[1:3]
                  == tuple(round(x, 9) for x in NU_GEOMETRIES["reference"])]
        rec["no_uptake_rows_worst"] = _floored(
            "sharded no_uptake", {_nu_key(r): r for r in nu_rows},
            {_nu_key(r): r for r in golden}, NU_SHARD_COLUMNS,
            NU_SHARD_FLOORS, SHARD_TOL)
        for s in nu_stats:
            print(f"[sharded] no_uptake {s['geometry']}: MINRES "
                  f"{s['minres_iters']} ({s['stokes_method']}), rel residual "
                  f"{s['stokes_rel_resnorm']:.3e}, stokes "
                  f"{s['stokes_s']:.3f}s; BiCGStab iters {s['iters']}, max "
                  f"true rel residual {max(s['rel_resnorm']):.3e}, solve "
                  f"{s['solve_s']:.3f}s", flush=True)
        du = {}
        for r in group.log:
            if r["kind"] != "stokes":
                continue
            dom, u, p = r["mesh"].domain_type, r["u"], r["p"]
            u0, p0 = stokes_for_study(r["mesh"], r["H"], dev)
            du[dom] = [float(np.abs(a.values - b.values).max()
                             / np.abs(b.values).max())
                       for a, b in ((u, u0), (p, p0))]
            si = u.solver_info
            ai = si["all_reduces_per_iter"]
            print(f"[sharded] Stokes {dom}: u, p off the unsharded field by "
                  f"{du[dom][0]:.3e}, {du[dom][1]:.3e} relative (tol 1e-7); "
                  f"MINRES {si['outer_iters']} against "
                  f"{u0.solver_info['outer_iters']} unsharded; all-reduces "
                  f"per iteration {ai:g}; the parent's setup peaked at "
                  f"{si['parent_setup_peak_bytes']} bytes on the card, and "
                  f"it held {si['parent_device_bytes']} there while the "
                  f"ranks solved (velocity K chunks "
                  f"{[x['fine_bytes'] for x in si['ranks']]} bytes)",
                  flush=True)
            if not max(du[dom]) <= 1e-7:
                raise AssertionError(f"sharded Stokes {dom} off by {du}")
            if ai != ALL_REDUCES["minres"]:
                raise AssertionError(f"{ai} all-reduces per MINRES "
                                     "iteration")
        if sorted(du) != ["rectangular", "sulcus"]:
            raise AssertionError(f"sharded Stokes solves of {sorted(du)}")
        rec["no_uptake"] = {"stats": nu_stats, "stokes_du": du}
        # (c) the adv-diff validation on both domains
        group.log = []
        t = time.time()
        ad_rows, ad_stats = adv_diff.run_advdiff_step_validation(
            str(OUT_DIR / "sh_ad"), SHARD_H, device=dev, verbose=False,
            shard=group)
        rec["adv_diff_study_s"] = time.time() - t
        batches = [r["info"] for r in group.log if r["kind"] == "sweep"]
        rec["adv_diff_rows_worst"] = _floored(
            "sharded adv_diff", {_ad_key(r): r for r in ad_rows},
            {_ad_key(r): r for r in ad_ref}, AD_SHARD_COLUMNS,
            AD_SHARD_FLOORS, SHARD_AD_TOL)
        if len(batches) != len(ad_stats):
            raise AssertionError(f"{len(batches)} sharded batches for "
                                 f"{len(ad_stats)} domains")
        for s, info_b in zip(ad_stats, batches):
            _print_transport(f"adv_diff {s['domain']} (B = 9 padded to 10)",
                             info_b)
            if info_b["all_reduces_per_iter"] != ALL_REDUCES["bicgstab"]:
                raise AssertionError(f"{info_b['all_reduces_per_iter']} "
                                     "all-reduces per BiCGStab iteration")
        rec["adv_diff"] = {"stats": ad_stats,
                           "solves": [_json_info(i) for i in batches]}
        rank_launches = dict(group.launches)
    finally:
        group.close()
    launches = read_launches()
    print(f"[sharded] launches in the ranks: {rank_launches}; in this "
          f"process (setup, metrics, unsharded references): {launches}",
          flush=True)
    for form in ("element_apply full", "element_apply out", PER_SAMPLE):
        if rank_launches[form] <= 0:
            raise AssertionError(f"kernel C's {form} form never launched "
                                 f"in the ranks: {rank_launches}")
    stray = [n for n in BF16_KEYS if rank_launches[n]]
    if stray or rank_launches["band_apply"] or rank_launches[
            "rect_band_apply"]:
        raise AssertionError(f"the sharded ranks launched {rank_launches}")
    # the same sweep at world size 1 on nccl: the backend of a host with
    # one card per rank
    t = time.time()
    with RankGroup(1, 1, dev, backend="nccl") as g1:
        X1, info1 = shs.solve_sweep_sharded(
            g1, sys_, D, mus, multilevel=ml, rtol=1e-12, maxiter=50000,
            chunk_iters=20, device=dev)
        for k, v in g1.launches.items():
            rank_launches[k] += v
    dx1 = float((X1 - X_ref).abs().max())
    rec["nccl1"] = _json_info(info1, dx=dx1,
                              spawn_and_solve_s=time.time() - t)
    _print_transport("mu sweep at world size 1 on nccl", info1)
    print(f"[sharded] nccl: |X - X_unsharded| {dx1:.3e} (tol 1e-9)",
          flush=True)
    if not dx1 <= 1e-9:
        raise AssertionError(f"nccl X off the unsharded by {dx1:.3e}")
    del sys_, ml, X, X1, X_ref
    torch.cuda.empty_cache()
    return rank_launches, rec


def phase_no_adv_studies(dev):
    """Phase-A's mu_eff study and Phase-B on two geometries, against the
    committed artifacts' rows."""
    from fenics_eff_uptake_tpu_torch.studies.phase_a import (
        run_mu_eff_analysis)
    from fenics_eff_uptake_tpu_torch.studies.phase_b import (
        run_no_adv_mu_sweep)

    fresh_cache("no_adv_studies")
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
    art = _artifacts()
    worst = art.check_rows("phase_a_spatial", me_rows,
                           "no_adv_studies mu_eff")
    worst.update(art.check_rows("phase_b", pb_rows, "no_adv_studies phase_b",
                                subset=lambda k: k[0] in PB_GEOMETRIES))
    return launches, stats, worst


def phase_mesh_convergence(dev):
    """The mesh-convergence study with the default ladder and the
    realisation check, against the committed artifact."""
    from fenics_eff_uptake_tpu_torch.studies.mesh_convergence import (
        DEFAULT_LADDER, run_mesh_convergence)

    fresh_cache("mesh_convergence")
    zero_launches()
    rows, meta, stats = run_mesh_convergence(
        dev, realisation_check=True,
        base_dir=str(OUT_DIR / "mesh_convergence"), verbose=False)
    launches = read_launches()
    print(f"[mesh_convergence] launches: {launches}", flush=True)
    for s in stats:
        print(f"[mesh_convergence] h={s['mesh_size']} ({s['cells']} cells, "
              f"{s['ndofs']} P2 dofs, multigrid {s['multilevel']}): mesh "
              f"{s['mesh_s']:.3f}s assembly {s['assembly_s']:.3f}s ml_setup "
              f"{s['ml_setup_s']:.3f}s solve {s['solve_s']:.3f}s metrics "
              f"{s['metrics_s']:.3f}s total {s['total_s']:.3f}s; CG iters "
              f"{s['iters']} in {s['passes']} passes, max rel residual "
              f"{max(s['rel_resnorm']):.3e}", flush=True)
        if not max(s["rel_resnorm"]) <= 1e-11:
            raise AssertionError(f"h={s['mesh_size']}: rel residual "
                                 f"{max(s['rel_resnorm']):.3e} > 1e-11")
        if s["multilevel"] and not max(s["iters"]) <= CG_BOUND:
            raise AssertionError(f"h={s['mesh_size']}: CG iterations "
                                 f"{s['iters']} > {CG_BOUND}")
    if [s["multilevel"] for s in stats[:len(DEFAULT_LADDER)]] != [
            h < 0.08 for h in DEFAULT_LADDER]:
        raise AssertionError("the multigrid path was not taken where the "
                             "hierarchy applies (h < 0.08)")
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the mesh-"
                             f"convergence study: {missing}")

    art = _artifacts()
    a = art.ARTIFACTS["richardson"]
    golden = _csv_rows(art.EXAMPLES / a.directory / a.csv)
    if [a.key(r) for r in rows] != [a.key(r) for r in golden]:
        raise AssertionError("row order differs from the artifact's")
    worst = art.check_rows("richardson", rows, "mesh_convergence")
    worst["convergence"] = art.check_convergence(meta)
    return launches, stats, worst, meta


# the el1 phase's family: PARITY.md's headline row, the one committed
# ladder with a factor-8 rung
EL1_FAMILY = (0.05, 1.0)


def phase_el1(dev):
    """The E_L1 ladder of ``EL1_FAMILY`` at h = 0.02 at exactly its
    committed (factor, Pe) pairs, rung by rung through
    ``el1_convergence.run_rung`` (memos released after each), held to the
    committed JAX rungs and summaries as ``--check`` holds them; every
    rung must launch A, B and C (both forms).  Returns (the launches of
    all rungs, the rung stats, the check record)."""
    from fenics_eff_uptake_tpu_torch.studies import el1_convergence as el

    fresh_cache("el1")
    w, d = EL1_FAMILY
    fam = el.committed_families()[EL1_FAMILY]
    rows, stats, total = [], [], None
    for factor, pes in el.family_pairs(fam["rows"]).items():
        zero_launches()
        r, st = el.run_rung(pes, w, d, 0.02, factor, dev)
        launches = read_launches()
        el.release(dev)
        print(f"[el1] factor {factor} launches: {launches}", flush=True)
        missing = never_launched(launches)
        if missing:
            raise AssertionError(f"kernels never launched by the factor-"
                                 f"{factor} rung: {missing}")
        bad = [x["max_rel_resnorm"] for x in r
               if not x["max_rel_resnorm"] <= 1e-11]
        if bad:
            raise AssertionError(f"factor {factor}: rel residuals {bad}")
        rows += r
        stats.append(dict(st, launches=launches))
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
    record = el.check_family(rows, w, d, fam)
    for where, sm in record["summaries"].items():
        print(f"[el1] summary {where}: {sm}", flush=True)
    return total, stats, record


# the setup-cache runs: the mu sweep, then the no-uptake study on the
# reference geometry (and its rectangle)
SETUP_CACHE_RUNS = ("cold", "disk", "disk_inproc", "memo")


def setup_cache_run(dev, tag):
    """One run of the mu sweep and the reference no-uptake study on the
    current cache directory and memos.  Saves every column X of both
    studies to build/chip_smoke/setup_cache_<tag>.npz; returns the stage
    seconds, iterations, passes, CSV rows and cache counts."""
    from fenics_eff_uptake_tpu_torch.studies import no_uptake, phase_a
    from fenics_eff_uptake_tpu_torch.utils import diskcache

    X = {}
    nab, tb = phase_a.no_adv_batch, no_uptake.transport_batch

    def nab_x(*a, **k):
        res, st = nab(*a, **k)
        X["mu_sweep"] = np.stack([np.asarray(r["c"].values) for r in res])
        return res, st

    def tb_x(mesh, *a, **k):
        out = tb(mesh, *a, **k)
        X[f"no_uptake_{mesh.domain_type}"] = out[0].cpu().numpy()
        return out

    diskcache.reset_stats()
    phase_a.no_adv_batch, no_uptake.transport_batch = nab_x, tb_x
    try:
        t0 = time.time()
        rows, st = phase_a.run_mu_sweep(
            dev, 0.02, base_dir=str(OUT_DIR / f"sc_{tag}"), verbose=False)
        nrows, nst = no_uptake.run_geometry_study(
            ["reference"], PECLET, 0.02,
            base_dir=str(OUT_DIR / f"sc_{tag}"), device=dev, verbose=False)
        wall = time.time() - t0
    finally:
        phase_a.no_adv_batch, no_uptake.transport_batch = nab, tb
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(OUT_DIR / f"setup_cache_{tag}.npz", **X)
    stages = ("mesh_s", "assembly_s", "ml_setup_s", "solve_s", "metrics_s",
              "total_s")
    return json.loads(json.dumps({
        "tag": tag, "wall_s": wall, "cache": cache_counts(),
        "mu_sweep": {**{k: st[k] for k in stages},
                     "s_per_point": st["total_s"] / B_SWEEP,
                     "iters": st["iters"], "passes": st["passes"]},
        "no_uptake": [{k: s[k] for k in (
            "geometry", "mesh_s", "stokes_setup_s", "stokes_solve_s",
            "assembly_s", "ml_setup_s", "solve_s", "metrics_s",
            "profiles_s", "total_s", "iters", "passes", "minres_iters",
            "stokes_method")} for s in nst],
        "rows": {"mu_sweep": rows, "no_uptake": nrows}},
        default=lambda v: v.item()))


def _setup_cache_child(tag):
    """``--setup-cache-child``: one setup-cache run in this fresh process,
    its record written to build/chip_smoke/setup_cache_<tag>.json."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from fenics_eff_uptake_tpu_torch.device import setup
    rec = setup_cache_run(setup("cuda"), tag)
    (OUT_DIR / f"setup_cache_{tag}.json").write_text(json.dumps(rec))


def _print_setup_cache_run(rec):
    tag, m = rec["tag"], rec["mu_sweep"]
    print(f"[setup_cache] {tag}: wall {rec['wall_s']:.3f}s; mu sweep mesh "
          f"{m['mesh_s']:.3f}s assembly {m['assembly_s']:.3f}s ml_setup "
          f"{m['ml_setup_s']:.3f}s solve {m['solve_s']:.3f}s metrics "
          f"{m['metrics_s']:.3f}s total {m['total_s']:.3f}s = "
          f"{m['s_per_point']:.4f} s/point", flush=True)
    for s in rec["no_uptake"]:
        print(f"[setup_cache] {tag}: no-uptake {s['geometry']} mesh "
              f"{s['mesh_s']:.3f}s stokes_setup {s['stokes_setup_s']:.3f}s "
              f"stokes_solve {s['stokes_solve_s']:.3f}s assembly "
              f"{s['assembly_s']:.3f}s ml_setup {s['ml_setup_s']:.3f}s "
              f"solve {s['solve_s']:.3f}s metrics {s['metrics_s']:.3f}s "
              f"profiles {s['profiles_s']:.3f}s total {s['total_s']:.3f}s "
              f"({s['stokes_method']})", flush=True)
    print(f"[setup_cache] {tag}: cache {rec['cache']}", flush=True)


def phase_setup_cache(dev):
    """Cold and disk-warm runs in child processes, then disk-warm and
    memo-warm runs in this process (``SETUP_CACHE_RUNS``), held bit for
    bit against each other."""
    from fenics_eff_uptake_tpu_torch.utils import diskcache

    d = Path(os.environ["FEU_SMOKE_CACHE_ROOT"]) / "setup_cache"
    d.mkdir(parents=True, exist_ok=False)
    recs = {}
    for tag in SETUP_CACHE_RUNS[:2]:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--setup-cache-child", tag], cwd=ROOT,
            env=dict(os.environ, FEU_CACHE_DIR=str(d)),
            capture_output=True, text=True, timeout=900)
        log = OUT_DIR / f"setup_cache_{tag}.log"
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print((proc.stdout + proc.stderr)[-3000:], flush=True)
            raise AssertionError(f"setup-cache child '{tag}' exited "
                                 f"{proc.returncode}; see {log}")
        recs[tag] = json.loads(
            (OUT_DIR / f"setup_cache_{tag}.json").read_text())
        recs[tag]["process_s"] = time.time() - t0
    os.environ["FEU_CACHE_DIR"] = str(d)
    diskcache.clear_memos()
    zero_launches()
    for tag in SETUP_CACHE_RUNS[2:]:
        recs[tag] = setup_cache_run(dev, tag)
    launches = read_launches()
    missing = never_launched(launches)
    if missing:
        raise AssertionError(f"kernels never launched by the warm runs: "
                             f"{missing}")
    for tag in SETUP_CACHE_RUNS:
        _print_setup_cache_run(recs[tag])
    for tag in SETUP_CACHE_RUNS[:2]:
        secs = recs[tag]["process_s"]
        print(f"[setup_cache] {tag}: child process {secs:.1f}s from start "
              "to exit", flush=True)

    cold = np.load(OUT_DIR / "setup_cache_cold.npz")
    if sorted(cold.files) != ["mu_sweep", "no_uptake_rectangular",
                              "no_uptake_sulcus"]:
        raise AssertionError(f"X of {cold.files}")
    for tag in SETUP_CACHE_RUNS[1:]:
        other = np.load(OUT_DIR / f"setup_cache_{tag}.npz")
        for k in cold.files:
            if not np.array_equal(cold[k], other[k]):
                raise AssertionError(f"{tag}: X of {k} differs from the "
                                     "cold run's")
        r, c = recs[tag], recs["cold"]
        if (r["mu_sweep"]["iters"] != c["mu_sweep"]["iters"]
                or r["mu_sweep"]["passes"] != c["mu_sweep"]["passes"]
                or [(s["iters"], s["passes"]) for s in r["no_uptake"]]
                != [(s["iters"], s["passes"]) for s in c["no_uptake"]]):
            raise AssertionError(f"{tag}: iterations or passes differ from "
                                 "the cold run's")
        if json.dumps(r["rows"]) != json.dumps(c["rows"]):
            raise AssertionError(f"{tag}: CSV rows differ from the cold "
                                 "run's")
    shapes = ", ".join(f"{k} {cold[k].shape}" for k in cold.files)
    print(f"[setup_cache] X ({shapes}), iterations, passes and CSV rows "
          f"bit-equal across {', '.join(SETUP_CACHE_RUNS)}", flush=True)

    def n(tag, t, kind):
        return recs[tag]["cache"].get(t, {}).get(kind, 0)

    for t in DISK_TAGS:
        if n("cold", t, "miss") <= 0:
            raise AssertionError(f"cold run: {t} {recs['cold']['cache']}")
        for tag in ("disk", "disk_inproc"):
            if n(tag, t, "disk") <= 0 or n(tag, t, "miss") != 0:
                raise AssertionError(f"{tag} run: {t} "
                                     f"{recs[tag]['cache']}")
    for t, c in recs["memo"]["cache"].items():
        if c["miss"] != 0:
            raise AssertionError(f"memo-warm run missed {t}: {c}")
    for t in ("port-mesh", "port-tsys", "port-mltransfer", "port-tbandplan",
              "port-ainv"):
        if n("memo", t, "memo") <= 0:
            raise AssertionError(f"memo-warm run: no memo hit of {t}")
    for r in recs.values():
        del r["rows"]
    return launches, recs


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
    ap.add_argument("--setup-cache-child", choices=SETUP_CACHE_RUNS[:2],
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.time()
    if not (ROOT / "fenics_eff_uptake_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fenics_eff_uptake_tpu_torch/ is not "
                         f"beside this script in {ROOT}; run it from a "
                         "checkout of the repository")
    if args.setup_cache_child:
        return _setup_cache_child(args.setup_cache_child)
    card = phase_device()
    # a fresh cache root for this run, removed at its end: no run starts
    # on another's entries
    cache_root = (ROOT / "build" / "cache"
                  / f"run-{os.getpid()}-{time.time_ns()}")
    cache_root.mkdir(parents=True)
    os.environ["FEU_SMOKE_CACHE_ROOT"] = str(cache_root)
    os.environ["FEU_CACHE_DIR"] = str(cache_root / "kernels")
    os.environ.pop("FEU_DISK_CACHE", None)
    try:
        _main(args, card, t_start)
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)


def _main(args, card, t_start):
    sys.path.insert(0, str(ROOT))
    import torch
    from fenics_eff_uptake_tpu_torch.device import setup
    from fenics_eff_uptake_tpu_torch.ops import _build

    dev = setup("cuda")
    CARD["name"] = card
    pk = card_peaks(dev)
    print(f"[device] peaks ({pk['kind']}, utils/roofline.py): HBM "
          f"{pk['hbm_gbps']} GB/s, bf16 {pk['bf16_tflops']}, f32 "
          f"{pk['f32_tflops']}, f64 {pk['f64_tflops']} TFLOP/s", flush=True)
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
    cases[PER_SAMPLE], a_cases, c16 = timed("kernels_advdiff",
                                            phase_kernels_advdiff)
    cases["band_apply"] += a_cases
    cases["element_apply bf16"].append(c16)
    for name, cs in timed("kernels_graded", phase_kernels_graded).items():
        cases[name] += cs
    launches, stats, stats2, worst = timed("slice", phase_slice)
    tl_launches, tl_rec = timed("twolevel", phase_twolevel)
    nu_launches, nu_stats, nu_stats2, nu_worst = timed("no_uptake",
                                                       phase_no_uptake)
    ad_launches, ad_stats, ad_stats2, ad_worst = timed("adv_diff",
                                                       phase_adv_diff)
    na_launches, na_stats, na_worst = timed("no_adv_studies",
                                            phase_no_adv_studies)
    mc_launches, mc_stats, mc_worst, mc_meta = timed(
        "mesh_convergence", phase_mesh_convergence)
    el_launches, el_stats, el_record = timed("el1", phase_el1)
    sc_launches, sc_recs = timed("setup_cache", phase_setup_cache)
    cfg_rows, cfg_launches = timed("configs", phase_configs)
    pr_launches, pr_stats, pr_worst = timed("per_run", phase_per_run)
    sh_launches, sh_rec = timed("sharded", phase_sharded)
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
    by_path = {"mu_sweep": launches, "twolevel": tl_launches,
               "no_uptake": nu_launches,
               "adv_diff": ad_launches, "no_adv_studies": na_launches,
               "mesh_convergence": mc_launches, "el1": el_launches,
               "setup_cache": sc_launches,
               "configs": cfg_launches, "per_run": pr_launches,
               "sharded": sh_launches}
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
               "twolevel": tl_rec,
               "no_uptake_first": nu_stats, "no_uptake_steady": nu_stats2,
               "no_uptake_golden_worst": nu_worst,
               "adv_diff_first": ad_stats, "adv_diff_steady": ad_stats2,
               "adv_diff_golden_worst": ad_worst,
               "no_adv_studies": na_stats,
               "no_adv_studies_golden_worst": na_worst,
               "mesh_convergence": mc_stats,
               "mesh_convergence_golden_worst": mc_worst,
               "mesh_convergence_metadata": mc_meta,
               "el1": el_stats, "el1_check": el_record,
               "setup_cache": sc_recs,
               "configs": cfg_rows, "per_run": pr_stats,
               "per_run_worst": pr_worst, "sharded": sh_rec,
               "phase_s": phase_s,
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
