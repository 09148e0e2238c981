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
   tolerance; prints errors and median times from CUDA events.
4. slice: the 20-point Phase-A mu sweep at h = 0.02 through
   studies.phase_a.run_mu_sweep, twice (first and steady run).  Checks that
   every kernel was launched by the first run, the true f64 relative
   residuals (<= 1e-11), the inner iterations (<= 40 per column), and the
   CSV columns against the committed JAX artifact
   examples/phase_a_tpu_h0.02 (1e-6 relative).

With ``--profile``, a fifth phase profiles one more steady sweep: cProfile
of the whole ``no_adv_batch`` (where the host setup goes) and
``torch.profiler`` of one ``solve_sweep`` (device busy time by kernel, and
the device's idle share against the unprofiled solve's wall time).  Full
reports go to build/chip_smoke/profile_*.txt and solve_trace.json.

Then prints one JSON line of per-kernel results and, last, the device line.
Imports nothing of JAX.
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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_CSV = (ROOT / "examples" / "phase_a_tpu_h0.02"
              / "Mu Parameter Sweep Analysis"
              / "mu_parameter_sweep_results.csv")
OUT_DIR = ROOT / "build" / "chip_smoke"
B_SWEEP = 20
BENCH_CELLS = 50647
PALLAS = "fenics_eff_uptake_tpu/ops/pallas_kernels.py"
CSRC = "fenics_eff_uptake_tpu_torch/ops/csrc"


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


def compare(label, kernel, plain, rtol):
    """Kernel vs plain on the same inputs: errors + median times."""
    import torch
    yk = kernel()
    yp = plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(yk).all()):
        raise AssertionError(f"{label}: kernel output is not finite")
    abs_err = float((yk - yp).abs().max())
    scale = float(yp.abs().max())
    rel = abs_err / scale if scale > 0 else abs_err
    ms = median_ms(kernel)
    plain_ms = median_ms(plain)
    print(f"[kernels] {label}: max_abs_err {abs_err:.3e} max_rel_err "
          f"{rel:.3e} (tol {rtol:.0e}) kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms", flush=True)
    if not rel <= rtol:
        raise AssertionError(f"{label}: relative error {rel:.3e} > {rtol}")
    return {"case": label, "max_abs_err": abs_err, "max_rel_err": rel,
            "ms": ms, "plain_ms": plain_ms}


def phase_kernels(dev):
    """Each kernel against its plain version at the sweep's own shapes."""
    import torch
    from fenics_eff_uptake_tpu_torch.ops.banded import (
        band_apply, band_apply_plain, rect_band_apply, rect_band_apply_plain)
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import (
        element_apply, element_apply_plain)
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
    for label, band in (("fine", sys_.Kband),
                        ("mid", ml.levels[1].sys.Kband)):
        X = rnd(band.shape[0] * band.shape[1], torch.float32)
        out["band_apply"].append(compare(
            f"A {label} band {tuple(band.shape)} B={B_SWEEP}",
            lambda: band_apply(band, X, coef32),
            lambda: band_apply_plain(band, X, coef32), 1e-5))
    # B: the fine level's restriction and prolongation bands
    tb = ml.levels[0].bands
    for label, band, offs, rows in (("restrict", tb.r, tb.ro, tb.pad_r),
                                    ("prolong", tb.p, tb.po, tb.pad_p)):
        Xq = rnd(rows, torch.float32)
        out["rect_band_apply"].append(compare(
            f"B fine {label} {tuple(band.shape)} B={B_SWEEP}",
            lambda: rect_band_apply(band, offs, Xq),
            lambda: rect_band_apply_plain(band, offs, Xq), 1e-5))
    # C: f64 K and Robin (P2 cells, nd=6), f32 Robin, and the mid level's
    # P1 Robin (nd=3); 1e-12 in f64, 2e-5 in f32 (summation order)
    for label, blk, dtype, rtol in (
            ("f64 K", sys_.K, torch.float64, 1e-12),
            ("f64 R", sys_.R, torch.float64, 1e-12),
            ("f32 R", sys_.R, torch.float32, 2e-5),
            ("f32 mid R", ml.levels[1].sys.R, torch.float32, 2e-5)):
        A = blk.A64 if dtype == torch.float64 else blk.A32
        X = rnd(blk.ndofs, dtype)
        coef = coef32.to(dtype)
        out["element_apply"].append(compare(
            f"C {label} A{tuple(A.shape)} B={B_SWEEP}",
            lambda: element_apply(A, blk.dofs, blk.scatter, X, coef),
            lambda: element_apply_plain(A, blk.dofs, blk.scatter, X, coef),
            rtol))
    del sys_, ml
    torch.cuda.empty_cache()
    return out


def read_golden():
    with open(GOLDEN_CSV, newline="") as f:
        return list(csv.DictReader(f))


def check_against_golden(rows, stats):
    golden = read_golden()
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


def phase_slice(dev):
    from fenics_eff_uptake_tpu_torch.ops.banded import (band_apply,
                                                        rect_band_apply)
    from fenics_eff_uptake_tpu_torch.ops.elemspmv import element_apply
    from fenics_eff_uptake_tpu_torch.studies.phase_a import run_mu_sweep

    kernels = {"band_apply": band_apply, "rect_band_apply": rect_band_apply,
               "element_apply": element_apply}
    for k in kernels.values():
        k.launches = 0
    rows, stats = run_mu_sweep(dev, 0.02, base_dir=str(OUT_DIR / "first"),
                               verbose=True)
    launches = {name: k.launches for name, k in kernels.items()}
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
    missing = [n for n, c in launches.items() if c <= 0]
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


def phase_profile(dev):
    """cProfile of one steady sweep, torch.profiler of one steady solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, make_no_adv_params, no_adv_batch, sweep_mus)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import MU_SWEEP_REGIMES

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    factors = [f for r in MU_SWEEP_REGIMES.values() for f in r]
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=0.02)
    pr = cProfile.Profile()
    pr.enable()
    _, st = no_adv_batch(geom, factors, "sulcus", dev, verbose=False)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(60)
    (OUT_DIR / "profile_sweep.txt").write_text(buf.getvalue())
    print("[profile] cProfiled sweep: " + " ".join(
        f"{k} {st[k]:.3f}s" for k in ("mesh_s", "assembly_s", "ml_setup_s",
                                      "solve_s", "metrics_s", "total_s")),
        flush=True)
    stats = pstats.Stats(pr)
    rows = []
    for (fname, line, func), (_, nc, tt, ct, _) in stats.stats.items():
        rows.append((ct, tt, nc, f"{Path(fname).name}:{line}({func})"))
    for ct, tt, nc, name in sorted(rows, reverse=True)[:40]:
        print(f"[profile] cum {ct:8.3f}s own {tt:8.3f}s {nc:7d}x {name}",
              flush=True)

    mesh = make_mesh(geom)
    mus = sweep_mus(geom, factors)
    D = [geom.D] * len(mus)
    sys_ = build_transport_system(mesh, dev)
    ml = build_multilevel_for(sys_, mesh, D, mus)
    for _ in range(2):
        solve_sweep(sys_, D, mus, multilevel=ml)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        solve_sweep(sys_, D, mus, multilevel=ml)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_sweep(sys_, D, mus, multilevel=ml)
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
    print(f"[profile] steady solve wall {[round(w, 4) for w in walls]} s "
          f"(unprofiled); device busy {busy / 1e3:.3f} ms -> idle share "
          f"{1 - busy / 1e6 / wall:.3f} of the median wall", flush=True)
    table = sorted(per.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in table[:15]:
        print(f"[profile] device {us / 1e3:8.3f} ms {n:6d}x {name}",
              flush=True)
    (OUT_DIR / "profile_solve.txt").write_text("".join(
        f"{us / 1e3:10.3f} ms {n:7d}x {name}\n"
        for name, (n, us) in table))
    prof.export_chrome_trace(str(OUT_DIR / "solve_trace.json"))
    del sys_, ml
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one steady sweep (host and device)")
    args = ap.parse_args(argv)
    t_start = time.time()
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
    launches, stats, stats2, worst = phase_slice(dev)
    if args.profile:
        phase_profile(dev)

    meta = {
        "band_apply": ("band_apply.cu", f"{PALLAS}:155"),
        "rect_band_apply": ("band_apply.cu", f"{PALLAS}:274"),
        "element_apply": ("element_apply.cu", f"{PALLAS}:51"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        cs = cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "max_rel_err": max(c["max_rel_err"] for c in cs),
            "ms": cs[0]["ms"], "plain_ms": cs[0]["plain_ms"],
            "cases": cs})
    summary = {"card": card, "build_s": build_s, "kernels": kernels,
               "first": stats, "steady": stats2, "golden_worst": worst,
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
