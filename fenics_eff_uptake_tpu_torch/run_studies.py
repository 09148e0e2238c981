"""Run the full-size studies, one after the other (counterpart of the
repository's ``scripts/run_studies_tpu.py``).

    python -m fenics_eff_uptake_tpu_torch.run_studies STUDY [--check]
        [--mesh-size 0.02] [--out-base build/studies] [--device cuda]
        [--profile]

STUDY: phase_a_mu, phase_a_spatial, phase_a_geometry, phase_a_ar, phase_b,
adv_diff, richardson (the mesh-convergence ladder with its realisation
check; it takes no mesh size), no_uptake, or all (every one, in that order
but adv_diff first, as the JAX script runs them, and richardson last).

Each study writes its CSVs under ``<out-base>/<study dir>_<device>_h<h>/``
(``phase_a``, ``phase_b``, ``advdiff``, ``no_uptake``,
``mesh_convergence``), with the schemas of the committed artifacts
``examples/<study dir>_tpu_h0.02/``.  ``--check`` (h = 0.02 only) holds
every row written to the artifact's, column by column, with the
tolerances of ``studies/artifacts.py`` (the no-uptake study's profile
CSVs and the convergence orders too); the two stale no-uptake rows are
reported on a line of their own.  A study that raises, or a row off its
artifact, ends the run with the error: nothing is caught.

Per study it prints the seconds (ending in a device sync), the rows, the
batched runs (one per geometry and domain, or mesh rung), s/run, s/row,
the share of the seconds in the transport and Stokes solves, and with
``--profile`` the device's idle share (1 - the CUDA records' busy time
from ``torch.profiler`` over the seconds; profiling slows the host).  The
last line is one JSON object of all of it, also written to
``<out-base>/run_studies.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

STUDIES = ("phase_a_mu", "phase_a_spatial", "phase_a_geometry",
           "phase_a_ar", "phase_b", "adv_diff", "richardson", "no_uptake")
ALL = ("adv_diff", "phase_a_mu", "phase_a_spatial", "phase_a_geometry",
       "phase_a_ar", "phase_b", "no_uptake", "richardson")
DIRS = {"phase_a_mu": "phase_a", "phase_a_spatial": "phase_a",
        "phase_a_geometry": "phase_a", "phase_a_ar": "phase_a",
        "phase_b": "phase_b", "adv_diff": "advdiff",
        "no_uptake": "no_uptake", "richardson": "mesh_convergence"}
CHECK_H = 0.02


def _run_study(study, dev, h, out_dir):
    """(rows, the per-run stats list, the mesh-convergence metadata or
    None) of one study."""
    from .studies import adv_diff, mesh_convergence, no_uptake, phase_a
    from .studies import phase_b
    meta = None
    if study == "phase_a_mu":
        rows, stats = phase_a.run_mu_sweep(dev, h, base_dir=out_dir)
    elif study == "phase_a_spatial":
        rows, stats = phase_a.run_mu_eff_analysis(dev, mesh_size_dim=h,
                                                  base_dir=out_dir)
    elif study == "phase_a_geometry":
        rows, stats = phase_a.run_geometry_analysis(dev, mesh_size_dim=h,
                                                    base_dir=out_dir)
    elif study == "phase_a_ar":
        rows, stats = phase_a.run_aspect_ratio_analysis(dev, h,
                                                        base_dir=out_dir)
    elif study == "phase_b":
        rows, stats = phase_b.run_no_adv_mu_sweep(dev, out_dir,
                                                  mesh_size_dim=h)
    elif study == "adv_diff":
        rows, stats = adv_diff.run_advdiff_step_validation(
            out_dir, mesh_size_dim=h, device=dev)
    elif study == "no_uptake":
        rows, stats = no_uptake.run_geometry_study(
            mesh_size_dim=h, base_dir=out_dir, device=dev)
    elif study == "richardson":
        rows, meta, stats = mesh_convergence.run_mesh_convergence(
            dev, base_dir=out_dir, realisation_check=True)
    else:
        raise ValueError(f"unknown study {study!r}")
    return rows, (stats if isinstance(stats, list) else [stats]), meta


def _busy_s(prof):
    """Seconds of the CUDA records (kernels, copies, fills) of a trace;
    None where it holds none."""
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e6 if us > 0 else None


def _check(study, out_dir, rows, meta):
    """Every row the study wrote against its artifact."""
    from pathlib import Path

    from .studies import artifacts
    a = artifacts.ARTIFACTS[study]
    worst = artifacts.check_csv(study, out_dir)
    written = artifacts.read_rows(Path(out_dir) / a.csv)
    if len(written) != len(rows):
        raise AssertionError(f"[{study}] {len(written)} rows written, "
                             f"{len(rows)} returned")
    if study == "no_uptake":
        worst["profiles"] = artifacts.check_profiles(
            Path(out_dir) / "Geometry Comparison Analysis" / "Profiles")
    if study == "richardson":
        want = artifacts.read_rows(artifacts.EXAMPLES / a.directory / a.csv)
        if [a.key(r) for r in written] != [a.key(r) for r in want]:
            raise AssertionError("[richardson] row order differs from the "
                                 "artifact's")
        worst["convergence"] = artifacts.check_convergence(meta,
                                                           "richardson")
    return worst


def run(studies, device="cuda", mesh_size=CHECK_H, out_base="build/studies",
        check=False, profile=False):
    """Run ``studies`` in turn; returns {study: record}."""
    from .device import card_line, setup
    dev = setup(device)
    if check and mesh_size != CHECK_H:
        raise ValueError(f"--check holds rows to the h = {CHECK_H} "
                         f"artifacts, not h = {mesh_size}")
    card = card_line(dev)
    out = {}
    for study in studies:
        out_dir = os.path.join(
            out_base, f"{DIRS[study]}_{dev.type}_h{mesh_size:g}")
        print(f"\n===== {study} (h={mesh_size}, {dev}) =====", flush=True)
        prof = None
        if profile and dev.type == "cuda":
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rows, stats, meta = _run_study(study, dev, mesh_size, out_dir)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        busy = None
        if prof is not None:
            prof.__exit__(None, None, None)
            busy = _busy_s(prof)
        solve = sum(s.get("solve_s", 0.0) + s.get("stokes_solve_s", 0.0)
                    for s in stats)
        rec = {"seconds": sec, "rows": len(rows), "runs": len(stats),
               "s_per_run": sec / len(stats), "s_per_row": sec / len(rows),
               "solve_share": solve / sec,
               "idle_share": None if busy is None else 1.0 - busy / sec,
               "busy_s": busy, "out_dir": out_dir, "card": card}
        print(f"===== {study} done in {sec:.3f}s: {len(rows)} rows, "
              f"{len(stats)} runs, {rec['s_per_run']:.4f} s/run, "
              f"{rec['s_per_row']:.4f} s/row, solve share "
              f"{rec['solve_share']:.3f}, idle share "
              f"{'not measured' if busy is None else f'{1 - busy / sec:.3f}'}"
              f" =====", flush=True)
        if check:
            rec["worst"] = _check(study, out_dir, rows, meta)
            print(f"===== {study}: every row within its tolerance of "
                  "the artifact =====", flush=True)
        out[study] = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study", choices=[*STUDIES, "all"])
    ap.add_argument("--mesh-size", type=float, default=CHECK_H)
    ap.add_argument("--out-base", default="build/studies",
                    help="where the studies write (default build/studies)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    ap.add_argument("--check", action="store_true",
                    help="hold every row to the committed h = 0.02 "
                         "artifacts")
    ap.add_argument("--profile", action="store_true",
                    help="the device's idle share per study "
                         "(torch.profiler; slows the host)")
    args = ap.parse_args(argv)
    studies = ALL if args.study == "all" else (args.study,)
    out = run(studies, args.device, args.mesh_size, args.out_base,
              args.check, args.profile)
    os.makedirs(args.out_base, exist_ok=True)
    with open(os.path.join(args.out_base, "run_studies.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
