#!/usr/bin/env python3
"""How far the port's f32 BiCGStab iteration counts move with the order of
its f32 sums alone, on the CPU.

    python3 scripts/bicgstab_count_spread.py [--mesh-size H]
        [--threads 1,2,4,8] [--domains sulcus,rectangular]

On the CPU the plain kernel versions sum through PyTorch's einsum and
reductions, which split their work by the number of threads: another
thread count is another summation order of the same f32 numbers, and
nothing else changes.  For each thread count the script starts itself
anew with ``OMP_NUM_THREADS`` set (a running process does not take every
change of it), and that process runs, for each domain of the no-uptake
study's reference geometry (w = 0.5, d = 1.0 mm), what the study runs:
the Stokes solve, the advective system and its hierarchy, and the batched
BiCGStab transport solve (Pe = 0.1, 1, 10; the mult cycle).  It prints the
MINRES iterations, the BiCGStab iterations per Pe column, the passes and
the largest true f64 relative residual.  One code version, one mesh: a
count that moves here moves with summation order.

At h = 0.035 on 8 cores (about 8 minutes) the Pe = 10 column reads 151,
162, 166, 158 on the sulcus and 172, 168, 226, 154 on the rectangle with 1,
2, 4, 8 threads (MINRES 130 to 132 and 123 to 124), every residual below
1e-12; the commits of the port's first flow slice and of its fifth slice
give the same numbers at the same thread count.  The last line is
one JSON object with every run.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PECLET = [0.1, 1.0, 10.0]


def one(mesh_size, domains):
    """This process's runs, at the thread count it was started with."""
    sys.path.insert(0, str(ROOT))
    import torch
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel_for)
    from fenics_eff_uptake_tpu_torch.studies.common import (
        make_mesh, stokes_for_study)
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params

    D = [1.0 / pe for pe in PECLET]
    mu0 = [0.0] * len(D)
    runs = []
    for domain in domains:
        t0 = time.time()
        p = _make_params(PECLET[0], 0.5, 1.0, mesh_size)
        mesh = make_mesh(p, domain)
        u, _ = stokes_for_study(mesh, p.H, "cpu")
        sys_ = build_transport_system(mesh, "cpu", u_values=u.values,
                                      u_space=u.space)
        ml = build_multilevel_for(sys_, mesh, D, mu0, u_fine=u)
        _, info = solve_sweep(sys_, D, mu0, multilevel=ml)
        runs.append({"domain": domain, "cells": int(mesh.num_cells),
                     "threads": torch.get_num_threads(),
                     "minres": int(u.solver_info["outer_iters"]),
                     "iters": info["iters"].tolist(),
                     "passes": info["passes"],
                     "max_rel_resnorm": float(info["rel_resnorm"].max()),
                     "seconds": time.time() - t0})
    print(json.dumps(runs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-size", type=float, default=0.035)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--domains", default="sulcus,rectangular")
    ap.add_argument("--one", action="store_true",
                    help="run once in this process (what the script starts "
                         "for each thread count)")
    args = ap.parse_args(argv)
    domains = args.domains.split(",")
    if args.one:
        return one(args.mesh_size, domains)
    runs = []
    for n in (int(t) for t in args.threads.split(",")):
        env = dict(os.environ, OMP_NUM_THREADS=str(n), MKL_NUM_THREADS=str(n))
        res = subprocess.run(
            [sys.executable, __file__, "--one", "--mesh-size",
             str(args.mesh_size), "--domains", args.domains],
            env=env, capture_output=True, text=True, timeout=7200)
        if res.returncode != 0:
            raise RuntimeError(f"{n} threads: {res.stderr[-2000:]}")
        for run in json.loads(res.stdout.strip().splitlines()[-1]):
            runs.append(run)
            print(f"[spread] {run['domain']} h={args.mesh_size} "
                  f"({run['cells']} cells) threads {run['threads']}: MINRES "
                  f"{run['minres']}, BiCGStab {run['iters']} in "
                  f"{run['passes']} passes, max rel residual "
                  f"{run['max_rel_resnorm']:.2e}, {run['seconds']:.1f}s",
                  flush=True)
    for domain in domains:
        its = np.array([r["iters"] for r in runs if r["domain"] == domain])
        print(f"[spread] {domain}: per column min {its.min(0).tolist()} max "
              f"{its.max(0).tolist()} (max / min "
              f"{(its.max(0) / its.min(0)).round(3).tolist()})", flush=True)
    print(json.dumps({"mesh_size": args.mesh_size, "runs": runs}))


if __name__ == "__main__":
    main()
