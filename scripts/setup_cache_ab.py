#!/usr/bin/env python3
"""Setup seconds of two checkouts of the PyTorch port, in turns, each run a
fresh process on an empty cache directory.

    git archive HEAD | tar -x -C ab_parent          # the parent, git-ignored
    python3 scripts/setup_cache_ab.py --tree parent=ab_parent --tree change=. \\
        [--order parent,change,change,parent,parent,change] \
        [--out build/setup_cache_ab.json]

Each run (one fresh process per entry of ``--order``) does, on the CUDA
device, the 20-point Phase-A mu sweep at h = 0.02 (``run_mu_sweep``) and
then the no-uptake study on the reference geometry and its rectangle
(``run_geometry_study``), after one warm-up run of both at h = 0.05, twice
each: a first run on the empty directory
(cold: every setup built, and where the tree has the setup cache, its
entries written, under build/setup_cache_ab/) and a second in the same process (the parent's full
rebuild, the change's memo-warm run).  Prints each run's stage seconds,
s/point and s/geometry, the card's name and power limit, and writes them
all to ``--out``.  Compare two trees only within one call.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# cache directories and study outputs (git-ignored)
SCRATCH = ROOT / "build" / "setup_cache_ab"
PECLET = [0.1, 1.0, 10.0]
WARMUP_H = 0.05
B_SWEEP = 20
MU_STAGES = ("mesh_s", "assembly_s", "ml_setup_s", "solve_s", "metrics_s",
             "total_s")
NU_STAGES = ("mesh_s", "stokes_setup_s", "stokes_solve_s", "assembly_s",
             "ml_setup_s", "solve_s", "metrics_s", "total_s")


def child(tree, out):
    """One process of one tree: both studies, first and second run."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("setup_cache_ab: no CUDA device")
    sys.path.insert(0, str(Path(tree).resolve()))
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import (
        run_geometry_study)
    from fenics_eff_uptake_tpu_torch.studies.phase_a import run_mu_sweep
    from fenics_eff_uptake_tpu_torch.ops import _build
    _build.library()        # the kernel build stays out of the first run
    work = Path(tempfile.mkdtemp(dir=SCRATCH, prefix="ab_work_"))
    # the process's own first-use costs (CUDA context, library handles,
    # lazy imports) stay out of the first run too: both studies once at
    # another h, whose setup shares nothing with h = 0.02
    run_mu_sweep("cuda", WARMUP_H, base_dir=str(work / "warmup"),
                 verbose=False)
    run_geometry_study(["reference"], PECLET, WARMUP_H,
                       base_dir=str(work / "warmup"), device="cuda",
                       verbose=False)
    runs = []
    for run in ("first", "second"):
        _, st = run_mu_sweep("cuda", 0.02, base_dir=str(work / run),
                             verbose=False)
        _, nst = run_geometry_study(["reference"], PECLET, 0.02,
                                    base_dir=str(work / run), device="cuda",
                                    verbose=False)
        runs.append({
            "run": run,
            "mu_sweep": {**{k: st[k] for k in MU_STAGES},
                         "s_per_point": st["total_s"] / B_SWEEP,
                         "iters": st["iters"]},
            "no_uptake": [{"geometry": s["geometry"],
                           **{k: s[k] for k in NU_STAGES},
                           "iters": s["iters"]} for s in nst]})
    out.write_text(json.dumps(runs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of the repository")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, one process each "
                         "(default: a,b,b,a,a,b of the first two trees)")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "setup_cache_ab.json"))
    ap.add_argument("--child", nargs=2, metavar=("DIR", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child[0], Path(args.child[1]))
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = (args.order.split(",") if args.order
             else [names[0], names[1], names[1], names[0], names[0],
                   names[1]])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    results = []
    for i, name in enumerate(order):
        cache = Path(tempfile.mkdtemp(dir=SCRATCH, prefix="ab_cache_"))
        rec = out.with_name(f"{out.stem}_{i}_{name}.json")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, __file__, "--child", trees[name], str(rec)],
            env=dict(os.environ, FEU_CACHE_DIR=str(cache)),
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print((proc.stdout + proc.stderr)[-3000:], flush=True)
            raise SystemExit(f"{name} exited {proc.returncode}")
        for r in json.loads(rec.read_text()):
            m = r["mu_sweep"]
            print(f"[{i} {name} {r['run']}] mu sweep " + " ".join(
                f"{k[:-2]} {m[k]:.3f}" for k in MU_STAGES)
                + f" = {m['s_per_point']:.4f} s/point", flush=True)
            for s in r["no_uptake"]:
                print(f"[{i} {name} {r['run']}] no-uptake {s['geometry']} "
                      + " ".join(f"{k[:-2]} {s[k]:.3f}" for k in NU_STAGES),
                      flush=True)
            results.append({"process": i, "tree": name, **r})
        print(f"[{i} {name}] process {time.time() - t0:.1f}s", flush=True)
    out.write_text(json.dumps({"card": card, "order": order,
                               "runs": results}, indent=1))


if __name__ == "__main__":
    main()
