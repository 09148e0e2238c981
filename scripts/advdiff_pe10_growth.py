#!/usr/bin/env python3
"""How the adv-diff step-mu study's BiCGStab counts grow with refinement,
in the JAX package and in the port, on the CPU.

    python3 scripts/advdiff_pe10_growth.py [--mesh-sizes 0.06,0.035]
        [--packages jax,torch] [--threads 4]

For each mesh size, each package runs ``run_advdiff_step_validation`` over
the full 3 x 3 Pe x mu grid (the sulcus batch with uniform mu per column,
the rectangle batch with per-column step-mu Robin matrices).  The JAX
package runs in the TPU configuration, forced on the CPU by the knobs its
own tests use: ``precision="mixed"`` (f32 BiCGStab inside f64 defect
correction), ``FEU_ML_BAND=1`` (banded level operators) and
``FEU_ML_TBAND=1`` (windowed-band transfers); the mult cycle is both
backends' nonsymmetric default.  The port runs its defaults, which are
that configuration.  Each run prints its iterations per column and passes;
then, per package, domain and Pe = 10 column (mu factors 0.1, 1, 10), the
growth ratio of the iterations from the first mesh size to the second;
then the port's ratio over JAX's.  A ratio within JAX's times 1.47 (the
f32 summation-order spread of one solve's counts, see
``scripts/bicgstab_count_spread.py``) is the method's growth, not the
port's.  The last line is one JSON object with every run.

With the defaults (about 6 minutes on 4 CPU threads) the Pe = 10 columns
grow from h = 0.06 to h = 0.035 by 1.34-1.42 (sulcus) and 1.36-1.46
(rectangle) in JAX, and by 1.28-1.43 and 1.35-1.42 in the port: the
port's ratio is 0.94-1.05 of JAX's in every column.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SPREAD = 1.47
PE10 = slice(6, 9)      # the Pe = 10 columns of the Pe-major grid


def one(package, mesh_size):
    """One package's study at one mesh size, in this process: (per domain
    iterations, passes, seconds)."""
    sys.path.insert(0, str(ROOT))
    out = tempfile.mkdtemp(prefix="advdiff_growth_")
    t0 = time.time()
    runs = {}
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        os.environ["FEU_ML_BAND"] = "1"
        os.environ["FEU_ML_TBAND"] = "1"
        from fenics_eff_uptake_tpu.studies import adv_diff as jadv
        batch = jadv._transport_batch
        order = iter(("sulcus", "rectangular"))

        def counted(*a, **kw):
            X, info, sys_t = batch(*a, **kw)
            passes = info.get("passes")
            runs[next(order)] = {
                "iters": np.asarray(info["iters"]).tolist(),
                "passes": None if passes is None else int(np.asarray(passes))}
            return X, info, sys_t
        jadv._transport_batch = counted
        jadv.run_advdiff_step_validation(out, mesh_size_dim=mesh_size,
                                         precision="mixed", verbose=False)
    else:
        from fenics_eff_uptake_tpu_torch.studies import adv_diff as tadv
        _, stats = tadv.run_advdiff_step_validation(
            out, mesh_size_dim=mesh_size, device="cpu", verbose=False)
        for s in stats:
            runs[s["domain"]] = {"iters": list(s["iters"]),
                                 "passes": s["passes"]}
    print(json.dumps({"package": package, "mesh_size": mesh_size,
                      "runs": runs, "seconds": time.time() - t0}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-sizes", default="0.06,0.035")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--one", nargs=2, metavar=("PACKAGE", "H"),
                    help="run one package at one mesh size in this process "
                         "(what the script starts for each)")
    args = ap.parse_args(argv)
    if args.one:
        return one(args.one[0], float(args.one[1]))
    sizes = [float(h) for h in args.mesh_sizes.split(",")]
    packages = args.packages.split(",")
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads),
               MKL_NUM_THREADS=str(args.threads), JAX_PLATFORMS="cpu")
    results = []
    for h in sizes:
        for pkg in packages:
            res = subprocess.run([sys.executable, __file__, "--one", pkg,
                                  str(h)], env=env, capture_output=True,
                                 text=True, timeout=7200)
            if res.returncode != 0:
                raise RuntimeError(f"{pkg} h={h}: {res.stderr[-3000:]}")
            r = json.loads(res.stdout.strip().splitlines()[-1])
            results.append(r)
            for dom, run in r["runs"].items():
                print(f"[growth] {pkg} h={h} {dom}: BiCGStab {run['iters']} "
                      f"in {run['passes']} passes ({r['seconds']:.0f}s)",
                      flush=True)
    ratios = {}
    for pkg in packages:
        for dom in ("sulcus", "rectangular"):
            its = [np.array(next(r for r in results if r["package"] == pkg
                                 and r["mesh_size"] == h)["runs"][dom]
                            ["iters"])[PE10] for h in sizes]
            ratios[(pkg, dom)] = its[-1] / its[0]
            print(f"[growth] {pkg} {dom} Pe=10 (mu 0.1, 1, 10): "
                  f"{its[0].tolist()} -> {its[-1].tolist()}, ratio "
                  f"{np.round(ratios[(pkg, dom)], 3).tolist()}", flush=True)
    verdict = {}
    if {"jax", "torch"} <= set(packages):
        for dom in ("sulcus", "rectangular"):
            q = ratios[("torch", dom)] / ratios[("jax", dom)]
            ok = bool(np.all((q <= SPREAD) & (q >= 1 / SPREAD)))
            verdict[dom] = {"port_over_jax": np.round(q, 3).tolist(),
                            "within_spread": ok}
            print(f"[growth] {dom}: port ratio / JAX ratio "
                  f"{np.round(q, 3).tolist()} (within {SPREAD}x: {ok})",
                  flush=True)
    print(json.dumps({"mesh_sizes": sizes, "results": results,
                      "verdict": verdict}))


if __name__ == "__main__":
    main()
