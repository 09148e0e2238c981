"""Headline benchmark of the port (counterpart of the repository's
``bench.py``): assembly + preconditioner setup + solve wall-clock per sweep
point of the Phase-A mu sweep.

    python -m fenics_eff_uptake_tpu_torch.bench [--precond ml|twolevel]
        [--mesh-size 0.02] [--precision mixed|f64|f32] [--device cuda|cpu]

The workload and the methodology are ``bench.py``'s: the 20 mu factors of
``MU_SWEEP_REGIMES`` (D = 1) on the 0.25 x 0.25 sulcus at h = 0.02 (50,647
cells, ~1e5 P2 dofs) as one batched solve; a cold and a warm assembly;
the preconditioner (the 4-level multigrid hierarchy on the fine mesh and
meshes at 3h and 9h, or the two-level one on a mesh at 4h) set up cold,
then rebuilt three times; three solves at mu perturbed by 1e-7 (rep + 1)
relative;

    value = (warm assembly + least warm setup + least solve) / 20.

Every stage ends in a device sync.  The run keeps its setup cache in the
process only (the disk cache is off, so no entry of an earlier run is
read), and empties the memos before each warm stage, so that each stage
does its work anew; ``meta.cache_stats`` gives the cache's counts per
stage (a memo hit inside a stage shows there).  ``meta`` has ``bench.py``'s
keys, and the card's name and power limit (``card``), the solve's passes,
its kernel launches (``launches``: the last solve's) and the cache counts.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "meta"};
on a failure a line with "error" and exit code 1.  The default device is
the card; without one the run fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REF_SECONDS_PER_POINT = 2.0   # bench.py's assumed serial FEniCS cost
N_MU = 20
KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
METRIC = ("assembly+solve wall-clock per sweep point (20-mu batched sweep, "
          "~1e5 P2 dofs)")
RTOL = 1e-11
PRECONDS = ("ml", "twolevel")
# meta keys this bench adds to bench.py's
EXTRA_META = ("card", "passes", "launches", "cache_stats")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _stats_since(before):
    """The setup cache's counts since the snapshot ``before``."""
    from .utils.diskcache import CACHE_STATS
    out = {}
    for tag, n in CACHE_STATS.items():
        d = {k: v - before.get(tag, {}).get(k, 0) for k, v in n.items()}
        if any(d.values()):
            out[tag] = d
    return out


def _snapshot():
    from .utils.diskcache import CACHE_STATS
    return {t: dict(n) for t, n in CACHE_STATS.items()}


def run(precond="ml", mesh_size=0.02, precision="mixed", device="cuda"):
    """The bench line's dict."""
    from .device import card_line, setup
    from .meshing.generator import generate_mesh
    from .parallel.sharding import kernel_launches
    from .parallel.sweep import build_transport_system, solve_sweep
    from .solvers.multilevel import build_multilevel
    from .solvers.twolevel import build_twolevel
    from .studies.phase_a import MU_SWEEP_REGIMES
    from .utils.diskcache import CACHE_STATS, clear_memos
    from .utils.roofline import (assembly_cost, chip_peaks,
                                 ml_cg_iteration_cost, roofline_summary)

    if precond not in PRECONDS:
        raise ValueError(f"unknown preconditioner {precond!r}")
    dev = setup(device)
    card = card_line(dev)
    cache = {}

    def stage(name, fn):
        before = _snapshot()
        t0 = _sync(dev)
        out = fn()
        dt = _sync(dev) - t0
        cache.setdefault(name, []).append(_stats_since(before))
        return out, dt

    t0 = time.perf_counter()
    mesh = generate_mesh(mesh_size=mesh_size, **KW)
    if precond == "ml":
        aux = [mesh, generate_mesh(mesh_size=max(3 * mesh_size, 0.06), **KW),
               generate_mesh(mesh_size=max(9 * mesh_size, 0.18), **KW)]
    else:
        aux = [generate_mesh(mesh_size=max(4 * mesh_size, 0.08), **KW)]
    t_mesh = time.perf_counter() - t0

    def assemble():
        return build_transport_system(mesh, dev, element="P2")

    sys_t, t_asm_cold = stage("assembly_cold", assemble)
    clear_memos()
    sys_t, t_asm = stage("assembly", assemble)

    mus = np.array([f for r in MU_SWEEP_REGIMES.values() for f in r],
                   dtype=np.float64)[:N_MU]
    D = np.ones_like(mus)

    def build():
        if precond == "ml":
            return {"multilevel": build_multilevel(sys_t, aux, D, mus)}
        return {"twolevel": build_twolevel(sys_t, aux[0], D, mus)}

    def solve(scale):
        return solve_sweep(sys_t, D, mus * scale, rtol=RTOL,
                           precision=precision, **pre)

    pre, t_setup_cold = stage("setup_cold", build)
    (X, info), t_first = stage("first_solve", lambda: solve(1.0))
    t_setup = t_solve = None
    for rep in range(3):
        clear_memos()
        pre, t = stage("setup", build)
        t_setup = t if t_setup is None else min(t_setup, t)
        n0 = kernel_launches()
        (X, info), t = stage("solve",
                             lambda: solve(1.0 + 1e-7 * (rep + 1)))
        launches = {k: v - n0[k] for k, v in kernel_launches().items()}
        t_solve = t if t_solve is None else min(t_solve, t)
    if not info["converged"].all():
        raise RuntimeError(f"columns did not converge: {info['iters']}")

    per_point = (t_asm + t_setup + t_solve) / len(mus)
    pk = chip_peaks(dev)
    ac = assembly_cost(sys_t)
    gbps = ac["bytes"] / max(t_asm, 1e-12) / 1e9
    meta = {
        "mesh_cells": int(mesh.num_cells),
        "ndofs": int(sys_t.ndofs),
        "n_sweep_points": int(len(mus)),
        "mesh_gen_s": t_mesh,
        "assembly_s": t_asm,
        "assembly_cold_s": t_asm_cold,
        "twolevel_setup_s": t_setup,
        "twolevel_setup_cold_s": t_setup_cold,
        "first_solve_s": t_first,
        "steady_solve_s": t_solve,
        "iters": np.asarray(info["iters"]).tolist(),
        "max_resnorm": float(np.max(info["resnorm"])),
        "max_rel_resnorm": float(np.max(info["rel_resnorm"])),
        "preconditioner": precond,
        "backend": dev.type,
        "assembled_dofs_per_s": (int(sys_t.ndofs / t_asm) if t_asm > 0
                                 else None),
        "assembly_roofline": {
            "modeled_bytes_mb": ac["bytes"] / 2**20,
            "achieved_gbps": gbps,
            "hbm_roofline_pct": 100.0 * gbps / pk["hbm_gbps"]},
        "baseline_assumption_s_per_point": REF_SECONDS_PER_POINT,
        "baseline_sensitivity": {
            "speedup_if_baseline_1.0s": 1.0 / per_point,
            "speedup_if_baseline_2.0s": 2.0 / per_point,
            "speedup_if_baseline_4.0s": 4.0 / per_point,
            "min_baseline_for_10x_s": 10 * per_point,
        },
        "banded_operator": sys_t.Kband is not None,
        "ml_transfer_cache": dict(CACHE_STATS.get("port-mltransfer", {})),
        "card": card,
        "passes": info.get("passes"),
        "launches": launches,
        "cache_stats": cache,
    }
    if precond == "ml":
        cycle = "mult" if precision == "f64" else "hybrid"
        cost = ml_cg_iteration_cost(sys_t, pre["multilevel"], len(mus),
                                    cycle=cycle)
        meta["ml_cycle"] = cycle
        meta["roofline"] = roofline_summary(
            cost, iters_executed=int(np.max(info["iters"])), wall_s=t_solve,
            passes_f64=int(info.get("passes") or 0) + 1, sys_t=sys_t,
            B=len(mus), peaks=pk)
    return {"metric": METRIC, "value": per_point, "unit": "s/point",
            "vs_baseline": REF_SECONDS_PER_POINT / per_point, "meta": meta}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precond", choices=PRECONDS, default="ml")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--precision", choices=("mixed", "f64", "f32"),
                    default="mixed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    os.environ["FEU_DISK_CACHE"] = "0"
    try:
        line = run(args.precond, args.mesh_size, args.precision,
                   args.device)
    except Exception as e:      # one line for the reader, and exit 1
        print(json.dumps({"metric": METRIC, "value": None,
                          "unit": "s/point", "vs_baseline": None,
                          "error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
