"""Mesh-convergence (refinement ladder) study (counterpart of
``studies/mesh_convergence.py``).

The reference configuration (0.5 x 1.0 mm sulcus, mu factors 0.1, 1, 10)
runs across an h-refinement ladder, one batched solve per rung
(``studies.common.no_adv_batch``); the study tracks the mu_eff estimators
and key fluxes, estimates convergence orders and Richardson-extrapolated
limits, and writes ``mesh_convergence_results.csv`` and
``study_metadata.json`` with the JAX package's rows, order and keys.  With
``realisation_check`` it also solves on a second, independently generated
mesh at h * 1.005 of the finest rung: the mesh-realisation floor no
comparison with meshes of another mesher can beat.  Where matplotlib
imports, ``convergence_mu_eff`` (.png and .pdf) plots each mu factor's
|mu_eff^sim(h) - mu_eff^sim(h_min)| against h.

    python -m fenics_eff_uptake_tpu_torch.studies.mesh_convergence \\
        [--coarse] [--base-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..plotting.style import safe_plot
from .common import (create_study_dirs, make_no_adv_params, no_adv_batch,
                     plot_or_skip, save_csv, save_metadata)

__all__ = ["run_mesh_convergence", "richardson", "DEFAULT_LADDER",
           "COARSE_LADDER", "BASE_DIR"]

BASE_DIR = "Results/Mesh Convergence"
DEFAULT_LADDER = [0.08, 0.057, 0.04, 0.028, 0.02]
COARSE_LADDER = [0.16, 0.11, 0.08]


def richardson(h, q):
    """Estimated order and extrapolated limit from the last 3 ladder
    points.

    Assumes q(h) ~ q0 + C h^p on a (roughly) geometric ladder
    h1 > h2 > h3: then r = (q2-q1)/(q3-q2) = ((h1^p - h2^p)/(h2^p - h3^p)),
    which for h1/h2 = h2/h3 = s reduces to r = s^p, giving
    p = log r / log s and q0 = q3 + (q3 - q2)/(r - 1).
    Returns (None, q_finest) when the differences are not monotone."""
    h = np.asarray(h, dtype=float)
    q = np.asarray(q, dtype=float)
    if len(q) < 3:
        return None, (float(q[-1]) if len(q) else None)
    h1, h2, h3 = h[-3:]
    q1, q2, q3 = q[-3:]
    d12, d23 = q2 - q1, q3 - q2
    if d23 == 0 or d12 / d23 <= 0 or d12 / d23 == 1.0:
        return None, float(q3)
    r = d12 / d23
    s = np.sqrt((h1 / h3))          # effective geometric step ratio
    p_est = float(np.log(r) / np.log(s))
    q0 = float(q3 + d23 / (r - 1.0))
    return p_est, q0


def _row(h, mf, res):
    me = res["mu_eff_comparison"]
    info = res["mesh_results"]["mesh_info"]
    pf = res["flux_metrics"]["sulcus_specific"]["physical_flux"]
    return {
        "mesh_size": h, "mu_factor": mf,
        "num_cells": info["num_cells"],
        "num_vertices": info["num_vertices"],
        "hmin": info["hmin"], "hmax": info["hmax"],
        "mu_eff_sim": me["mu_eff_sim"], "mu_eff_open": me["mu_eff_open"],
        "mu_eff_arc": me["mu_eff_arc"], "mu_eff_enh": me["mu_eff_enh"],
        "ratio_sim": me["ratios"]["sim"],
        "y0_flux": pf["y0_flux"]["total"],
        "total_mass": res["mass_metrics"]["total_mass"],
    }


def run_mesh_convergence(device, mu_factors=(0.1, 1.0, 10.0), ladder=None,
                         sulci_w_dim=0.5, sulci_h_dim=1.0, base_dir=BASE_DIR,
                         verbose=True, realisation_check=False):
    """The refinement ladder (default ``DEFAULT_LADDER``) on ``device``.

    Returns (rows as written, sorted by mu factor then h; the metadata
    dict; one ``no_adv_batch`` stats dict per rung, the realisation mesh's
    last)."""
    print("=" * 60 + "\nMESH CONVERGENCE (refinement ladder)\n" + "=" * 60)
    t0 = time.time()
    ladder = list(DEFAULT_LADDER if ladder is None else ladder)
    mu_factors = list(mu_factors)
    study_dir, _ = create_study_dirs("Mesh Convergence", base_dir)

    def rung(h):
        geom = make_no_adv_params(1.0, sulci_w_dim=sulci_w_dim,
                                  sulci_h_dim=sulci_h_dim, mesh_size_dim=h)
        results, st = no_adv_batch(geom, mu_factors, "sulcus", device,
                                   verbose=verbose)
        stats.append(dict(st, mesh_size=h))
        return [_row(h, mf, res) for mf, res in zip(mu_factors, results)]

    stats = []
    rows = []
    for h in ladder:
        rows += rung(h)
        if verbose:
            for r in rows[-len(mu_factors):]:
                print(f"  h={h} mu*={r['mu_factor']}: "
                      f"mu_eff_sim={r['mu_eff_sim']:.8f}")
    rows = save_csv(rows, os.path.join(study_dir,
                                       "mesh_convergence_results.csv"),
                    sort_by=["mu_factor", "mesh_size"])

    conv = {}
    for mf in mu_factors:
        sub = sorted((r for r in rows if r["mu_factor"] == mf),
                     key=lambda r: -r["mesh_size"])
        p_est, q0 = richardson([r["mesh_size"] for r in sub],
                               [r["mu_eff_sim"] for r in sub])
        conv[str(mf)] = {"order_estimate": p_est,
                         "mu_eff_sim_extrapolated": q0}
        if verbose:
            print(f"  mu*={mf}: order~{p_est}, extrapolated mu_eff_sim={q0}")
    floor = None
    if realisation_check:
        h_f = ladder[-1]
        floor = {}
        for b in rung(h_f * 1.005):
            a = next((r for r in rows if r["mu_factor"] == b["mu_factor"]
                      and r["mesh_size"] == h_f), None)
            if a is None:
                continue
            floor[str(b["mu_factor"])] = {
                f"{k}_rel": abs(b[k] - a[k]) / abs(a[k])
                for k in ("mu_eff_sim", "y0_flux", "total_mass")}
            if verbose:
                print(f"  realisation floor mu*={b['mu_factor']}: "
                      f"{floor[str(b['mu_factor'])]}")

    meta = {
        "study_type": "Mesh Convergence",
        "ladder": ladder,
        "mu_factors": mu_factors,
        "geometry_mm": [sulci_w_dim, sulci_h_dim],
        "convergence": conv,
        "mesh_realisation_floor": floor,
        "elapsed_s": time.time() - t0,
    }
    save_metadata(meta, os.path.join(study_dir, "study_metadata.json"))
    plot_or_skip("mesh-convergence plot", _plot_convergence, rows,
                 mu_factors, os.path.join(study_dir, "convergence_mu_eff"))
    print(f"Mesh convergence done in {time.time() - t0:.1f}s")
    return rows, meta, stats


def _plot_convergence(rows, mu_factors, path_base):
    with safe_plot(path_base) as (fig, ax):
        for mf in mu_factors:
            sub = sorted((r for r in rows if r["mu_factor"] == mf),
                         key=lambda r: r["mesh_size"])
            q = np.array([r["mu_eff_sim"] for r in sub], dtype=float)
            ax.loglog([r["mesh_size"] for r in sub],
                      np.abs(q - q[0]) + 1e-16, "o-", label=f"mu*={mf}")
        ax.set_xlabel("mesh size h")
        ax.set_ylabel(r"|mu_eff^sim(h) - mu_eff^sim(h_min)|")
        ax.legend()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Mesh-convergence ladder on PyTorch")
    ap.add_argument("--coarse", action="store_true",
                    help=f"coarser, faster ladder {COARSE_LADDER}")
    ap.add_argument("--base-dir", default=BASE_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    run_mesh_convergence(args.device,
                         ladder=COARSE_LADDER if args.coarse else None,
                         base_dir=args.base_dir)


if __name__ == "__main__":
    main()
