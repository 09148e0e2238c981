"""Phase-B study: no-advection sulcus against its rectangular surrogate
(counterpart of ``studies/phase_b.py`` ``run_no_adv_mu_sweep``).

For each geometry and each mu factor of {0.1, 0.5, 1.0}, the sulcus and the
rectangle run with identical parameters (per geometry and domain the mu
values are ONE batched CG solve) and are compared by

  CR             = avg_conc_sulcus / avg_conc_rect
  flux_ratio     = flux_rect_bottom / flux_sulc_y0
  flux_error_pct = 100 (flux_rect - flux_sulc) / |flux_sulc|

Writes ``no_adv_mu_sweep_results.csv`` with the JAX package's columns,
sorted by mu factor and geometry, ``study_metadata.json`` and, where
matplotlib imports, the heatmaps of CR, flux ratio and flux error per mu
factor into ``Plots/`` (``plotting.phase_b_plots``).  No pandas.

    python -m fenics_eff_uptake_tpu_torch.studies.phase_b [run | replot] \\
        [--geometries reference,square_medium] [--mesh-size 0.02] \\
        [--output-base DIR] [--device cuda] [--shard N --tp T]

``replot`` (``replot_from_csv``) draws the heatmaps again from the CSV
under ``--output-base``.

``--shard N`` solves every batch sharded over N ranks (``--tp`` cells
ranks per sweep row; ``studies.common``), started once for the run; the
CSV and the metadata are written here, by the parent, alone.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..params import Parameters, create_geometry_variations
from ..plotting.phase_b_plots import create_heatmaps
from ..plotting.table import Table
from .common import (add_shard_arguments, create_study_dirs,
                     make_no_adv_params, no_adv_batch, plot_or_skip,
                     save_csv, save_metadata, shard_group)

__all__ = ["run_no_adv_mu_sweep", "replot_from_csv", "MU_FACTORS",
           "OUTPUT_BASE", "CSV_NAME"]

MU_FACTORS = [0.1, 0.5, 1.0]
OUTPUT_BASE = "Results/No Advection Simulations/mu Sweep"
CSV_NAME = "no_adv_mu_sweep_results.csv"


def _flux_sulc(res):
    """Total flux through y = 0 of a sulcus run."""
    pf = (res["flux_metrics"].get("sulcus_specific", {})
          .get("physical_flux", {}))
    for key in ("y0_flux", "y0_combined"):
        if key in pf:
            return pf[key].get("total", np.nan)
    return np.nan


def _flux_rect(res):
    """Total flux through the bottom wall of a rectangle run."""
    return (res["flux_metrics"].get("physical_flux", {})
            .get("bottom", {}).get("total", np.nan))


def run_no_adv_mu_sweep(device, output_base=OUTPUT_BASE, mesh_size_dim=0.02,
                        mu_factors=None, geometries=None, verbose=True,
                        shard=None):
    """The sulcus-against-rectangle sweep on ``device`` over the named
    geometries of ``create_geometry_variations`` (default: all 23);
    ``shard``: a started ``RankGroup`` solves every batch sharded.
    Returns (rows, stats) with one stats dict per geometry and domain."""
    mu_factors = list(MU_FACTORS if mu_factors is None else mu_factors)
    print("=" * 64 + "\nNO ADVECTION -- mu SWEEP OVER GEOMETRIES\n" + "=" * 64)
    t0 = time.time()
    study_dir, _ = create_study_dirs("mu Sweep", output_base)
    configs = create_geometry_variations(Parameters(mode="no-adv"),
                                         max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}
    print(f"Geometries: {len(configs)}, mu factors: {mu_factors}")

    rows, stats = [], []
    for gkey, gcfg in configs.items():
        geom = make_no_adv_params(
            1.0, sulci_w_dim=gcfg["sulci_w_dim"],
            sulci_h_dim=gcfg["sulci_h_dim"], mesh_size_dim=mesh_size_dim)
        sulc, st_s = no_adv_batch(geom, mu_factors, "sulcus", device,
                                  verbose=verbose, shard=shard)
        rect, st_r = no_adv_batch(geom, mu_factors, "rectangular", device,
                                  verbose=verbose, shard=shard)
        stats += [dict(st_s, geometry=gkey, domain="sulcus"),
                  dict(st_r, geometry=gkey, domain="rectangular")]
        for mu, rs, rr in zip(mu_factors, sulc, rect):
            conc_s = rs["mass_metrics"]["average_concentration"]["total"]
            conc_r = rr["mass_metrics"]["average_concentration"]
            flux_s = _flux_sulc(rs)
            flux_r = _flux_rect(rr)
            CR = (conc_s / conc_r
                  if conc_s is not None and conc_r not in (None, 0)
                  else np.nan)
            if (flux_s is None or not np.isfinite(flux_s)
                    or np.isclose(flux_s, 0.0)):
                flux_ratio = flux_err = np.nan
            else:
                flux_ratio = flux_r / flux_s
                flux_err = 100.0 * (flux_r - flux_s) / abs(flux_s)
            rows.append({
                "geometry": gkey,
                "width_mm": gcfg["sulci_w_dim"],
                "depth_mm": gcfg["sulci_h_dim"],
                "aspect_ratio": gcfg.get("aspect_ratio"),
                "mu_factor": mu,
                "avg_conc_sulc": conc_s,
                "avg_conc_rect": conc_r,
                "flux_sulc_y0": flux_s,
                "flux_rect_bottom": flux_r,
                "CR": CR,
                "flux_ratio": flux_ratio,
                "flux_error_pct": flux_err,
            })
            if verbose:
                print(f"  {gkey} mu*={mu}: CR={CR:.4f} "
                      f"flux_ratio={flux_ratio:.4f}")

    rows = save_csv(rows, os.path.join(study_dir, CSV_NAME),
                    sort_by=["mu_factor", "geometry"])
    p0 = Parameters(mode="no-adv")
    p0.validate()
    p0.nondim()
    save_metadata({
        "study_type": "No Advection -- mu Sweep",
        "mu_factors": mu_factors,
        "baselines": {
            "MU_DIM_NO_ADV": Parameters.MU_DIM_NO_ADV,
            "D_dim": p0.D_dim, "H_dim": p0.H_dim, "L_dim": p0.L_dim,
        },
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Phase B sweep done in {time.time() - t0:.1f}s")
    plot_or_skip("Phase-B heatmaps", create_heatmaps, rows,
                 os.path.join(study_dir, "Plots"))
    return rows, stats


def replot_from_csv(output_base=OUTPUT_BASE):
    """The heatmaps again from the saved CSV (ref :351-391), the flux
    error computed where the CSV lacks it; needs matplotlib.  Returns the
    CSV's Table, or None where there is no CSV."""
    study_dir = os.path.join(output_base, "mu Sweep Analysis")
    csv_path = os.path.join(study_dir, CSV_NAME)
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    t = Table.read_csv(csv_path)
    if "flux_error_pct" not in t and \
            {"flux_rect_bottom", "flux_sulc_y0"} <= set(t.columns):
        denom = np.abs(t["flux_sulc_y0"])
        denom = np.where(denom == 0.0, 1.0, denom)
        t["flux_error_pct"] = 100.0 * (
            t["flux_rect_bottom"] - t["flux_sulc_y0"]) / denom
    create_heatmaps(t, os.path.join(study_dir, "Plots"))
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Phase-B sulcus-against-rectangle mu sweep on PyTorch")
    ap.add_argument("command", choices=["run", "replot"], nargs="?",
                    default="run")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--output-base", default=OUTPUT_BASE)
    ap.add_argument("--geometries", default=None,
                    help="comma-separated geometry keys (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    add_shard_arguments(ap)
    args = ap.parse_args(argv)
    if args.command == "replot":
        replot_from_csv(args.output_base)
        return
    with shard_group(args) as group:
        run_no_adv_mu_sweep(
            args.device, args.output_base, args.mesh_size,
            geometries=(args.geometries.split(",") if args.geometries
                        else None), shard=group)


if __name__ == "__main__":
    main()
