"""Adv-diff step-mu(x) validation (counterpart of ``studies/adv_diff.py``
``run_advdiff_step_validation``).

The Pe x mu grid {0.1, 1, 10} x {0.1, 1, 10} on the reference geometry
(w = 0.5, d = 1.0 mm): per cell (1) a sulcus reference run giving
mu_eff^open and (2) a rectangular surrogate with the smoothed step
mu(x) = mu_base -> mu_eff^open over the mouth footprint.  Per domain ONE
Stokes solve (the nondimensional velocity is Pe-independent); the sulcus
columns are ONE batched BiCGStab with mu per column, the surrogates a
second one whose Robin term is a per-column batch of facet matrices.
Writes ``advdiff_validation_step_pe_x_mu.csv`` with the JAX package's
columns in its order (sorted by Pe, mu_factor, domain_type) and
``study_metadata.json`` into ``Results Data/`` and, where matplotlib
imports, the validation heatmaps and the mu(x) grid into
``Analysis Plots/`` (``plotting.adv_diff_plots``).  No pandas.

    python -m fenics_eff_uptake_tpu_torch.studies.adv_diff [run | replot] \\
        [--mesh-size 0.02] [--output-base DIR] [--device cuda] \\
        [--shard N --tp T]

``replot`` (``replot_from_csv``) draws the figures again from the CSV
under ``--output-base``.

``--shard N`` runs every solve (both Stokes saddles, the sulcus batch and
the step-mu surrogates) sharded over N ranks, started once for the run
(``studies.common``); the files are written here, by the parent, alone.
"""

from __future__ import annotations

import argparse
import os
import time

from ..analysis.batched_metrics import build_sweep_metrics, metrics_to_dicts
from ..params import Parameters, StepUptakeOpen
from ..plotting.adv_diff_plots import create_validation_plots
from ..plotting.table import Table
from .common import (_sync, add_shard_arguments, make_mesh, plot_or_skip,
                     save_csv, save_metadata, shard_group, stokes_for_study,
                     transport_batch)

__all__ = ["run_advdiff_step_validation", "create_base_parameters",
           "replot_from_csv",
           "PE_VALUES", "MU_FACTORS", "REFERENCE_GEOMETRY", "OUTPUT_BASE",
           "CSV_NAME"]

PE_VALUES = [0.1, 1.0, 10]
MU_FACTORS = [0.1, 1.0, 10]
REFERENCE_GEOMETRY = {
    "L_dim": 10.0, "H_dim": 1.0,
    "sulci_w_dim": 0.5, "sulci_h_dim": 1.0,
    "mesh_size_dim": 0.02, "refinement_factor": 1,
}
D_DIM = 0.0003
MU_DIM_BASE = 0.0003
STEP_GAMMA = 5.0
OUTPUT_BASE = "Results/AdvDiff Validation (Pe x mu) - Step Only"
CSV_NAME = "advdiff_validation_step_pe_x_mu.csv"


def create_base_parameters(Pe_target, mu_factor, mesh_size_dim=None):
    """Parameters for a target Pe and mu factor."""
    geo = dict(REFERENCE_GEOMETRY)
    if mesh_size_dim is not None:
        geo["mesh_size_dim"] = mesh_size_dim
    params = Parameters(mode="adv-diff",
                        U_ref_dim=Pe_target * D_DIM / geo["H_dim"],
                        D_dim=D_DIM, **geo)
    params.mu_dim = MU_DIM_BASE * float(mu_factor)
    params.validate()
    params.nondim()
    return params


def _flux_row(flux_metrics, domain_type):
    """Signed flux components: through y = 0 for the sulcus, through the
    bottom wall for the rectangle."""
    if domain_type == "sulcus":
        part = (flux_metrics.get("sulcus_specific", {})
                .get("physical_flux", {}).get("y0_flux", {}))
    else:
        part = flux_metrics.get("physical_flux", {}).get("bottom", {})
    return {"total_flux": part.get("total"),
            "diffusive_flux": part.get("diffusive"),
            "advective_flux": part.get("advective"),
            "uptake_flux": flux_metrics.get("uptake_flux")}


def _domain_stats(domain, mesh, sys, si, ts, info, seconds):
    return {
        "domain": domain, "cells": int(mesh.num_cells),
        "ndofs": int(sys.space.ndofs),
        "stokes_setup_s": si["setup_s"], "stokes_solve_s": si["solve_s"],
        "assembly_s": ts["assembly_s"], "ml_setup_s": ts["ml_setup_s"],
        "solve_s": ts["solve_s"], **seconds,
        "minres_iters": si["outer_iters"], "minres_passes": si["passes"],
        "stokes_rel_resnorm": si["rel_resnorm"],
        "iters": info["iters"].tolist(), "passes": info.get("passes"),
        "rel_resnorm": info["true_rel_resnorm"].tolist(),
        "multilevel": ts["multilevel"],
    }


def run_advdiff_step_validation(output_base_dir=OUTPUT_BASE,
                                mesh_size_dim=None, pe_values=None,
                                mu_factors=None, device="cuda", rtol=1e-12,
                                verbose=True, solver_options=None,
                                stokes_options=None, shard=None):
    """The Pe x mu validation on ``device``; ``solver_options``,
    ``stokes_options`` and ``shard`` as in
    ``studies.no_uptake.run_geometry_study``.
    Returns (rows, stats): the
    CSV rows, and one stats dict per domain (stage seconds, each stage
    ending in a device sync; iterations, passes, relative residuals)."""
    pe_values = list(pe_values or PE_VALUES)
    mu_factors = list(mu_factors or MU_FACTORS)
    print("=" * 64 + "\nADVECTION-DIFFUSION VALIDATION (Step mu only)\n"
          + "=" * 64)
    t0 = time.time()
    results_dir = os.path.join(output_base_dir, "Results Data")
    os.makedirs(results_dir, exist_ok=True)
    cells = [(Pe, mf) for Pe in pe_values for mf in mu_factors]
    D_batch = [1.0 / Pe for Pe, _ in cells]
    mu_batch = [float(mf) for _, mf in cells]
    p0 = create_base_parameters(pe_values[0], 1.0, mesh_size_dim)

    # sulcus reference: one mesh, one Stokes solve, one batched solve
    t1 = time.time()
    sulc_mesh = make_mesh(p0, "sulcus")
    t_mesh = time.time()
    stokes_options = stokes_options or {}
    u_s, _ = stokes_for_study(sulc_mesh, p0.H, device, shard=shard,
                              **stokes_options)
    if verbose:
        print(f"[sulcus] Stokes: {time.time() - t_mesh:.1f}s "
              f"{u_s.solver_info}")
    Xs, info_s, sys_s, ts_s = transport_batch(sulc_mesh, u_s, D_batch,
                                              mu_batch, device, rtol=rtol,
                                              solver_options=solver_options,
                                              shard=shard)
    t_solve = time.time()
    if verbose:
        print(f"[sulcus] {len(cells)} transport solves in "
              f"{ts_s['solve_s']:.1f}s (iters={info_s['iters'].tolist()})")
    params_s = [create_base_parameters(Pe, mf, mesh_size_dim)
                for Pe, mf in cells]
    sm_s = build_sweep_metrics(sys_s.space, sulc_mesh, 1.0, Xs.device, u=u_s)
    flux_s, mass_s, mueff_s = metrics_to_dicts(
        sm_s, sulc_mesh, Xs, mu_batch, params_s, D_values=D_batch)
    t_end = _sync(Xs.device)
    stats = [_domain_stats("sulcus", sulc_mesh, sys_s, u_s.solver_info, ts_s,
                           info_s, {"mesh_s": t_mesh - t1,
                                    "metrics_s": t_end - t_solve,
                                    "total_s": t_end - t1})]

    rows = []
    for (Pe, mf), params, fm, mm, me in zip(cells, params_s, flux_s, mass_s,
                                            mueff_s):
        rows.append({
            "Pe": float(Pe), "mu_factor": float(mf),
            "domain_type": "sulcus", "surrogate_type": "reference",
            **_flux_row(fm, "sulcus"),
            "mu_eff_arc": me.get("mu_eff_arc"),
            "mu_eff_sim": me.get("mu_eff_sim"),
            "mu_eff_open": me.get("mu_eff_open"),
            "avg_conc": mm["average_concentration"]["total"],
            "CR": None,
            "Mu_base_nondim": params.mu,
            "Domain_Length_mm": params.L_dim,
            "Sulcus_Width_mm": params.sulci_w_dim,
        })
        if verbose:
            print(f"  sulcus Pe={Pe} mu={mf}: mu_eff_open="
                  f"{me.get('mu_eff_open'):.6f}")

    # rectangular surrogates: the step mu(x) of each cell as a per-column
    # batch of Robin matrices
    t1 = time.time()
    rect_mesh = make_mesh(p0, "rectangular")
    t_mesh = time.time()
    u_r, _ = stokes_for_study(rect_mesh, p0.H, device, shard=shard,
                              **stokes_options)
    if verbose:
        print(f"[rect] Stokes: {time.time() - t_mesh:.1f}s "
              f"{u_r.solver_info}")
    steps = []
    for params, me, mf in zip(params_s, mueff_s, mu_batch):
        steps.append(StepUptakeOpen(
            mu_base=mf, mu_eff_target=float(me["mu_eff_open"]),
            sulcus_left_x=params.L / 2 - params.sulci_w / 2,
            sulcus_right_x=params.L / 2 + params.sulci_w / 2,
            L_c=0.1 * params.sulci_w, Gamma=STEP_GAMMA))
    Xr, info_r, sys_r, ts_r = transport_batch(rect_mesh, u_r, D_batch, None,
                                              device, rtol=rtol, steps=steps,
                                              solver_options=solver_options,
                                              shard=shard)
    t_solve = time.time()
    if verbose:
        print(f"[rect] {len(cells)} surrogate solves in "
              f"{ts_r['solve_s']:.1f}s (iters={info_r['iters'].tolist()})")
    sm_r = build_sweep_metrics(sys_r.space, rect_mesh, 1.0, Xr.device,
                               u=u_r, mu_profiles=steps)
    flux_r, mass_r, _ = metrics_to_dicts(
        sm_r, rect_mesh, Xr, [0.0] * len(cells), params_s, D_values=D_batch)
    t_end = _sync(Xr.device)
    stats.append(_domain_stats("rectangular", rect_mesh, sys_r,
                               u_r.solver_info, ts_r, info_r,
                               {"mesh_s": t_mesh - t1,
                                "metrics_s": t_end - t_solve,
                                "total_s": t_end - t1}))

    for (Pe, mf), fm, mm, me, mm_s in zip(cells, flux_r, mass_r, mueff_s,
                                          mass_s):
        avg_s = mm_s["average_concentration"]["total"]
        avg_r = mm["average_concentration"]
        rows.append({
            "Pe": float(Pe), "mu_factor": float(mf),
            "domain_type": "rectangular", "surrogate_type": "step_open",
            **_flux_row(fm, "rectangular"),
            "mu_eff_arc": me.get("mu_eff_arc"),
            "mu_eff_sim": me.get("mu_eff_sim"),
            "mu_eff_open": me.get("mu_eff_open"),
            "avg_conc": avg_r,
            "CR": (avg_s / avg_r
                   if avg_s is not None and avg_r not in (None, 0.0)
                   else None),
        })

    ref_flux = {(r["Pe"], r["mu_factor"]): r["total_flux"] for r in rows
                if r["domain_type"] == "sulcus"}
    for r in rows:
        r["flux_error_pct"] = r["flux_ratio"] = None   # the columns' order
        ref = ref_flux.get((r["Pe"], r["mu_factor"]))
        if r["domain_type"] != "rectangular" or ref is None:
            continue
        r["flux_ratio"] = r["total_flux"] / (ref if ref != 0 else 1.0)
        r["flux_error_pct"] = 100.0 * (r["total_flux"] - ref) / (
            abs(ref) if ref != 0 else 1.0)

    rows = save_csv(rows, os.path.join(results_dir, CSV_NAME),
                    sort_by=["Pe", "mu_factor", "domain_type"])
    save_metadata({
        "study_type": "AdvDiff Validation (Pe x mu) - Step mu only",
        "Pe_values": pe_values, "mu_factors": mu_factors,
        "reference_geometry": REFERENCE_GEOMETRY,
        "parameters": {"D_dim": D_DIM, "mu_dim_base": MU_DIM_BASE},
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(results_dir, "study_metadata.json"))
    plot_or_skip("adv-diff validation plots", create_validation_plots, rows,
                 os.path.join(output_base_dir, "Analysis Plots"))
    print(f"Adv-diff validation done in {time.time() - t0:.1f}s")
    return rows, stats


def replot_from_csv(output_base_dir=OUTPUT_BASE):
    """The figures again from the saved CSV; needs matplotlib.  Returns
    the CSV's Table, or None where there is no CSV."""
    csv_path = os.path.join(output_base_dir, "Results Data", CSV_NAME)
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    t = Table.read_csv(csv_path)
    create_validation_plots(t, os.path.join(output_base_dir,
                                            "Analysis Plots"))
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Adv-diff step-mu validation on PyTorch")
    ap.add_argument("command", choices=["run", "replot"], nargs="?",
                    default="run")
    ap.add_argument("--mesh-size", type=float, default=None)
    ap.add_argument("--output-base", default=OUTPUT_BASE)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    add_shard_arguments(ap)
    args = ap.parse_args(argv)
    if args.command == "replot":
        replot_from_csv(args.output_base)
        return
    with shard_group(args) as group:
        run_advdiff_step_validation(args.output_base,
                                    mesh_size_dim=args.mesh_size,
                                    device=args.device, shard=group)


if __name__ == "__main__":
    main()
