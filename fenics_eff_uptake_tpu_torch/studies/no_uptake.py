"""No-uptake flow study: geometry x Peclet sweep and rectangular baselines
(counterpart of ``studies/no_uptake.py`` ``run_geometry_study``).

Per mesh ONE Stokes solve feeds every Pe (the nondimensional velocity is
Pe-independent), and the Pe transport solves (mu = 0, D* = 1/Pe per column)
are ONE batched BiCGStab.  Writes ``geometry_comparison_results.csv`` with
the JAX package's columns in its order (sulcus rows, rectangle rows, then
the ratio columns joined against the rectangle of the same Pe),
``study_metadata.json`` and, for the geometries of ``PROFILE_GEOMETRIES``,
the line profiles of every Pe with the rectangle's overlaid:
``Profiles/profiles_samples_<geometry>.csv`` (one row per sample point) and
``Profiles/profiles_<geometry>.csv`` (min, max and mean per line), with the
JAX package's names, columns and row order.  No pandas: the grouping and
the ratio join are plain Python.  Where matplotlib imports, the figures
follow (``plotting.no_uptake_plots``): a profile grid per
``Profiles/profiles_samples_*.csv`` into ``Profiles/Grids/``, and the
exchange and velocity-ratio heatmaps into ``Plots/``.

    python -m fenics_eff_uptake_tpu_torch.studies.no_uptake \\
        [run | baselines | replot] \\
        [--geometries reference,square_small] [--peclet 0.1,1,10] \\
        [--mesh-size 0.02] [--base-dir DIR] [--device cuda] \\
        [--shard N --tp T]

``baselines`` runs the rectangle alone and writes nothing; ``replot``
(``replot_from_csv``) draws the heatmaps again from the CSV under
``--base-dir``.

``--shard N`` runs every solve (the Stokes saddle and the Pe batches)
sharded over N ranks, started once for the run (``studies.common``); the
files are written here, by the parent, alone.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..analysis.batched_metrics import build_sweep_metrics, metrics_to_dicts
from ..analysis.profiles import compute_conc_profiles, compute_velocity_metrics
from ..fem.space import Function
from ..params import Parameters, create_geometry_variations
from ..plotting.no_uptake_plots import (generate_all_plots,
                                        plot_profiles_grid_from_samples_csv)
from ..plotting.table import Table
from .common import (_sync, add_shard_arguments, create_study_dirs,
                     make_mesh, plot_or_skip, save_csv, save_metadata,
                     shard_group, stokes_for_study, transport_batch)

__all__ = ["run_geometry_study", "run_rectangular_baselines",
           "add_ratio_metrics", "collect_profile_rows",
           "export_profile_samples_csv_sulci", "export_profile_stats_csv",
           "replot_from_csv", "PECLET_NUMBERS", "PROFILE_GEOMETRIES",
           "RATIO_COLUMNS",
           "BASE_DIR"]

PECLET_NUMBERS = [0.1, 1.0, 10.0]
PROFILE_GEOMETRIES = ["largest", "square_small"]
BASE_DIR = "Results/No Uptake Simulations"
RATIO_COLUMNS = ["Concentration_Ratio", "Channel_Conc_Ratio",
                 "Intradomain_Enrichment", "VR_mid_avg", "VR_mid_max",
                 "VR_intradomain_avg", "VR_intradomain_max"]


def _make_params(pe, w=None, h=None, mesh_size_dim=None) -> Parameters:
    """No-uptake Parameters with U_ref_dim = Pe * D / H."""
    p = Parameters(mode="no-uptake")
    p.mu_dim = 0.0
    if w is not None:
        p.sulci_w_dim = w
    if h is not None:
        p.sulci_h_dim = h
    if mesh_size_dim is not None:
        p.mesh_size_dim = mesh_size_dim
    p.U_ref_dim = pe * p.D_dim / p.H_dim
    p.validate()
    p.nondim()
    return p


def _sulcus_row(params, mm, fm, vm):
    """CSV row of a sulcus run."""
    w, h = params.sulci_w_dim, params.sulci_h_dim
    D_dim = params.U_ref_dim * params.H_dim / params.Pe
    pf = fm.get("physical_flux", {})
    pfs = fm.get("sulcus_specific", {}).get("physical_flux", {})
    mouth = pfs.get("sulcus_opening", {})
    extra = pfs.get("sulcus_opening_extra", {})
    avg = mm["average_concentration"]
    return {
        "Domain": "sulcus", "Mode": params.mode, "Peclet": params.Pe,
        "U_ref": params.U_ref,
        "Sulcus Width (mm)": w, "Sulcus Depth (mm)": h,
        "Aspect_Ratio": h / w if w and w > 0 else None,
        "U_ref (Dim)": params.U_ref_dim, "Diff Coef (Dim)": D_dim,
        "Delta (mm)": D_dim / params.U_ref_dim,
        "Total Mass": mm.get("total_mass"),
        "Sulcus Mass": mm.get("sulcus_mass"),
        "Main Channel Mass": mm.get("rectangle_mass"),
        "Avg Concentration": avg.get("total"),
        "Sulcus Avg Concentration": avg.get("sulcus_region"),
        "Main Channel Avg Concentration": avg.get("rectangle_region"),
        "Mouth_Flux_Total": mouth.get("total"),
        "Inlet-Outlet Flux": (pf.get("left", {}).get("total", 0)
                              + pf.get("right", {}).get("total", 0)),
        "Mouth E_L1": extra.get("E_L1"),
        "Mouth E_avg": extra.get("E_avg"),
        "Mouth Q_in": extra.get("Q_in"),
        "Mouth Q_out": extra.get("Q_out"),
        "Mouth Net Check": extra.get("net_check"),
        "Mouth Length": extra.get("length"),
        "Max_Ux_mid_channel": vm.get("max_ux_mid_channel"),
        "Avg_Ux_mid_channel": vm.get("avg_ux_mid_channel"),
        "Max_Ux_sulcus_level": vm.get("max_ux_mouth_level"),
        "Avg_Ux_sulcus_level": vm.get("avg_ux_mouth_level"),
    }


def _rect_row(params, mm, fm, vm):
    """CSV row of a rectangular baseline run."""
    D_dim = params.U_ref_dim * params.H_dim / params.Pe
    pf = fm.get("physical_flux", {})
    return {
        "Domain": "rectangle", "Mode": params.mode, "Peclet": params.Pe,
        "U_ref": params.U_ref,
        "Sulcus Width (mm)": None, "Sulcus Depth (mm)": None,
        "Aspect_Ratio": None,
        "U_ref (Dim)": params.U_ref_dim, "Diff Coef (Dim)": D_dim,
        "Delta (mm)": D_dim / params.U_ref_dim,
        "Total Mass": mm.get("total_mass"), "Sulcus Mass": None,
        "Main Channel Mass": mm.get("total_mass"),
        "Avg Concentration": mm.get("average_concentration"),
        "Sulcus Avg Concentration": None,
        "Main Channel Avg Concentration": mm.get("average_concentration"),
        "Mouth_Flux_Total": None,
        "Inlet-Outlet Flux": (pf.get("left", {}).get("total", 0)
                              + pf.get("right", {}).get("total", 0)),
        "Mouth E_L1": None, "Mouth E_avg": None, "Mouth Q_in": None,
        "Mouth Q_out": None, "Mouth Net Check": None, "Mouth Length": None,
        "Max_Ux_mid_channel": vm.get("max_ux_mid_channel"),
        "Avg_Ux_mid_channel": vm.get("avg_ux_mid_channel"),
        "Max_Ux_sulcus_level": None, "Avg_Ux_sulcus_level": None,
    }


def _domain_runs(params_list, domain_type, device, verbose,
                 solver_options=None, stokes_options=None,
                 profile_key=None, shard=None):
    """Stokes + batched transport + metrics on one domain for all Pe of
    ``params_list`` (one geometry).  With ``profile_key``, also the line
    profiles of every Pe column, labelled with that key
    (``collect_profile_rows``).  Returns (rows, stats, profile rows, one
    list per Pe; None without ``profile_key``)."""
    t0 = time.time()
    p0 = params_list[0]
    mesh = make_mesh(p0, domain_type)
    t_mesh = time.time()
    u, _ = stokes_for_study(mesh, p0.H, device, shard=shard,
                            **(stokes_options or {}))
    si = u.solver_info
    t_stokes = time.time()
    D_batch = [1.0 / p.Pe for p in params_list]
    X, info, sys, ts = transport_batch(mesh, u, D_batch,
                                       [0.0] * len(D_batch), device,
                                       solver_options=solver_options,
                                       shard=shard)
    t_solve = time.time()
    sm = build_sweep_metrics(sys.space, mesh, 1.0, X.device, u=u)
    flux_list, mass_list, _ = metrics_to_dicts(
        sm, mesh, X, [0.0] * len(D_batch), params_list, D_values=D_batch)
    vm = compute_velocity_metrics(u, mesh, p0)
    make_row = _sulcus_row if domain_type == "sulcus" else _rect_row
    rows = [make_row(p, mm, fm, vm)
            for p, mm, fm in zip(params_list, mass_list, flux_list)]
    t_end = _sync(X.device)
    profiles = None
    if profile_key is not None:
        Xh = X.cpu().numpy()
        profiles = [collect_profile_rows(
            Function(sys.space, Xh[i]), mesh, p, profile_key, profile_key,
            domain_type=domain_type) for i, p in enumerate(params_list)]
    t_prof = time.time()
    stats = {
        "domain": domain_type, "cells": int(mesh.num_cells),
        "ndofs": int(sys.space.ndofs), "mesh_s": t_mesh - t0,
        "stokes_setup_s": si["setup_s"], "stokes_solve_s": si["solve_s"],
        "stokes_s": t_stokes - t_mesh, "assembly_s": ts["assembly_s"],
        "ml_setup_s": ts["ml_setup_s"], "solve_s": ts["solve_s"],
        "metrics_s": t_end - t_solve, "profiles_s": t_prof - t_end,
        "total_s": t_end - t0,
        "minres_iters": si["outer_iters"], "minres_passes": si["passes"],
        "stokes_rel_resnorm": si["rel_resnorm"],
        "stokes_method": si["method"],
        "iters": info["iters"].tolist(), "passes": info.get("passes"),
        "rel_resnorm": info["true_rel_resnorm"].tolist(),
        "multilevel": ts["multilevel"],
    }
    if verbose:
        label = (f"sulcus w={p0.sulci_w_dim} h={p0.sulci_h_dim}"
                 if domain_type == "sulcus" else "rectangle")
        print(f"  [{label}] {len(D_batch)} Pe points in "
              f"{stats['total_s']:.2f}s "
              f"(MINRES {si['outer_iters']} iters / {si['passes']} passes, "
              f"BiCGStab iters={stats['iters']}, passes={info.get('passes')})")
    return rows, stats, profiles


def run_rectangular_baselines(peclet_numbers=None, mesh_size_dim=None,
                              device="cuda", verbose=True,
                              solver_options=None, stokes_options=None,
                              collect_profiles=False, shard=None):
    """The rectangle's rows for every Pe: one Stokes solve, one batched
    transport solve (sharded over ``shard``, a started ``RankGroup``,
    when given).  Returns (rows, stats); with ``collect_profiles``,
    (rows, stats, the rectangle's profile rows of every Pe), the overlay
    of the profile CSVs."""
    pes = list(peclet_numbers or PECLET_NUMBERS)
    params_list = [_make_params(pe, mesh_size_dim=mesh_size_dim)
                   for pe in pes]
    rows, stats, profiles = _domain_runs(
        params_list, "rectangular", device, verbose, solver_options,
        stokes_options, "rectangle" if collect_profiles else None, shard)
    if collect_profiles:
        return rows, stats, [r for rs in profiles for r in rs]
    return rows, stats


def collect_profile_rows(c, mesh, params, geometry_key, config_name,
                         domain_type="sulcus"):
    """One row per sample point of ``compute_conc_profiles``' lines: the
    horizontal lines first, then the vertical ones, each point in order."""
    prof = compute_conc_profiles(c, mesh, params, domain_type)
    meta = prof["profiles_meta"]
    x_rng, y_rng = meta.get("x_range"), meta.get("y_range")
    rows = []
    for ltype, coord_key in (("horizontal", "x"), ("vertical", "y")):
        for name, payload in prof["profiles_full"][ltype].items():
            fixed = payload["y" if ltype == "horizontal" else "x"]
            for i, (cc, vv) in enumerate(zip(payload[coord_key],
                                             payload["c"])):
                rows.append({
                    "Domain": domain_type, "Geometry": geometry_key,
                    "Config": config_name, "Peclet": params.Pe,
                    "LineType": ltype, "LineName": name, "Index": i,
                    "x": cc if ltype == "horizontal" else fixed,
                    "y": fixed if ltype == "horizontal" else cc,
                    "c": vv, "n_points": meta.get("n_points"),
                    "x_min": None if x_rng is None else x_rng[0],
                    "x_max": None if x_rng is None else x_rng[1],
                    "y_min": None if y_rng is None else y_rng[0],
                    "y_max": None if y_rng is None else y_rng[1],
                })
    return rows


def _by_geometry(profile_runs):
    out = {}
    for run in profile_runs:
        out.setdefault(run["geometry"], []).append(run["rows"])
    return out


def export_profile_samples_csv_sulci(profile_runs, out_dir):
    """``profiles_samples_<geometry>.csv`` per geometry: the rows of its
    runs in order.  ``profile_runs``: dicts of ``geometry`` and ``rows``
    (``collect_profile_rows``)."""
    for gkey, runs in _by_geometry(profile_runs).items():
        save_csv([r for rows in runs for r in rows],
                 os.path.join(out_dir, f"profiles_samples_{gkey}.csv"))


def export_profile_stats_csv(profile_runs, out_dir):
    """``profiles_<geometry>.csv`` per geometry: per run, one row per
    (line type, line, Pe) in that sorted order, with the line's place and
    the min, max and mean of its samples."""
    for gkey, runs in _by_geometry(profile_runs).items():
        out = []
        for rows in runs:
            groups = {}
            for r in rows:
                groups.setdefault((r["LineType"], r["LineName"],
                                   r["Peclet"]), []).append(r)
            for (ltype, name, pe) in sorted(groups):
                sub = groups[ltype, name, pe]
                c = np.array([r["c"] for r in sub], dtype=np.float64)
                horiz = ltype == "horizontal"
                out.append({
                    "Geometry": gkey, "Peclet": pe, "line_type": ltype,
                    "name": name,
                    "x": None if horiz else float(sub[0]["x"]),
                    "y": float(sub[0]["y"]) if horiz else None,
                    "min_c": float(c.min()), "max_c": float(c.max()),
                    "avg_c": float(c.mean()), "n_samples": len(sub)})
        if out:
            save_csv(out, os.path.join(out_dir, f"profiles_{gkey}.csv"))


def _div(a, b):
    return None if a is None or b is None else float(np.divide(a, b))


def add_ratio_metrics(rows):
    """Set the ratio columns of every row in place: sulcus rows against the
    mean of the rectangle rows of their Pe, None elsewhere."""
    rect = {}
    for r in rows:
        if r["Domain"] == "rectangle":
            rect.setdefault(r["Peclet"], []).append(r)
    means = {pe: {k: float(np.mean([r[k] for r in rs])) for k in
                  ("Avg Concentration", "Max_Ux_mid_channel",
                   "Avg_Ux_mid_channel")}
             for pe, rs in rect.items()}
    for r in rows:
        for col in RATIO_COLUMNS:
            r[col] = None
        m = means.get(r["Peclet"])
        if r["Domain"] != "sulcus" or m is None:
            continue
        r["Concentration_Ratio"] = _div(r["Avg Concentration"],
                                        m["Avg Concentration"])
        r["Channel_Conc_Ratio"] = _div(r["Main Channel Avg Concentration"],
                                       m["Avg Concentration"])
        r["VR_mid_avg"] = _div(r["Avg_Ux_mid_channel"],
                               m["Avg_Ux_mid_channel"])
        r["VR_mid_max"] = _div(r["Max_Ux_mid_channel"],
                               m["Max_Ux_mid_channel"])
        r["Intradomain_Enrichment"] = _div(
            r["Sulcus Avg Concentration"],
            r["Main Channel Avg Concentration"])
        r["VR_intradomain_avg"] = _div(r["Avg_Ux_sulcus_level"],
                                       r["Avg_Ux_mid_channel"])
        r["VR_intradomain_max"] = _div(r["Max_Ux_sulcus_level"],
                                       r["Max_Ux_mid_channel"])
    return rows


def run_geometry_study(geometries=None, peclet_numbers=None,
                       mesh_size_dim=None, base_dir=BASE_DIR, device="cuda",
                       verbose=True, solver_options=None,
                       stokes_options=None, shard=None):
    """The no-uptake study on ``device`` over the named geometries of
    ``create_geometry_variations`` (default: all 23) and the rectangle.
    ``solver_options``: the transport solves' configuration
    (``studies.common.split_solver_options``); ``stokes_options``: the
    Stokes velocity hierarchy's cycle options (``stokes_setup``);
    ``shard``: a started ``RankGroup`` runs every solve sharded.
    Returns (rows, stats) with one stats dict per domain run."""
    pes = list(peclet_numbers or PECLET_NUMBERS)
    print("=" * 64 + "\nNO-UPTAKE GEOMETRY x PECLET STUDY\n" + "=" * 64)
    t0 = time.time()
    study_dir, _ = create_study_dirs("Geometry Comparison", base_dir)
    configs = create_geometry_variations(Parameters(mode="no-uptake"),
                                         max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}
    rows, stats, profile_runs = [], [], []
    for gkey, gcfg in configs.items():
        params_list = [_make_params(pe, gcfg["sulci_w_dim"],
                                    gcfg["sulci_h_dim"], mesh_size_dim)
                       for pe in pes]
        r, st, prof = _domain_runs(
            params_list, "sulcus", device, verbose, solver_options,
            stokes_options, gkey if gkey in PROFILE_GEOMETRIES else None,
            shard)
        rows += r
        stats.append(dict(st, geometry=gkey))
        profile_runs += [{"geometry": gkey, "rows": p} for p in prof or []]
    rect = run_rectangular_baselines(pes, mesh_size_dim, device, verbose,
                                     solver_options, stokes_options,
                                     collect_profiles=bool(profile_runs),
                                     shard=shard)
    r, st = rect[:2]
    rows += r
    stats.append(dict(st, geometry="rectangle"))
    # the rectangle's curves overlay every profile geometry's samples
    for gkey in dict.fromkeys(run["geometry"] for run in profile_runs):
        profile_runs.append({"geometry": gkey, "rows": rect[2]})
    add_ratio_metrics(rows)
    save_csv(rows, os.path.join(study_dir,
                                "geometry_comparison_results.csv"))
    if profile_runs:
        prof_dir = os.path.join(study_dir, "Profiles")
        export_profile_samples_csv_sulci(profile_runs, prof_dir)
        export_profile_stats_csv(profile_runs, prof_dir)
        plot_or_skip("no-uptake profile grids", _plot_profile_grids,
                     prof_dir)
    plot_or_skip("no-uptake heatmaps", generate_all_plots, rows,
                 os.path.join(study_dir, "Plots"))
    save_metadata({
        "study_type": "No-Uptake Geometry Comparison",
        "peclet_numbers": pes, "n_geometries": len(configs),
        "mesh_size_dim": mesh_size_dim, "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"No-uptake study done in {time.time() - t0:.1f}s")
    return rows, stats


def _plot_profile_grids(prof_dir):
    from glob import glob
    for csv in sorted(glob(os.path.join(prof_dir,
                                        "profiles_samples_*.csv"))):
        plot_profiles_grid_from_samples_csv(csv)


def replot_from_csv(base_dir=BASE_DIR):
    """The heatmaps again from the saved CSV; needs matplotlib.  Returns
    the CSV's Table, or None where there is no CSV."""
    study_dir = os.path.join(base_dir, "Geometry Comparison Analysis")
    csv_path = os.path.join(study_dir, "geometry_comparison_results.csv")
    if not os.path.exists(csv_path):
        print(f"No CSV at {csv_path}")
        return None
    t = Table.read_csv(csv_path)
    generate_all_plots(t, os.path.join(study_dir, "Plots"))
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="No-uptake geometry x Pe study on PyTorch")
    ap.add_argument("command", choices=["run", "baselines", "replot"],
                    nargs="?", default="run")
    ap.add_argument("--geometries", default=None,
                    help="comma-separated geometry keys (default: all)")
    ap.add_argument("--peclet", default=None,
                    help="comma-separated Peclet numbers (default 0.1,1,10)")
    ap.add_argument("--mesh-size", type=float, default=None)
    ap.add_argument("--base-dir", default=BASE_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    add_shard_arguments(ap)
    args = ap.parse_args(argv)
    if args.command == "replot":
        replot_from_csv(args.base_dir)
        return
    pes = ([float(x) for x in args.peclet.split(",")] if args.peclet
           else None)
    with shard_group(args) as group:
        if args.command == "baselines":
            run_rectangular_baselines(pes, args.mesh_size, args.device,
                                      shard=group)
            return
        run_geometry_study(
            geometries=(args.geometries.split(",") if args.geometries
                        else None),
            peclet_numbers=pes,
            mesh_size_dim=args.mesh_size, base_dir=args.base_dir,
            device=args.device, shard=group)


if __name__ == "__main__":
    main()
