"""Phase-A studies: no advection, sulcus only (counterpart of
``studies/phase_a.py``).  Each mu sweep on one geometry is ONE batched
solve (``studies.common.no_adv_batch``); each study writes its CSV with the
JAX package's columns and a ``study_metadata.json``.

  mu_sweep      20 mu factors in three uptake regimes, 0.25 x 0.25 mm sulcus
  aspect_ratio  a depth ladder x aspect ratios {1, 2, 0.5}, widths <= 1 mm
  geometry      the 23 geometries x mu factors {0.1, 1, 10}
  mu_eff        the 0.5 x 1.0 mm sulcus x 3 mu, with mu(x) sampled along
                the bottom

    python -m fenics_eff_uptake_tpu_torch.studies.phase_a --study mu_sweep \\
        [--mesh-size 0.02] [--base-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..analysis.mu_eff import sample_mu_along_bottom
from ..params import Parameters, create_geometry_variations
from .common import (create_study_dir, make_no_adv_params, no_adv_batch,
                     save_csv, save_metadata)

__all__ = ["run_mu_sweep", "run_aspect_ratio_analysis",
           "run_geometry_analysis", "run_mu_eff_analysis",
           "aspect_ratio_depths", "MU_SWEEP_REGIMES", "ASPECT_RATIOS",
           "BASE_DIR"]

BASE_DIR = "Results/No Advection Simulations/Phase A"

MU_SWEEP_REGIMES = {
    "small_uptake": [0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 2.5, 3.0],
    "moderate_uptake": [5.0, 7.5, 10.0, 12.5, 15.0],
    "high_uptake": [50.0, 75.0, 100.0, 125.0, 150.0],
}


def _mu_eff_columns(result):
    """The mu_eff, mass and mouth-flux CSV columns of one result."""
    row = {}
    me = result.get("mu_eff_comparison")
    if me:
        row.update({
            "Mu_Eff_Simulation": me.get("mu_eff_sim"),
            "Mu_Eff_Analytical": me.get("mu_eff_arc"),
            "Mu_Eff_Enhanced": me.get("mu_eff_enh"),
            "Mu_Eff_Opening": me.get("mu_eff_open"),
        })
        ratios = me.get("ratios", {})
        row.update({
            "Ratio_Sim": ratios.get("sim"),
            "Ratio_Analytical": ratios.get("arc"),
            "Ratio_Enhanced": ratios.get("enh"),
            "Ratio_Opening": ratios.get("open"),
        })
        errs = me.get("errors_vs_sim", {})
        row.update({
            "Relative_Error_Analytical": errs.get("arc"),
            "Relative_Error_Enhanced": errs.get("enh"),
            "Relative_Error_Opening": errs.get("open"),
        })
    row["Total_Mass"] = result.get("mass_metrics", {}).get("total_mass")
    mouth = (result.get("flux_metrics", {}).get("sulcus_specific", {})
             .get("physical_flux", {}).get("sulcus_opening", {}))
    row["Mouth_Flux_Total"] = mouth.get("total")
    return row


def run_mu_sweep(device, mesh_size_dim=0.02, base_dir=BASE_DIR,
                 verbose=True):
    """The mu sweep on ``device``; returns (rows, stats) (see
    ``studies.common.no_adv_batch`` for stats)."""
    print("=" * 60 + "\nMU PARAMETER SWEEP STUDY\n" + "=" * 60)
    t0 = time.time()
    study_dir = create_study_dir("Mu Parameter Sweep", base_dir)
    factors = [f for regime in MU_SWEEP_REGIMES.values() for f in regime]
    regimes = [name for name, fs in MU_SWEEP_REGIMES.items() for _ in fs]
    geom = make_no_adv_params(1.0, sulci_w_dim=0.25, sulci_h_dim=0.25,
                              mesh_size_dim=mesh_size_dim)
    results, stats = no_adv_batch(geom, factors, "sulcus", device,
                                  verbose=verbose)
    rows = []
    for regime, factor, res in zip(regimes, factors, results):
        row = {
            "Config": f"{regime}_mu_{factor:.1f}x",
            "Regime": regime,
            "Mu_Factor": factor,
            "Mu_dim": res["params"].mu_dim,
            "Mu": res["params"].mu,
            "Baseline_Mu_dim": Parameters.MU_DIM_NO_ADV,
        }
        row.update(_mu_eff_columns(res))
        rows.append(row)
    save_csv(rows, os.path.join(study_dir, "mu_parameter_sweep_results.csv"))
    save_metadata({
        "study_type": "Mu Parameter Sweep",
        "regimes": MU_SWEEP_REGIMES,
        "geometry_mm": [0.25, 0.25],
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Mu sweep done in {time.time() - t0:.1f}s")
    return rows, stats


def aspect_ratio_depths():
    """The depth ladder (mm): 10 log-spaced micro depths, then meso and
    macro steps."""
    micro = np.logspace(np.log10(0.01), np.log10(0.10), 10)
    meso = np.array([0.12, 0.15, 0.20, 0.25, 0.35, 0.50, 0.75, 1.00])
    macro = np.array([1.50, 2.00, 2.50, 3.00, 3.50, 4.00, 4.50, 5.00])
    return sorted(set(np.round(np.concatenate([micro, meso, macro]), 4)))


ASPECT_RATIOS = {"h_equals_w": 1.0, "h_equals_2w": 2.0,
                 "h_equals_half_w": 0.5}


def run_aspect_ratio_analysis(device, mesh_size_dim=0.02, base_dir=BASE_DIR,
                              depths=None, verbose=True):
    """mu_eff / mu against depth at three aspect ratios (mu factor 1, one
    mesh per depth and ratio; widths above 1 mm are skipped).  Returns
    (rows, stats) with one stats dict per geometry."""
    print("=" * 60 + "\nASPECT RATIO ANALYSIS\n" + "=" * 60)
    t0 = time.time()
    study_dir = create_study_dir("Aspect Ratio Study", base_dir)
    if depths is None:
        depths = aspect_ratio_depths()
    rows, stats = [], []
    for ar_name, ar_value in ASPECT_RATIOS.items():
        for h in depths:
            w = h / ar_value
            if w > 1.0:
                continue
            geom = make_no_adv_params(1.0, sulci_w_dim=w, sulci_h_dim=h,
                                      mesh_size_dim=mesh_size_dim)
            results, st = no_adv_batch(geom, [1.0], "sulcus", device,
                                       verbose=verbose)
            row = {"Config": f"{ar_name}_h{h}",
                   "Aspect_Ratio_Type": ar_name, "Width": w, "Depth": h,
                   "Aspect_Ratio": ar_value}
            row.update(_mu_eff_columns(results[0]))
            rows.append(row)
            stats.append(dict(st, config=row["Config"]))
    save_csv(rows, os.path.join(study_dir,
                                "aspect_ratio_analysis_results.csv"))
    save_metadata({
        "study_type": "Aspect Ratio Study",
        "aspect_ratios": ASPECT_RATIOS,
        "n_depths": len(depths),
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Aspect ratio study done in {time.time() - t0:.1f}s")
    return rows, stats


def run_geometry_analysis(device, mu_factors=(0.1, 1.0, 10),
                          mesh_size_dim=0.02, base_dir=BASE_DIR,
                          geometries=None, verbose=True):
    """The named geometries of ``create_geometry_variations`` (default: all
    23) x mu factors, one batched solve per geometry.  Returns (rows,
    stats) with one stats dict per geometry."""
    print("=" * 60 + "\nGEOMETRY ANALYSIS STUDY\n" + "=" * 60)
    t0 = time.time()
    study_dir = create_study_dir("Geometry Analysis", base_dir)
    configs = create_geometry_variations(Parameters(mode="no-adv"),
                                         max_width=1.0)
    if geometries is not None:
        configs = {k: v for k, v in configs.items() if k in geometries}
    rows, stats = [], []
    for gkey, gcfg in configs.items():
        w, h = gcfg["sulci_w_dim"], gcfg["sulci_h_dim"]
        geom = make_no_adv_params(1.0, sulci_w_dim=w, sulci_h_dim=h,
                                  mesh_size_dim=mesh_size_dim)
        results, st = no_adv_batch(geom, list(mu_factors), "sulcus", device,
                                   verbose=verbose)
        stats.append(dict(st, geometry=gkey))
        for factor, res in zip(mu_factors, results):
            row = {
                "Config": f"{gkey}_mu_{factor}x",
                "Geometry_Name": gkey,
                "Mu_Value": res["params"].mu_dim,
                "Mu_Factor": factor,
                "Sulcus_Width_mm": w,
                "Sulcus_Depth_mm": h,
                "Aspect_Ratio": h / w if w > 0 else None,
                "Aspect_Ratio_Category": gcfg.get("aspect_ratio_category",
                                                  "unknown"),
            }
            row.update(_mu_eff_columns(res))
            rows.append(row)
    save_csv(rows, os.path.join(study_dir, "geometry_analysis_results.csv"))
    save_metadata({
        "study_type": "Geometry Analysis",
        "mu_factors": list(mu_factors),
        "n_geometries": len(configs),
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Geometry analysis done in {time.time() - t0:.1f}s")
    return rows, stats


def run_mu_eff_analysis(device, mu_factors=(0.1, 1.0, 10.0),
                        mesh_size_dim=0.02, base_dir=BASE_DIR, verbose=True):
    """mu_eff on the 0.5 x 1.0 mm sulcus, with mu(x) sampled at 100 points
    along the bottom.  Returns (rows, stats)."""
    print("=" * 60 + "\nMU_EFF SPATIAL ANALYSIS\n" + "=" * 60)
    t0 = time.time()
    study_dir = create_study_dir("Mu_Eff Spatial Analysis", base_dir)
    geom = make_no_adv_params(1.0, sulci_w_dim=0.5, sulci_h_dim=1.0,
                              mesh_size_dim=mesh_size_dim)
    results, stats = no_adv_batch(geom, list(mu_factors), "sulcus", device,
                                  verbose=verbose)
    rows = []
    for factor, res in zip(mu_factors, results):
        p = res["params"]
        row = {
            "Config": f"mu_eff_analysis_mu_{factor}x",
            "Mu_Value": p.mu_dim,
            "Mu_Factor": factor,
            "Sulcus_Width_mm": p.sulci_w_dim,
            "Sulcus_Depth_mm": p.sulci_h_dim,
            "Domain_Length_mm": p.L_dim,
            "L_ref": p.L_ref,
            "L_nondim": p.L,
            "H_nondim": p.H,
            "Sulcus_W_nondim": p.sulci_w,
            "Sulcus_H_nondim": p.sulci_h,
            "Mu_base_nondim": p.mu,
        }
        me = res.get("mu_eff_comparison", {})
        ratios = me.get("ratios", {})
        row.update({
            "Mu_Eff_Simulation": me.get("mu_eff_sim"),
            "Mu_Eff_Analytical": me.get("mu_eff_arc"),
            "Mu_Eff_Enhanced": me.get("mu_eff_enh"),
            "Mu_Eff_Opening": me.get("mu_eff_open"),
            "Ratio_Sim": ratios.get("sim"),
            "Ratio_Analytical": ratios.get("arc"),
            "Ratio_Enhanced": ratios.get("enh"),
            "Ratio_Opening": ratios.get("open"),
        })
        sample = sample_mu_along_bottom(p, res["mesh_results"]["mesh"],
                                        n_points=100)
        row.update({
            "Mu_Mean_Bottom": sample["mu_mean"],
            "Mu_Min_Bottom": sample["mu_min"],
            "Mu_Max_Bottom": sample["mu_max"],
            "Mu_X_Array": str(sample["x"].tolist()),
            "Mu_Values_Array": str(sample["mu"].tolist()),
        })
        rows.append(row)
    save_csv(rows, os.path.join(study_dir, "mu_eff_analysis_results.csv"))
    save_metadata({
        "study_type": "Mu_Eff Spatial Analysis",
        "mu_factors": list(mu_factors),
        "geometry_mm": [0.5, 1.0],
        "mesh_size_dim": mesh_size_dim,
        "elapsed_s": time.time() - t0,
        "solver": stats,
    }, os.path.join(study_dir, "study_metadata.json"))
    print(f"Mu_eff analysis done in {time.time() - t0:.1f}s")
    return rows, stats


STUDIES = {"mu_sweep": run_mu_sweep,
           "aspect_ratio": run_aspect_ratio_analysis,
           "geometry": run_geometry_analysis,
           "mu_eff": run_mu_eff_analysis}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Phase-A no-advection studies on PyTorch")
    ap.add_argument("--study", choices=[*STUDIES, "all"], default="mu_sweep")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--base-dir", default=BASE_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    for name, run in STUDIES.items():
        if args.study in (name, "all"):
            run(args.device, mesh_size_dim=args.mesh_size,
                base_dir=args.base_dir)


if __name__ == "__main__":
    main()
