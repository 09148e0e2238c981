"""Phase-A study: the mu parameter sweep (counterpart of
``studies/phase_a.py`` ``run_mu_sweep``).

20 mu factors in three uptake regimes on the 0.25 x 0.25 mm sulcus, solved
as ONE batched sweep; writes ``mu_parameter_sweep_results.csv`` with the
JAX package's columns and ``study_metadata.json``.  The other Phase-A
studies are not ported yet.

    python -m fenics_eff_uptake_tpu_torch.studies.phase_a --study mu_sweep \\
        [--mesh-size 0.02] [--base-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

from ..params import Parameters
from .common import (create_study_dir, make_no_adv_params, no_adv_batch,
                     save_csv, save_metadata)

__all__ = ["run_mu_sweep", "MU_SWEEP_REGIMES", "BASE_DIR"]

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


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Phase-A no-advection studies on PyTorch")
    ap.add_argument("--study", choices=["mu_sweep"], default="mu_sweep")
    ap.add_argument("--mesh-size", type=float, default=0.02)
    ap.add_argument("--base-dir", default=BASE_DIR)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    run_mu_sweep(args.device, args.mesh_size, args.base_dir)


if __name__ == "__main__":
    main()
