"""The committed study artifacts (``examples/*_tpu_h0.02``, made by the JAX
package at h = 0.02) and the comparison of a study's rows with them: which
columns, at which tolerance.  ``chip_smoke.py`` and ``run_studies.py`` both
hold their rows to the artifacts through this module.

Tolerances: 1e-6 relative on every compared column, with these
exceptions, each absolute over a scale taken from the artifact's row:

  no-uptake  the signed net fluxes (Mouth_Flux_Total, Inlet-Outlet Flux)
             over |Mouth Q_in| of the row (the rectangle: of the reference
             geometry's row at the same Pe), and at least over Q_FLOOR:
             differences of much larger fluxes, whose accuracy is that of
             the O(1) boundary fluxes (both Stokes solves stop at a
             relative residual of 1e-9), so below a mouth inflow of 1e-3
             (the micro sulci) they are held to 1e-9 absolute, as
             tests/test_torch_no_uptake.py holds the port to JAX
  adv-diff   the rectangle's advective_flux (0 but for rounding) over
             |total_flux|; flux_error_pct (a difference of fluxes, in
             percent) over 100
  Phase-B    flux_error_pct over 100
  profiles   (the no-uptake study's Profiles/ CSVs) sample coordinates to
             1e-12 of max(1, |value|), c and the line statistics to 1e-6 of
             max(|c|, 1e-3), counts and text exactly
  mesh convergence  the Richardson orders and limits of its
             study_metadata.json to 1e-4 relative

Two no-uptake rows of the artifact are stale (micro_depth_wide and
micro_square at Pe = 10 differ from the JAX package's current code by
5.9e-7 and 1.4e-8 in ``scripts/compare_sharded_study.py``'s measure):
they must be present, and their errors are reported on a line of their
own instead of being held to the tolerance.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["EXAMPLES", "TOL", "Artifact", "ARTIFACTS", "STALE_ROWS",
           "read_rows", "worst_errors", "check_rows", "check_csv",
           "check_profiles", "check_convergence", "nu_key"]

EXAMPLES = Path(__file__).resolve().parents[2] / "examples"
TOL = 1e-6
# below this |c| (a thousandth of the inflow concentration) profile values
# are held to TOL of it, absolutely, instead of to TOL of themselves
C_FLOOR = 1e-3
COORD_TOL = 1e-12
# the least |Mouth Q_in| the no-uptake net fluxes are scaled by
Q_FLOOR = 1e-3
CONVERGENCE_TOL = 1e-4
# the profile CSVs' coordinate columns: sample points, line places, and
# the mesh's extent
COORD_COLUMNS = ("x", "y", "x_min", "x_max", "y_min", "y_max")
PROFILE_GEOMETRIES = ("largest", "square_small")


def _num(v):
    return None if v in ("", None) else round(float(v), 9)


def nu_key(r):
    """(domain, width, depth, Pe) of a no-uptake row (CSV text or
    numbers); None width and depth for the rectangle."""
    return (r["Domain"], _num(r["Sulcus Width (mm)"]),
            _num(r["Sulcus Depth (mm)"]), _num(r["Peclet"]))


def _nu_scale(want):
    """The net-flux scale of a no-uptake artifact row: |Mouth Q_in| of the
    row, the rectangle's of the reference geometry (0.5 x 1.0 mm) at the
    same Pe; at least Q_FLOOR."""
    def scale(col, gr):
        k = nu_key(gr)
        if k[0] != "sulcus":
            k = ("sulcus", 0.5, 1.0, k[3])
        return max(abs(float(want[k]["Mouth Q_in"])), Q_FLOOR)
    return scale


def _percent_scale(want):
    return lambda col, gr: 100.0


def _ad_scale(want):
    """The adv-diff table's: advective_flux over |total_flux|,
    flux_error_pct over 100."""
    return lambda col, gr: (abs(float(gr["total_flux"]))
                            if col == "advective_flux" else 100.0)


class Artifact(NamedTuple):
    directory: str            # under examples/
    csv: str                  # the CSV's path in it, as the study writes it
    rows: int                 # the full study's row count
    key: Callable             # row -> its key (text or numbers alike)
    rel: Tuple[str, ...]      # columns within TOL relative
    absolute: Tuple[str, ...] = ()   # columns within TOL of a scale
    scale: Optional[Callable] = None  # (artifact rows by key) -> the
                                      #   scale(column, artifact row)


# the Phase-A sweep tables' columns (the mu sweep's since the port's
# first card runs; the geometry and aspect-ratio tables have the same)
PHASE_A_COLUMNS = ("Mu_Eff_Simulation", "Total_Mass", "Mouth_Flux_Total")

ARTIFACTS: Dict[str, Artifact] = {
    "phase_a_mu": Artifact(
        "phase_a_tpu_h0.02",
        "Mu Parameter Sweep Analysis/mu_parameter_sweep_results.csv", 20,
        lambda r: r["Config"], PHASE_A_COLUMNS),
    "phase_a_spatial": Artifact(
        "phase_a_tpu_h0.02",
        "Mu_Eff Spatial Analysis Analysis/mu_eff_analysis_results.csv", 3,
        lambda r: r["Config"],
        ("Mu_Value", "Mu_base_nondim", "Mu_Eff_Simulation",
         "Mu_Eff_Analytical", "Mu_Eff_Enhanced", "Mu_Eff_Opening",
         "Ratio_Sim", "Ratio_Opening", "Mu_Mean_Bottom")),
    "phase_a_geometry": Artifact(
        "phase_a_tpu_h0.02",
        "Geometry Analysis Analysis/geometry_analysis_results.csv", 69,
        lambda r: r["Config"], PHASE_A_COLUMNS),
    "phase_a_ar": Artifact(
        "phase_a_tpu_h0.02",
        "Aspect Ratio Study Analysis/aspect_ratio_analysis_results.csv", 54,
        lambda r: r["Config"], PHASE_A_COLUMNS),
    "phase_b": Artifact(
        "phase_b_tpu_h0.02", "mu Sweep Analysis/no_adv_mu_sweep_results.csv",
        69, lambda r: (r["geometry"], _num(r["mu_factor"])),
        ("avg_conc_sulc", "avg_conc_rect", "flux_sulc_y0",
         "flux_rect_bottom", "CR", "flux_ratio"), ("flux_error_pct",),
        _percent_scale),
    "no_uptake": Artifact(
        "no_uptake_tpu_h0.02",
        "Geometry Comparison Analysis/geometry_comparison_results.csv", 72,
        nu_key,
        ("Total Mass", "Avg Concentration", "Sulcus Avg Concentration",
         "Mouth E_L1", "Mouth Q_in", "Max_Ux_mid_channel",
         "Avg_Ux_mid_channel", "Concentration_Ratio"),
        ("Mouth_Flux_Total", "Inlet-Outlet Flux"), _nu_scale),
    "adv_diff": Artifact(
        "advdiff_tpu_h0.02",
        "Results Data/advdiff_validation_step_pe_x_mu.csv", 18,
        lambda r: (_num(r["Pe"]), _num(r["mu_factor"]), r["domain_type"]),
        ("total_flux", "diffusive_flux", "uptake_flux", "mu_eff_arc",
         "mu_eff_sim", "mu_eff_open", "avg_conc", "CR", "flux_ratio"),
        ("advective_flux", "flux_error_pct"), _ad_scale),
    "richardson": Artifact(
        "mesh_convergence_tpu_h0.02",
        "Mesh Convergence Analysis/mesh_convergence_results.csv", 15,
        lambda r: (_num(r["mesh_size"]), _num(r["mu_factor"])),
        ("num_cells", "num_vertices", "hmin", "hmax", "mu_eff_sim",
         "mu_eff_open", "mu_eff_arc", "mu_eff_enh", "ratio_sim", "y0_flux",
         "total_mass")),
}

# the artifact's stale rows, by study and key (ROADMAP.md queue 3)
STALE_ROWS = {"no_uptake": {("sulcus", 1.0, 0.05, 10.0): "micro_depth_wide",
                            ("sulcus", 0.01, 0.01, 10.0): "micro_square"}}


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _missing(v):
    return v is None or v == ""


def _errors(tag, got, want, rel_cols, abs_cols, scale):
    """({column: worst error}, {column: key of the row where it is})."""
    worst = {c: 0.0 for c in (*rel_cols, *abs_cols)}
    where = {c: None for c in worst}
    for key, r in got.items():
        gr = want[key]
        for col in worst:
            if _missing(gr[col]):
                if not _missing(r.get(col)):
                    raise AssertionError(f"[{tag}] {key} {col}: {r[col]} "
                                         "where the artifact has none")
                continue
            v, ref = float(r[col]), float(gr[col])
            if not np.isfinite(v):
                raise AssertionError(f"[{tag}] {key} {col}: {v}")
            e = abs(v - ref) / (abs(ref) if col in rel_cols
                                else scale(col, gr))
            if e > worst[col]:
                worst[col], where[col] = e, key
    return worst, where


def worst_errors(tag, got, want, rel_cols, abs_cols=(), scale=None,
                 tol=TOL):
    """Worst error per column of ``got`` (rows by key: numbers or CSV
    text) against ``want`` (the artifact's rows by the same keys):
    ``rel_cols`` relative, ``abs_cols`` over ``scale(column, want
    row)``.  Prints one line per column (with the row of its worst);
    raises on a column above ``tol`` or on a row set that differs."""
    if sorted(got, key=repr) != sorted(want, key=repr):
        raise AssertionError(f"[{tag}] rows {sorted(got, key=repr)} vs the "
                             f"artifact's {sorted(want, key=repr)}")
    worst, where = _errors(tag, got, want, rel_cols, abs_cols, scale)
    for col, e in worst.items():
        print(f"[{tag}] {col}: worst diff vs the artifact {e:.3e} (tol "
              f"{tol:g}; row {where[col]})", flush=True)
    bad = {k: v for k, v in worst.items() if not v <= tol}
    if bad:
        raise AssertionError(f"[{tag}] columns off the artifact: {bad}")
    return worst


def check_rows(study, rows, tag=None, subset=None, tol=TOL,
               examples=EXAMPLES):
    """Hold ``rows`` (dicts, numbers or CSV text) of ``study`` to its
    artifact: the artifact's rows (those ``subset(key)`` keeps, when given;
    all of them otherwise, and then the full count) by key, each column
    within ``tol`` (relative, or of its scale).  The artifact's stale rows
    (``STALE_ROWS``) must be there like the others, but their errors are
    reported on a line of their own, not held to ``tol``.  Returns the
    worst error per column (and per stale row under ``"stale"``)."""
    a = ARTIFACTS[study]
    tag = tag or study
    all_rows = read_rows(Path(examples) / a.directory / a.csv)
    want = {a.key(r): r for r in all_rows}
    if subset is not None:
        want = {k: r for k, r in want.items() if subset(k)}
    elif len(want) != a.rows or len(all_rows) != a.rows:
        raise AssertionError(f"[{tag}] the artifact holds {len(all_rows)} "
                             f"rows, not {a.rows}")
    got = {}
    for r in rows:
        k = a.key(r)
        if k in got:
            raise AssertionError(f"[{tag}] row {k} twice")
        got[k] = r
    if sorted(got, key=repr) != sorted(want, key=repr):
        raise AssertionError(f"[{tag}] {len(got)} rows vs the artifact's "
                             f"{len(want)}, or other keys")
    scale = None if a.scale is None else a.scale(
        {a.key(r): r for r in all_rows})
    stale = {k: n for k, n in STALE_ROWS.get(study, {}).items() if k in got}
    worst = worst_errors(
        tag, {k: r for k, r in got.items() if k not in stale},
        {k: r for k, r in want.items() if k not in stale}, a.rel,
        a.absolute, scale, tol)
    if stale:
        worst["stale"], parts = {}, []
        for k, n in stale.items():
            e = _errors(tag, {k: got[k]}, {k: want[k]}, a.rel, a.absolute,
                        scale)[0]
            worst["stale"][n] = e
            col = max(e, key=e.get)
            parts.append(f"{n} {k}: worst {col} {e[col]:.3e}, "
                         f"{sum(v > tol for v in e.values())} columns above "
                         "tol")
        print(f"[{tag}] stale artifact rows (reported, not held to tol "
              f"{tol:g}): " + "; ".join(parts), flush=True)
    return worst


def check_csv(study, out_dir, tag=None, examples=EXAMPLES):
    """``check_rows`` on the CSV a study wrote under ``out_dir`` (its
    output directory, as the artifact's is ``examples/<directory>``)."""
    return check_rows(study, read_rows(Path(out_dir) / ARTIFACTS[study].csv),
                      tag, examples=examples)


def _same_number(a, b):
    """Two CSV cells of one number (e.g. "400" and "400.0")."""
    try:
        return float(a) == float(b)
    except ValueError:
        return False


def check_profiles(prof_dir, tag="no_uptake", examples=EXAMPLES):
    """Each profile geometry's two Profiles/ CSVs against the artifact's,
    row for row: the same header, rows and text cells; sample coordinates
    and line places to 1e-12 (of max(1, |value|)), c and the line
    statistics to 1e-6 of max(|c|, C_FLOOR), counts exactly.  Returns the
    worst errors, and the worst relative error of c where |c| >=
    C_FLOOR."""
    ref_dir = (Path(examples) / ARTIFACTS["no_uptake"].directory
               / "Geometry Comparison Analysis" / "Profiles")
    worst = {"coord": 0.0, "c": 0.0, "c_rel_above_floor": 0.0, "stats": 0.0}
    n_rows = {}
    for g in PROFILE_GEOMETRIES:
        for name in (f"profiles_samples_{g}.csv", f"profiles_{g}.csv"):
            got = read_rows(Path(prof_dir) / name)
            want = read_rows(ref_dir / name)
            if not got or list(got[0]) != list(want[0]):
                raise AssertionError(f"{name}: header differs")
            if len(got) != len(want):
                raise AssertionError(f"{name}: {len(got)} rows, the "
                                     f"artifact {len(want)}")
            n_rows[name] = len(got)
            for i, (a, b) in enumerate(zip(got, want)):
                for col, ref in b.items():
                    if a[col] == ref:
                        continue
                    if col in COORD_COLUMNS and ref != "" and a[col] != "":
                        e = abs(float(a[col]) - float(ref)) / max(
                            1.0, abs(float(ref)))
                        worst["coord"] = max(worst["coord"], e)
                    elif col == "c" or col.endswith("_c"):
                        v, r = float(a[col]), float(ref)
                        if not np.isfinite(v):
                            raise AssertionError(f"{name} row {i} {col}: {v}")
                        k = "c" if col == "c" else "stats"
                        worst[k] = max(worst[k],
                                       abs(v - r) / max(abs(r), C_FLOOR))
                        if abs(r) >= C_FLOOR:
                            worst["c_rel_above_floor"] = max(
                                worst["c_rel_above_floor"],
                                abs(v - r) / abs(r))
                    elif not _same_number(a[col], ref):
                        raise AssertionError(f"{name} row {i} {col}: "
                                             f"{a[col]!r} vs {ref!r}")
    print(f"[{tag}] profile CSVs {n_rows}: worst coordinate diff "
          f"{worst['coord']:.3e} (tol {COORD_TOL:g}), c {worst['c']:.3e} and "
          f"line statistics {worst['stats']:.3e} of max(|c|, {C_FLOOR}) (tol "
          f"{TOL:g}); c relative where |c| >= {C_FLOOR}: "
          f"{worst['c_rel_above_floor']:.3e}", flush=True)
    if not (worst["coord"] <= COORD_TOL and worst["c"] <= TOL
            and worst["stats"] <= TOL):
        raise AssertionError(f"profile CSVs off the artifact: {worst}")
    return dict(worst, rows=n_rows)


def check_convergence(meta, tag="mesh_convergence", examples=EXAMPLES):
    """The mesh-convergence study's Richardson orders and extrapolated
    limits (``meta["convergence"]``) against its artifact's
    study_metadata.json, 1e-4 relative; prints its realisation floors
    beside the artifact's.  Returns the relative errors."""
    want = json.loads((Path(examples) / ARTIFACTS["richardson"].directory
                       / "Mesh Convergence Analysis"
                       / "study_metadata.json").read_text())
    conv = {}
    for mf, c in want["convergence"].items():
        g = meta["convergence"][mf]
        for k, ref in c.items():
            e = abs(g[k] - ref) / abs(ref)
            conv[f"{mf} {k}"] = e
            print(f"[{tag}] mu*={mf} {k}: {g[k]!r} (artifact {ref!r}, rel "
                  f"diff {e:.3e}, tol {CONVERGENCE_TOL:g})", flush=True)
    for mf, f in want["mesh_realisation_floor"].items():
        g = meta.get("mesh_realisation_floor", {}).get(mf)
        if g is not None:
            print(f"[{tag}] realisation floor mu*={mf}: "
                  + ", ".join(f"{k} {g[k]:.6e} (artifact {v:.6e})"
                              for k, v in f.items()), flush=True)
    bad = {k: e for k, e in conv.items() if not e <= CONVERGENCE_TOL}
    if bad:
        raise AssertionError(f"orders or limits off the artifact: {bad}")
    return conv
