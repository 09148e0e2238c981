"""Phase-A figures: mu-sweep curves, aspect-ratio lines, geometry scatter
(counterpart of ``plotting/phase_a_plots.py``; the reference's
no_advection_analysis_A.py:417-1249).

Each function takes a study's rows (the list of dicts ``save_csv``
returns) or a ``Table``; ``plot_phase_a_csv`` reads a study CSV.  Figures
and file names are the JAX package's.
"""

from __future__ import annotations

import ast
import os

import numpy as np

from .style import safe_plot
from .table import Table

__all__ = ["plot_mu_sweep", "plot_mu_sweep_correlation",
           "plot_mu_sweep_abs_error", "plot_aspect_ratio",
           "plot_aspect_ratio_subplots", "plot_model_error_comparison",
           "plot_geometry_analysis", "plot_geometry_error_grids",
           "plot_mu_eff_spatial", "plot_phase_a_csv", "phase_a_csv_kind",
           "CSV_FIGURES"]

_RATIO_COLS = {
    "Ratio_Sim": ("simulation", "C0"),
    "Ratio_Analytical": ("arc (analytic)", "C1"),
    "Ratio_Enhanced": ("enhanced", "C2"),
    "Ratio_Opening": ("opening", "C3"),
}
_REL_ERROR_COLS = [("Relative_Error_Analytical", "arc"),
                   ("Relative_Error_Enhanced", "enhanced"),
                   ("Relative_Error_Opening", "opening")]
_MU_EFF_COLS = [("Mu_Eff_Analytical", "arc"), ("Mu_Eff_Enhanced", "enhanced"),
                ("Mu_Eff_Opening", "opening")]
_REGIME_LABELS = {"low": "Low uptake", "physiological": "Physiological",
                  "high": "High uptake"}


def plot_mu_sweep(rows, plots_dir):
    """mu_eff / mu and the estimators' relative errors against the mu
    factor (ref :417-719)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    with safe_plot(os.path.join(plots_dir, "mu_sweep_ratios")) as (fig, ax):
        for col, (label, color) in _RATIO_COLS.items():
            if t.has(col):
                sub = t.sort_by("Mu_Factor")
                ax.semilogx(sub["Mu_Factor"], sub[col], "o-", ms=4,
                            label=label, color=color)
        ax.axhline(1.0, color="gray", lw=0.6, ls="--")
        ax.set_xlabel(r"$\mu$ factor")
        ax.set_ylabel(r"$\mu_{\mathrm{eff}}/\mu$")
        ax.set_title(r"$\mu_{\mathrm{eff}}/\mu$ across uptake regimes")
        ax.legend()
    with safe_plot(os.path.join(plots_dir, "mu_sweep_errors")) as (fig, ax):
        for col, label in _REL_ERROR_COLS:
            if t.has(col):
                sub = t.sort_by("Mu_Factor")
                ax.loglog(sub["Mu_Factor"], sub[col], "o-", ms=4,
                          label=label)
        ax.set_xlabel(r"$\mu$ factor")
        ax.set_ylabel("relative error vs sim (%)")
        ax.legend()


def _regime_groups(t):
    if "Regime" in t:
        return t.groups("Regime")
    return [("all", t)]


def plot_mu_sweep_correlation(rows, plots_dir):
    """Analytical against simulated mu_eff, with the identity line
    (ref :557-594)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    if "Mu_Eff_Sim" not in t:
        return
    with safe_plot(os.path.join(
            plots_dir, "analytical_vs_simulation_correlation")) as (fig, ax):
        for name, sub in _regime_groups(t):
            label = _REGIME_LABELS.get(name, str(name))
            if "Mu_Eff_Analytical" in sub:
                ax.loglog(sub["Mu_Eff_Sim"], sub["Mu_Eff_Analytical"],
                          "o", ms=5, label=f"{label} (arc)")
            if sub.has("Mu_Eff_Enhanced"):
                ax.loglog(sub["Mu_Eff_Sim"], sub["Mu_Eff_Enhanced"],
                          "s", ms=4, alpha=0.7, label=f"{label} (enh)")
        lo = float(np.nanmin(t["Mu_Eff_Sim"])) * 0.5
        hi = float(np.nanmax(t["Mu_Eff_Sim"])) * 2.0
        ax.plot([lo, hi], [lo, hi], "k--", lw=0.8, label="identity")
        ax.set_xlabel(r"$\mu_{\mathrm{eff}}^{\mathrm{sim}}$")
        ax.set_ylabel(r"analytical $\mu_{\mathrm{eff}}$")
        ax.set_title(r"Analytical vs simulation $\mu_{\mathrm{eff}}$"
                     " correlation")
        ax.legend(fontsize=8)


def plot_mu_sweep_abs_error(rows, plots_dir):
    """Absolute analytic-model error against the mu factor
    (ref :520-553)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    if "Mu_Eff_Sim" not in t:
        return
    with safe_plot(os.path.join(
            plots_dir, "absolute_error_vs_mu_factor")) as (fig, ax):
        sub = t.sort_by("Mu_Factor")
        for col, label in _MU_EFF_COLS:
            if sub.has(col):
                ax.loglog(sub["Mu_Factor"],
                          np.abs(sub[col] - sub["Mu_Eff_Sim"]),
                          "o-", ms=4, label=label)
        ax.set_xlabel(r"$\mu$ factor")
        ax.set_ylabel(r"$|\mu_{\mathrm{eff}} - "
                      r"\mu_{\mathrm{eff}}^{\mathrm{sim}}|$")
        ax.set_title("Analytical model absolute error vs uptake strength")
        ax.legend()


def plot_aspect_ratio(rows, plots_dir):
    """mu_eff / mu against depth per aspect-ratio family
    (ref :1361-1461)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    with safe_plot(os.path.join(plots_dir,
                                "aspect_ratio_ratios")) as (fig, ax):
        for ar_type, sub in t.groups("Aspect_Ratio_Type"):
            sub = sub.sort_by("Depth")
            ax.semilogx(sub["Depth"], sub["Ratio_Sim"], "o-", ms=4,
                        label=f"{ar_type} (sim)")
        ax.axhline(1.0, color="gray", lw=0.6, ls="--")
        ax.set_xlabel("sulcus depth (mm)")
        ax.set_ylabel(r"$\mu_{\mathrm{eff}}^{sim}/\mu$")
        ax.legend()
    with safe_plot(os.path.join(plots_dir,
                                "aspect_ratio_estimators")) as (fig, ax):
        sub = t.eq("Aspect_Ratio_Type", "h_equals_w").sort_by("Depth")
        for col, (label, color) in _RATIO_COLS.items():
            if sub.has(col):
                ax.semilogx(sub["Depth"], sub[col], "o-", ms=4,
                            label=label, color=color)
        ax.set_xlabel("sulcus depth (mm)  [h = w family]")
        ax.set_ylabel(r"$\mu_{\mathrm{eff}}/\mu$")
        ax.legend()


def plot_aspect_ratio_subplots(rows, plots_dir):
    """One panel per aspect-ratio family: mu_eff / mu against depth, every
    estimator (ref :819-866)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    fams = t.unique("Aspect_Ratio_Type")
    if not fams:
        return
    n = len(fams)
    with safe_plot(os.path.join(plots_dir, "aspect_ratio_subplots"),
                   figsize=(4 * n, 3.2)) as (fig, ax0):
        ax0.remove()
        axes = fig.subplots(1, n, squeeze=False)[0]
        for ax, fam in zip(axes, fams):
            sub = t.eq("Aspect_Ratio_Type", fam).sort_by("Depth")
            for col, (label, color) in _RATIO_COLS.items():
                if sub.has(col):
                    ax.semilogx(sub["Depth"], sub[col], "o-", ms=3,
                                label=label, color=color)
            ax.axhline(1.0, color="gray", lw=0.6, ls="--")
            ax.set_title(fam.replace("_", " "))
            ax.set_xlabel("depth (mm)")
            ax.set_ylabel(r"$\mu_{\mathrm{eff}}/\mu$")
        axes[-1].legend(fontsize=7)


def plot_model_error_comparison(rows, plots_dir):
    """Relative model error against depth per estimator (ref :870-905)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    if not any(t.has(c) for c, _ in _REL_ERROR_COLS):
        return
    with safe_plot(os.path.join(
            plots_dir, "model_error_comparison")) as (fig, ax):
        for col, label in _REL_ERROR_COLS:
            if not t.has(col):
                continue
            sub = t.sort_by("Depth") if "Depth" in t else t
            xs = sub["Depth"] if "Depth" in sub else np.arange(len(sub))
            ax.loglog(xs, np.abs(sub[col]), "o-", ms=3, label=label)
        ax.set_xlabel("depth (mm)")
        ax.set_ylabel("relative error vs sim (%)")
        ax.set_title("Model relative error vs depth")
        ax.legend()


def plot_geometry_error_grids(rows, plots_dir):
    """Per mu factor, the estimators' errors against the aspect ratio
    (ref :988-1092, absolute and relative grids)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    if "Mu_Factor" not in t:
        return
    mfs = t.unique("Mu_Factor")
    for kind, cols in (("absolute", _MU_EFF_COLS),
                       ("relative", _REL_ERROR_COLS)):
        if not any(t.has(c) for c, _ in cols):
            continue
        n = len(mfs)
        with safe_plot(os.path.join(
                plots_dir, f"geometry_{kind}_error_grid"),
                figsize=(4.5 * n, 3.4)) as (fig, ax0):
            ax0.remove()
            axes = fig.subplots(1, n, squeeze=False)[0]
            for ax, mf in zip(axes, mfs):
                sub = t.eq("Mu_Factor", mf).sort_by("Aspect_Ratio")
                for col, label in cols:
                    if not sub.has(col):
                        continue
                    if kind == "absolute" and "Mu_Eff_Sim" in sub:
                        ys = np.abs(sub[col] - sub["Mu_Eff_Sim"])
                    else:
                        ys = np.abs(sub[col])
                    ax.loglog(sub["Aspect_Ratio"], ys, "o", ms=4,
                              label=label)
                ax.set_title(rf"$\mu$ factor = {mf:g}")
                ax.set_xlabel("aspect ratio h/w")
                ax.set_ylabel(f"{kind} error"
                              + (" (%)" if kind == "relative" else ""))
            axes[-1].legend(fontsize=7)


def plot_geometry_analysis(rows, plots_dir):
    """Simulated mu_eff / mu against the aspect ratio, one series per mu
    factor."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    with safe_plot(os.path.join(plots_dir,
                                "geometry_ratio_vs_ar")) as (fig, ax):
        for mf, sub in t.groups("Mu_Factor"):
            sub = sub.sort_by("Aspect_Ratio")
            ax.semilogx(sub["Aspect_Ratio"], sub["Ratio_Sim"], "o",
                        ms=5, label=f"μ×{mf:g}")
        ax.axhline(1.0, color="gray", lw=0.6, ls="--")
        ax.set_xlabel("aspect ratio h/w")
        ax.set_ylabel(r"$\mu_{\mathrm{eff}}^{sim}/\mu$")
        ax.legend()


def plot_mu_eff_spatial(rows, plots_dir):
    """The sampled mu(x) along the bottom per mu factor
    (ref :1583-1682)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    with safe_plot(os.path.join(plots_dir,
                                "mu_bottom_profiles")) as (fig, ax):
        for row in t.rows():
            try:
                xs = ast.literal_eval(row["Mu_X_Array"])
                ms = ast.literal_eval(row["Mu_Values_Array"])
            except (ValueError, SyntaxError, TypeError):
                continue
            ax.plot(xs, ms, label=f"μ×{row['Mu_Factor']:g}")
        ax.set_xlabel("x")
        ax.set_ylabel(r"$\mu(x)$")
        ax.legend()


# the figures of each Phase-A CSV, by the part of its name that says which
# study wrote it (in this order: "mu_parameter_sweep" before the others)
CSV_FIGURES = {
    "mu_parameter_sweep": (plot_mu_sweep, plot_mu_sweep_correlation,
                           plot_mu_sweep_abs_error),
    "aspect_ratio": (plot_aspect_ratio, plot_aspect_ratio_subplots,
                     plot_model_error_comparison),
    "geometry_analysis": (plot_geometry_analysis, plot_geometry_error_grids),
    "mu_eff_analysis": (plot_mu_eff_spatial,),
}


def phase_a_csv_kind(csv_path):
    """The key of ``CSV_FIGURES`` that the CSV's name holds, or None."""
    name = os.path.basename(csv_path)
    return next((k for k in CSV_FIGURES if k in name), None)


def plot_phase_a_csv(csv_path):
    """The figures of one Phase-A CSV, chosen by its name, into
    ``Plots/`` beside it (``studies.phase_a.replot_from_csv``)."""
    kind = phase_a_csv_kind(csv_path)
    if kind is None:
        raise ValueError(f"unknown Phase-A CSV: {os.path.basename(csv_path)}")
    t = Table.read_csv(csv_path)
    plots_dir = os.path.join(os.path.dirname(csv_path), "Plots")
    for plot in CSV_FIGURES[kind]:
        plot(t, plots_dir)
