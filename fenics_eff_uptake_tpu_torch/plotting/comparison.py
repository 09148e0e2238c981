"""Comparison figures across configurations and their JSON summary
(counterpart of ``plotting/comparison.py``; the reference's
plotting.py:778-1143).  Inputs are ``{config name: run_simulation
results}``; the files and ``summary.json`` content are the JAX
package's."""

from __future__ import annotations

import json
import os

import numpy as np

from .style import Config, add_value_labels, latexify_label, safe_plot

__all__ = ["plot_configuration_comparison", "plot_aspect_ratio_comparison",
           "plot_flux_comparison", "plot_mu_eff_comparison",
           "plot_mu_eff_ratios_comparison", "save_summary"]


def _get(results, *path, default=None):
    cur = results
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def _mode_of(results_dict):
    for r in results_dict.values():
        p = (r or {}).get("params")
        if p is not None:
            return getattr(p, "mode", None)
    return None


def _clean(name):
    return name.replace("_", " ").title()


def _grouped_bars(ax, names, series):
    """series: list of (label, values) with len(values) == len(names)."""
    x = np.arange(len(names))
    nh = max(len(series), 1)
    w = 0.8 / nh
    for k, (label, vals) in enumerate(series):
        vals = [v if v is not None else np.nan for v in vals]
        ax.bar(x + (k - (nh - 1) / 2) * w, vals, width=w, label=label)
    ax.set_xticks(x)
    ax.set_xticklabels([_clean(n) for n in names], rotation=45,
                       ha="right", fontsize=8)
    if len(series) > 1:
        ax.legend(fontsize=8)


def plot_flux_comparison(results_dict, plots_dir):
    """Physical vs uptake flux magnitude per configuration, grouped
    (ref plotting.py:778-805: Physical/Uptake hue pair; the Uptake bar
    is dropped in no-uptake mode exactly as the reference does)."""
    os.makedirs(plots_dir, exist_ok=True)
    names = list(results_dict.keys())
    mode = _mode_of(results_dict)
    phys = [abs(v) if (v := _get(r, "flux_metrics", "physical_flux",
                                 "bottom", "total")) is not None else None
            for r in results_dict.values()]
    series = [("Physical", phys)]
    if mode != "no-uptake":
        upt = [abs(v) if (v := _get(r, "flux_metrics",
                                    "uptake_flux")) is not None else None
               for r in results_dict.values()]
        series.append(("Uptake", upt))
    if not any(v is not None for _, vals in series for v in vals):
        return
    with safe_plot(os.path.join(plots_dir, "flux_comparison"),
                   figsize=Config.FIGSIZE_WIDE) as (fig, ax):
        _grouped_bars(ax, names, series)
        ax.set_title("Flux comparison"
                     + (f" -- {mode}" if mode else ""))
        ax.set_ylabel("flux magnitude")
        add_value_labels(ax, mode="simple")


_MU_EFF_METHODS = [
    ("Simulation (Full)", "mu_eff_sim", "sim"),
    ("Simulation (Opening)", "mu_eff_open", "open"),
    ("Analytical", "mu_eff_arc", "arc"),
    ("Enhanced", "mu_eff_enh", "enh"),
]


def plot_mu_eff_comparison(results_dict, plots_dir):
    """mu_eff per configuration, grouped by estimator
    (ref plotting.py:855-894; the reference reads alias keys
    mu_eff_simulation_full/_segmented its analysis never emits -- the
    real emitted keys are sim/open/arc/enh, plotted here)."""
    os.makedirs(plots_dir, exist_ok=True)
    if _mode_of(results_dict) == "no-uptake":
        return
    names = list(results_dict.keys())
    series = []
    for label, key, _ in _MU_EFF_METHODS:
        vals = [_get(r, "mu_eff_comparison", key)
                for r in results_dict.values()]
        if any(v is not None for v in vals):
            series.append((label, vals))
    if not series:
        return
    with safe_plot(os.path.join(plots_dir, "mu_eff_comparison"),
                   figsize=Config.FIGSIZE_WIDE) as (fig, ax):
        _grouped_bars(ax, names, series)
        ax.set_title(latexify_label(
            r"$\mu_{\mathrm{eff}}$ comparison across configurations"))
        ax.set_ylabel(latexify_label(
            r"effective uptake rate $\mu_{\mathrm{eff}}$"))


def plot_mu_eff_ratios_comparison(results_dict, plots_dir):
    """mu_eff/mu ratios per configuration, grouped by estimator, with
    the ideal-1.0 line (ref plotting.py:899-937)."""
    os.makedirs(plots_dir, exist_ok=True)
    if _mode_of(results_dict) == "no-uptake":
        return
    names = list(results_dict.keys())
    series = []
    for label, _, rkey in _MU_EFF_METHODS:
        vals = [_get(r, "mu_eff_comparison", "ratios", rkey)
                for r in results_dict.values()]
        if any(v is not None for v in vals):
            series.append((label, vals))
    if not series:
        return
    with safe_plot(os.path.join(plots_dir, "mu_eff_ratios_comparison"),
                   figsize=Config.FIGSIZE_WIDE) as (fig, ax):
        _grouped_bars(ax, names, series)
        ax.axhline(1.0, color="gray", ls="--", lw=1, alpha=0.7)
        ax.set_title(latexify_label(
            r"$\mu_{\mathrm{eff}}/\mu$ ratio comparison"))
        ax.set_ylabel(latexify_label(r"ratio $\mu_{\mathrm{eff}}/\mu$"))


def plot_configuration_comparison(results_dict, plots_dir):
    """Bar comparisons of flux / mass / avg-conc / mu_eff over configs
    (ref plotting.py:778-951)."""
    os.makedirs(plots_dir, exist_ok=True)
    names = list(results_dict.keys())

    def bars(path_base, values, title, ylabel):
        with safe_plot(os.path.join(plots_dir, path_base),
                       figsize=Config.FIGSIZE_WIDE) as (fig, ax):
            x = np.arange(len(names))
            vals = [v if v is not None else np.nan for v in values]
            ax.bar(x, vals)
            ax.set_xticks(x)
            ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
            ax.set_title(latexify_label(title))
            ax.set_ylabel(latexify_label(ylabel))

    bars("compare_total_mass",
         [_get(r, "mass_metrics", "total_mass") for r in
          results_dict.values()],
         "Total mass by configuration", "∫c dx")
    bars("compare_uptake_flux",
         [_get(r, "flux_metrics", "uptake_flux") for r in
          results_dict.values()],
         "Uptake flux by configuration", "∫μc ds")
    avg = []
    for r in results_dict.values():
        a = _get(r, "mass_metrics", "average_concentration")
        avg.append(a.get("total") if isinstance(a, dict) else a)
    bars("compare_avg_concentration", avg,
         "Average concentration by configuration", "c̄")
    mue = [_get(r, "mu_eff_comparison", "mu_eff_sim") for r in
           results_dict.values()]
    if any(v is not None for v in mue):
        bars("compare_mu_eff_sim", mue,
             "μ_eff^sim by configuration", "μ_eff")
    plot_flux_comparison(results_dict, plots_dir)
    plot_mu_eff_comparison(results_dict, plots_dir)
    plot_mu_eff_ratios_comparison(results_dict, plots_dir)
    save_summary(results_dict,
                 os.path.join(plots_dir, "comparison_summary.json"))


def plot_aspect_ratio_comparison(results_dict, plots_dir):
    """mu_eff ratios vs aspect ratio line plot (ref plotting.py:953-1090)."""
    os.makedirs(plots_dir, exist_ok=True)
    pts = []
    for name, r in results_dict.items():
        ar = _get(r, "aspect_ratio") or _get(r, "aspect_ratio_metadata",
                                             "aspect_ratio")
        ratio = _get(r, "mu_eff_comparison", "ratios", "sim")
        if ar is not None and ratio is not None:
            pts.append((ar, ratio, name))
    if not pts:
        return
    pts.sort()
    with safe_plot(os.path.join(plots_dir,
                                "aspect_ratio_comparison")) as (fig, ax):
        ars = [p[0] for p in pts]
        ratios = [p[1] for p in pts]
        ax.semilogx(ars, ratios, "o-")
        ax.axhline(1.0, color="gray", lw=0.6, ls="--")
        ax.set_xlabel("aspect ratio h/w")
        ax.set_ylabel(r"$\mu_{\mathrm{eff}}^{sim}/\mu$")


def save_summary(results_dict, path):
    """JSON summary of key metrics across configs (ref plotting.py:1096-1143)."""
    summary = {}
    for name, r in results_dict.items():
        if r is None:
            summary[name] = None
            continue
        avg = _get(r, "mass_metrics", "average_concentration")
        summary[name] = {
            "total_mass": _get(r, "mass_metrics", "total_mass"),
            "average_concentration": (avg.get("total")
                                      if isinstance(avg, dict) else avg),
            "uptake_flux": _get(r, "flux_metrics", "uptake_flux"),
            "mu_eff_sim": _get(r, "mu_eff_comparison", "mu_eff_sim"),
            "mu_eff_arc": _get(r, "mu_eff_comparison", "mu_eff_arc"),
            "mu_eff_enh": _get(r, "mu_eff_comparison", "mu_eff_enh"),
            "mu_eff_open": _get(r, "mu_eff_comparison", "mu_eff_open"),
        }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary
