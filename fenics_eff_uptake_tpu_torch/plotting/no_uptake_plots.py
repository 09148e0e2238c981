"""No-uptake study figures: exchange and ratio heatmaps and the profile
grids (counterpart of ``plotting/no_uptake_plots.py``; the reference's
no_uptake_analysis.py:551-915).  Inputs are the study's rows, a ``Table``
or a profile-samples CSV; figures and file names are the JAX package's."""

from __future__ import annotations

import os

import numpy as np

from .phase_b_plots import scatter_heatmap
from .style import format_filename_value, pyplot, save_figure, set_style
from .table import Table

__all__ = ["generate_all_plots", "plot_profiles_grid_from_samples_csv"]

_HEATMAP_COLS = [
    "Mouth E_L1", "Mouth E_avg", "Mouth_Flux_Total",
    "Concentration_Ratio", "Channel_Conc_Ratio", "Intradomain_Enrichment",
]
_VELOCITY_COLS = ["VR_mid_avg", "VR_mid_max", "VR_intradomain_avg",
                  "VR_intradomain_max"]
_W, _D = "Sulcus Width (mm)", "Sulcus Depth (mm)"


def generate_all_plots(rows, plots_dir):
    """Exchange heatmaps per Pe and the velocity-ratio heatmaps at Pe = 1
    (ref :609-641)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    sulc = t.eq("Domain", "sulcus")
    for pe in sulc.unique("Peclet"):
        sub = sulc.eq("Peclet", pe)
        for col in _HEATMAP_COLS:
            if sub.has(col):
                name = (f"heatmap_{col.replace(' ', '_')}_"
                        f"Pe{format_filename_value(pe)}")
                scatter_heatmap(sub, col, os.path.join(plots_dir, name),
                                f"{col} (Pe={pe:g})", x=_W, y=_D)
    pe1 = sulc.where(np.isclose(np.asarray(sulc["Peclet"], dtype=float),
                                1.0))
    for col in _VELOCITY_COLS:
        if len(pe1) and pe1.has(col):
            scatter_heatmap(pe1, col,
                            os.path.join(plots_dir, f"heatmap_{col}_Pe1"),
                            f"{col} (Pe=1)", x=_W, y=_D)


def plot_profiles_grid_from_samples_csv(csv_path, plots_dir=None):
    """The profile grid of one ``profiles_samples_<geometry>.csv`` (one
    panel per line, one curve per Pe, the rectangle's dashed) into
    ``plots_dir`` (default ``Grids/`` beside the CSV).  It reads the CSV
    only: it never simulates (the reference re-runs the rectangle)."""
    t = Table.read_csv(csv_path)
    if plots_dir is None:
        plots_dir = os.path.join(os.path.dirname(csv_path), "Grids")
    os.makedirs(plots_dir, exist_ok=True)
    geom = t["Geometry"][0] if len(t) else "unknown"
    lines = t.unique("LineName")
    pes = t.unique("Peclet")
    has_domain = "Domain" in t
    set_style()
    plt = pyplot()
    fig, axes = plt.subplots(len(lines), 1, figsize=(8, 2.2 * len(lines)),
                             squeeze=False)
    try:
        for i, line in enumerate(lines):
            ax = axes[i][0]
            for pe in pes:
                sel = (t["LineName"] == line) & (t["Peclet"] == pe)
                sub = t.where(sel & (t["Domain"] == "sulcus")
                              if has_domain else sel)
                ln = None
                if len(sub):
                    coord = "x" if sub["LineType"][0] == "horizontal" \
                        else "y"
                    (ln,) = ax.plot(sub[coord], sub["c"], lw=1.0,
                                    label=f"Pe={pe:g}")
                if has_domain:
                    rsub = t.where(sel & (t["Domain"] == "rectangular"))
                    if len(rsub):
                        coord = "x" if rsub["LineType"][0] == \
                            "horizontal" else "y"
                        ax.plot(rsub[coord], rsub["c"], lw=0.9, ls="--",
                                color=(ln.get_color() if ln else None),
                                alpha=0.7, label=f"rect Pe={pe:g}")
            ax.set_ylabel("c")
            ax.set_title(line, fontsize=9)
            if i == 0:
                ax.legend(fontsize=7, ncol=2)
        axes[-1][0].set_xlabel("position")
        fig.tight_layout()
        save_figure(fig, os.path.join(plots_dir, f"profiles_grid_{geom}"))
    finally:
        plt.close(fig)
