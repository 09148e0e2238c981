"""Phase-B scatter 'heatmaps' over (width, depth) per mu (counterpart of
``plotting/phase_b_plots.py``; the reference's
no_advection_analysis_B.py:220-345).  Inputs are the study's rows or a
``Table``; figures and file names are the JAX package's."""

from __future__ import annotations

import os

import numpy as np

from .style import format_filename_value, latexify_label, safe_plot
from .table import Table

__all__ = ["choose_colormap", "create_heatmap", "create_heatmaps"]


def choose_colormap(values):
    """(colormap, centre): diverging about 0 or 1 where the data straddle
    that natural midpoint, sequential otherwise (ref :220-260)."""
    v = np.asarray(values, dtype=float)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return "viridis", None
    if v.min() < 0 < v.max():
        return "RdBu_r", 0.0
    if v.min() < 1 < v.max() and 0.5 < np.nanmedian(v) < 1.5:
        return "RdBu_r", 1.0
    return "viridis", None


def scatter_heatmap(t, col, path_base, title, x="width_mm", y="depth_mm",
                    colorbar_label=None):
    """Rows of ``t`` as discs at (x, y) coloured by ``col``, with a colour
    scale centred where ``choose_colormap`` says."""
    vals = np.asarray(t[col], dtype=float)
    cmap, center = choose_colormap(vals)
    with safe_plot(path_base) as (fig, ax):
        if center is not None:
            r = np.nanmax(np.abs(vals - center)) or 1.0
            vmin, vmax = center - r, center + r
        else:
            vmin = vmax = None
        sc = ax.scatter(t[x], t[y], c=vals, s=160, cmap=cmap, vmin=vmin,
                        vmax=vmax, edgecolors="k", linewidths=0.4)
        fig.colorbar(sc, ax=ax, label=colorbar_label or col)
        ax.set_xlabel("sulcus width (mm)")
        ax.set_ylabel("sulcus depth (mm)")
        ax.set_title(title)


def create_heatmap(rows, value_col, mu, path_base, title=None):
    """One heatmap of ``value_col`` over the rows of mu factor ``mu``."""
    sub = Table.of(rows).eq("mu_factor", mu)
    if not len(sub):
        return
    scatter_heatmap(sub, value_col, path_base,
                    latexify_label(title or f"{value_col} (μ*={mu})"),
                    colorbar_label=latexify_label(value_col))


def create_heatmaps(rows, plots_dir):
    """Every Phase-B heatmap: CR, flux ratio and flux error per mu factor
    (ref :341-345)."""
    t = Table.of(rows)
    os.makedirs(plots_dir, exist_ok=True)
    for mu in t.unique("mu_factor"):
        for col in ("CR", "flux_ratio", "flux_error_pct"):
            if col not in t:
                continue
            name = f"heatmap_{col}_mu{format_filename_value(mu)}"
            create_heatmap(t, col, mu, os.path.join(plots_dir, name))
