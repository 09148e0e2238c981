"""Adv-diff validation figures: the flux-error and CR-deviation heatmaps
side by side, and the 3 x 3 grid of step mu(x) profiles (counterpart of
``plotting/adv_diff_plots.py``; the reference's
adv_diff_analysis.py:308-598).  Inputs are the study's rows or a
``Table``; figures and file names are the JAX package's."""

from __future__ import annotations

import os

import numpy as np

from ..params import StepUptakeOpen
from .style import pyplot, save_figure, set_style
from .table import Table

__all__ = ["create_validation_plots"]


def _pivot(rect, col):
    """(Pe values, mu factors, (Pe, mu) matrix of ``col``) over the
    surrogate rows."""
    pes = rect.unique("Pe")
    mus = rect.unique("mu_factor")
    M = np.full((len(pes), len(mus)), np.nan)
    for i, pe in enumerate(pes):
        for j, mf in enumerate(mus):
            sel = rect.where((rect["Pe"] == pe) & (rect["mu_factor"] == mf))
            if len(sel):
                M[i, j] = sel[col][0]
    return pes, mus, M


def _heat(ax, pes, mus, M, title, cmap="RdBu_r", center=0.0):
    r = np.nanmax(np.abs(M - center)) or 1.0
    im = ax.imshow(M, cmap=cmap, vmin=center - r, vmax=center + r,
                   origin="lower", aspect="auto")
    ax.set_xticks(range(len(mus)))
    ax.set_xticklabels([f"{m:g}" for m in mus])
    ax.set_yticks(range(len(pes)))
    ax.set_yticklabels([f"{p:g}" for p in pes])
    ax.set_xlabel(r"$\mu$ factor")
    ax.set_ylabel("Pe")
    ax.set_title(title)
    for i in range(len(pes)):
        for j in range(len(mus)):
            if np.isfinite(M[i, j]):
                ax.text(j, i, f"{M[i, j]:.3g}", ha="center", va="center",
                        fontsize=9)
    return im


def _first(t, col, default):
    """The column's first present value, or ``default``."""
    if not t.has(col):
        return default
    return float(t[col][t.notna(col)][0])


def create_validation_plots(rows, plots_dir):
    """``validation_heatmaps`` and ``mu_step_profiles_grid`` (.png and
    .pdf) into ``plots_dir``."""
    t = Table.of(rows)
    set_style()
    plt = pyplot()
    os.makedirs(plots_dir, exist_ok=True)
    rect = t.eq("domain_type", "rectangular")

    # the error heatmaps (ref :500-598)
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    try:
        pes, mus, E = _pivot(rect, "flux_error_pct")
        im0 = _heat(axes[0], pes, mus, E, "Step-surrogate flux error (%)")
        fig.colorbar(im0, ax=axes[0])
        pes, mus, C = _pivot(rect, "CR")
        im1 = _heat(axes[1], pes, mus, (C - 1.0) * 100,
                    "CR deviation from 1 (%)")
        fig.colorbar(im1, ax=axes[1])
        fig.tight_layout()
        save_figure(fig, os.path.join(plots_dir, "validation_heatmaps"))
    finally:
        plt.close(fig)

    # the mu(x) grid: rows mu factor, columns Pe (ref :308-470)
    if not len(rect):
        return
    pes = rect.unique("Pe")
    mfs = rect.unique("mu_factor")
    fig, axes = plt.subplots(len(mfs), len(pes),
                             figsize=(4 * len(pes), 2.8 * len(mfs)),
                             squeeze=False)
    try:
        sulc = t.eq("domain_type", "sulcus")
        L = _first(sulc, "Domain_Length_mm", 10.0)
        w = _first(sulc, "Sulcus_Width_mm", 0.5)
        xL, xR = L / 2 - w / 2, L / 2 + w / 2
        xs = np.linspace(0, L, 1500)
        # zoomed to the mouth with a 0.5 mm margin (ref zoom='mouth')
        x_lo, x_hi = max(0.0, xL - 0.5), min(L, xR + 0.5)
        handles = labels = None
        for i, mf in enumerate(mfs):
            row_vals = [float(mf)]
            for j, pe in enumerate(pes):
                ax = axes[i][j]
                sel = rect.where((rect["Pe"] == pe)
                                 & (rect["mu_factor"] == mf))
                if not len(sel):
                    ax.text(0.5, 0.5, "No data", ha="center",
                            va="center", transform=ax.transAxes)
                    continue
                step = StepUptakeOpen(mf, sel["mu_eff_open"][0], xL, xR,
                                      L_c=0.1 * w)
                vals = step(xs)
                ax.plot(xs, vals, lw=1.4, label=r"Step $\mu(x)$")
                ax.axhline(mf, color="gray", lw=1.2, ls=":",
                           label=r"Baseline $\mu$")
                ax.axvspan(xL, xR, alpha=0.15, color="gray")
                ax.set_xlim(x_lo, x_hi)
                ax.grid(True, alpha=0.3)
                if i == 0:
                    ax.set_title(f"Pe = {pe:g}", fontsize=10)
                ax.set_xlabel("x")
                if j == 0:
                    ax.set_ylabel(rf"$\mu={mf:g}$" "\n" r"$\mu(x)$")
                row_vals += [float(np.min(vals)), float(np.max(vals))]
                handles, labels = ax.get_legend_handles_labels()
            if len(row_vals) > 1:
                # one y-range per row (ref :427-441)
                lo, hi = min(row_vals), max(row_vals)
                pad = 0.05 * max(hi - lo, 1e-12)
                for ax in axes[i]:
                    ax.set_ylim(lo - pad, hi + pad)
        if handles:
            fig.legend(handles, labels, loc="lower center",
                       ncol=len(labels), fontsize=9,
                       bbox_to_anchor=(0.5, -0.02))
        fig.tight_layout()
        save_figure(fig, os.path.join(plots_dir, "mu_step_profiles_grid"))
    finally:
        plt.close(fig)
