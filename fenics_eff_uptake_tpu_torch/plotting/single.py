"""Per-run figures (counterpart of ``plotting/single.py``; the reference's
plotting.py:291-772), written by ``run_simulation(plot=True)``.

The JAX package's figure set and file names: mesh, concentration and
velocity-magnitude fields, flux bars (overview, external breakdown,
physical against Robin, sulcus segments, consistency check, segment
ratios, uptake segments), mass by region and the mu_eff estimators.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.vtk import vertex_values
from .style import Config, add_value_labels, latexify_label, safe_plot

__all__ = ["plot_single_simulation"]


def _bar(ax, labels, values, colors=None, title="", ylabel="",
         label_mode="dual"):
    x = np.arange(len(labels))
    vals = [v if (v is not None and np.isfinite(v)) else 0.0
            for v in values]
    ax.bar(x, vals, color=colors)
    ax.set_xticks(x)
    ax.set_xticklabels([latexify_label(l) for l in labels], rotation=30,
                       ha="right")
    ax.set_title(latexify_label(title))
    ax.set_ylabel(latexify_label(ylabel))
    ax.axhline(0, color="k", lw=0.5)
    add_value_labels(ax, mode=label_mode)


def plot_single_simulation(results, plots_dir):
    """Every per-run figure of a ``run_simulation`` results dict into
    ``plots_dir`` (ref plotting.py:758-772)."""
    import matplotlib.tri as mtri

    os.makedirs(plots_dir, exist_ok=True)
    mesh = results["mesh_results"]["mesh"]
    c = results["c"]
    u = results.get("u")
    tri = mtri.Triangulation(mesh.vertices[:, 0], mesh.vertices[:, 1],
                             mesh.cells)

    with safe_plot(os.path.join(plots_dir, "mesh"),
                   figsize=Config.FIGSIZE_WIDE) as (fig, ax):
        ax.triplot(tri, lw=0.2, color="steelblue")
        ax.set_aspect("equal")
        ax.set_title("Mesh")

    with safe_plot(os.path.join(plots_dir, "concentration_field"),
                   figsize=Config.FIGSIZE_WIDE) as (fig, ax):
        tc = ax.tripcolor(tri, vertex_values(c), shading="gouraud",
                          cmap=Config.CMAP_FIELD)
        fig.colorbar(tc, ax=ax, label="c")
        ax.set_aspect("equal")
        ax.set_title("Concentration")

    if u is not None and np.any(u.as_numpy() != 0):
        with safe_plot(os.path.join(plots_dir, "velocity_field"),
                       figsize=Config.FIGSIZE_WIDE) as (fig, ax):
            umag = np.linalg.norm(vertex_values(u), axis=1)
            tc = ax.tripcolor(tri, umag, shading="gouraud",
                              cmap=Config.CMAP_FIELD)
            fig.colorbar(tc, ax=ax, label="|u|")
            ax.set_aspect("equal")
            ax.set_title("Velocity magnitude")

    fm = results.get("flux_metrics", {})
    pf = fm.get("physical_flux", {})
    walls = ["left", "right", "top", "bottom"]

    with safe_plot(os.path.join(plots_dir, "flux_overview")) as (fig, ax):
        _bar(ax, walls, [pf.get(k, {}).get("total", 0.0) for k in walls],
             title="Physical flux per boundary", ylabel="flux")

    with safe_plot(os.path.join(plots_dir,
                                "flux_external_breakdown")) as (fig, ax):
        x = np.arange(len(walls))
        w = 0.38
        dv = [pf.get(k, {}).get("diffusive", 0.0) or 0.0 for k in walls]
        av = [pf.get(k, {}).get("advective", 0.0) or 0.0 for k in walls]
        ax.bar(x - w / 2, dv, w, label="diffusive", color="steelblue")
        ax.bar(x + w / 2, av, w, label="advective", color="darkorange")
        ax.set_xticks(x)
        ax.set_xticklabels(walls)
        ax.axhline(0, color="k", lw=0.5)
        ax.set_title("External flux breakdown")
        ax.set_ylabel("flux")
        ax.legend()
        add_value_labels(ax, mode="sci")

    with safe_plot(os.path.join(plots_dir,
                                "flux_physical_vs_robin")) as (fig, ax):
        _bar(ax, ["physical −D∇c·n", "Robin μc"],
             [pf.get("bottom", {}).get("total", 0.0),
              fm.get("uptake_flux", 0.0)],
             colors=["steelblue", "darkorange"],
             title="Bottom flux: physical vs Robin", ylabel="flux")

    sulc = fm.get("sulcus_specific", {})
    if sulc:
        spf = sulc.get("physical_flux", {})
        with safe_plot(os.path.join(plots_dir,
                                    "flux_sulcus_breakdown")) as (fig, ax):
            labels = ["bottom_left", "sulcus", "bottom_right",
                      "sulcus_opening", "y0_flux"]
            _bar(ax, labels,
                 [spf.get(k, {}).get("total", 0.0) for k in labels],
                 title="Sulcus segment fluxes", ylabel="flux")
        with safe_plot(os.path.join(plots_dir,
                                    "flux_consistency_check")) as (fig, ax):
            _bar(ax, ["y0_flux (one-shot)", "y0_combined (5+7+mouth)"],
                 [spf.get("y0_flux", {}).get("total", 0.0),
                  spf.get("y0_combined", {}).get("total", 0.0)],
                 colors=["seagreen", "slateblue"],
                 title="Flux consistency check", ylabel="flux")
        with safe_plot(os.path.join(plots_dir,
                                    "flux_segment_ratios")) as (fig, ax):
            tot = spf.get("y0_combined", {}).get("total", 0.0)
            labels = ["bottom_left", "sulcus_opening", "bottom_right"]
            vals = [(spf.get(k, {}).get("total", 0.0) / tot
                     if tot not in (0.0, None) else np.nan)
                    for k in labels]
            _bar(ax, labels, vals, label_mode="simple",
                 title="Segment share of y0 flux", ylabel="fraction")
        uf = sulc.get("uptake_flux", {})
        with safe_plot(os.path.join(plots_dir,
                                    "uptake_flux_segments")) as (fig, ax):
            labels = ["bottom_left", "sulcus", "bottom_right", "total"]
            _bar(ax, labels, [uf.get(k, 0.0) for k in labels],
                 title="Robin uptake flux per segment", ylabel="μc flux")

    mm = results.get("mass_metrics", {})
    with safe_plot(os.path.join(plots_dir, "mass_metrics")) as (fig, ax):
        if "sulcus_mass" in mm:
            labels = ["total", "sulcus", "channel"]
            vals = [mm.get("total_mass"), mm.get("sulcus_mass"),
                    mm.get("rectangle_mass")]
        else:
            labels = ["total"]
            vals = [mm.get("total_mass")]
        _bar(ax, labels, vals, title="Mass by region", ylabel="∫c dx")

    me = results.get("mu_eff_comparison")
    if me:
        with safe_plot(os.path.join(plots_dir,
                                    "mu_eff_methods")) as (fig, ax):
            labels = ["sim", "arc", "enh", "open"]
            vals = [me.get(f"mu_eff_{k}") for k in labels]
            _bar(ax, [f"μ_eff^{k}" for k in labels],
                 [v if v is not None else np.nan for v in vals],
                 title="μ_eff estimators", ylabel="μ_eff")
