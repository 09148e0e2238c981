"""Plot styling and figure management (counterpart of
``plotting/style.py``; the reference's plotting.py:21-285).

matplotlib is imported inside the functions (``pyplot``), never when a
module of the port is imported: the machines the port runs on need not
have it, and the studies skip their figures there (``studies.common.
plot_or_skip``).  LaTeX text rendering is used only where a ``latex``
binary exists; otherwise matplotlib's mathtext renders the same labels.

Unlike the JAX package's, ``safe_plot`` lets an error in a figure
propagate (after closing the figure): a plotting bug fails the call
instead of leaving a figure out without a word.
"""

from __future__ import annotations

import os
import shutil
from contextlib import contextmanager

import numpy as np

__all__ = ["Config", "pyplot", "set_style", "safe_plot", "save_figure",
           "latexify_label", "format_filename_value", "format_bar_label",
           "add_value_labels"]


class Config:
    DPI = 300
    FIGSIZE = (8, 5)
    FIGSIZE_WIDE = (12, 5)
    CMAP_FIELD = "viridis"
    SAVE_PDF = True


def pyplot():
    """matplotlib.pyplot on the Agg backend (raises ImportError where
    matplotlib is not installed)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


_STYLE_SET = False


def set_style():
    """Serif / Computer Modern styling (ref plotting.py:35-85)."""
    global _STYLE_SET
    plt = pyplot()
    if _STYLE_SET:
        return
    plt.rcParams.update({
        "font.family": "serif",
        "mathtext.fontset": "cm",
        "text.usetex": shutil.which("latex") is not None,
        "axes.labelsize": 12,
        "axes.titlesize": 13,
        "legend.fontsize": 10,
        "xtick.labelsize": 10,
        "ytick.labelsize": 10,
        "figure.dpi": 100,
        "savefig.dpi": Config.DPI,
        "axes.unicode_minus": False,
    })
    _STYLE_SET = True


def save_figure(fig, path_base):
    """``<path_base>.png`` and, with ``Config.SAVE_PDF``, ``.pdf``."""
    os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
    fig.savefig(path_base + ".png", bbox_inches="tight", dpi=Config.DPI)
    if Config.SAVE_PDF:
        fig.savefig(path_base + ".pdf", bbox_inches="tight")


@contextmanager
def safe_plot(path_base, figsize=None):
    """A styled figure and axes for the body, saved by ``save_figure``
    when the body returns and closed in any case."""
    set_style()
    plt = pyplot()
    fig, ax = plt.subplots(figsize=figsize or Config.FIGSIZE)
    try:
        yield fig, ax
        save_figure(fig, path_base)
    finally:
        plt.close(fig)


def format_bar_label(value, mode="dual"):
    """Bar-label text (ref plotting.py:116-134): 'dual' shows a compact
    decimal with scientific notation beneath it."""
    if not np.isfinite(value) or abs(value) < 1e-12:
        return "0" if mode != "dual" else "0\n(0.0e+00)"
    if mode == "simple":
        return f"{value:.3f}"
    if mode == "sci":
        return f"{value:.2e}"
    if abs(value) >= 1e6 or abs(value) < 1e-3:
        dec = f"{value:.3g}"
    else:
        dec = f"{value:.6f}".rstrip("0").rstrip(".")
    return f"{dec}\n({value:.2e})"


def add_value_labels(ax, mode="dual", rotation=0.0, pad_frac=0.04):
    """Value labels above each bar, the y-limits extended so that none
    clips (ref plotting.py:136-170)."""
    tops = []
    for container in getattr(ax, "containers", []):
        for bar in container:
            if not hasattr(bar, "get_height"):
                continue
            h = bar.get_height()
            if h == 0 or not np.isfinite(h):
                continue
            x = bar.get_x() + bar.get_width() / 2.0
            y0, y1 = ax.get_ylim()
            y = h + 0.02 * (y1 - y0)
            ax.text(x, y, format_bar_label(h, mode), ha="center",
                    va="bottom", rotation=rotation, fontsize=7,
                    fontweight="bold")
            tops.append(y)
    if tops:
        y0, y1 = ax.get_ylim()
        span = max(y1 - y0, 1e-300)
        # two text lines in the 'dual' mode need ~12% of the axis height
        need = max(tops) + (0.12 if mode == "dual" else 0.06) * span \
            + pad_frac * span
        if need > y1:
            ax.set_ylim(y0, need)


def latexify_label(text):
    """Unicode / plain label -> mathtext (ref plotting.py:255-281)."""
    replacements = {
        "μ_eff": r"$\mu_{\mathrm{eff}}$",
        "μ": r"$\mu$",
        "Φ": r"$\Phi$",
        "×": r"$\times$",
    }
    for k, v in replacements.items():
        text = text.replace(k, v)
    return text


def format_filename_value(value):
    """A number as a file-name-safe string (ref plotting.py:249-253)."""
    return f"{value}".replace(".", "p")
