"""ROC / coverage plotting (matplotlib), the reference's R figure layer.

Copy of cuda_satabsearch_tpu/eval/plots.py (that package imports jax).
matplotlib is optional: it is imported only when a plot is drawn, and
``pyplot()`` names it in its error where it is not installed.

Functional equivalent of scripts/plotsearchroc*.r, plotrocs_*.r and the
coverage-vs-errors-per-query plot of fitgumbeldist.r: overlay ROC
curves for one or more methods (each a (scores, labels) result set) and
plot coverage against errors per query.  Output is a static PNG/PDF via
matplotlib's Agg backend; no display needed.

Colors: a fixed categorical assignment (method i always gets slot i),
colorblind-validated palette; identity is also carried by linestyle so
the figure survives grayscale printing.
"""

from __future__ import annotations

import numpy as np

from .roc import roc_curve, auc

# Fixed-order categorical slots (colorblind-validated); methods beyond
# the palette fold into gray.
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
           "#008300"]
_FALLBACK = "#6e6e66"
_INK = "#33322e"
_MUTED = "#6e6e66"
_GRID = "#e4e3dc"
_STYLES = ["-", "--", "-.", ":"]


def pyplot():
    """matplotlib.pyplot on the Agg backend (no display needed)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plots need matplotlib, which is not installed; "
                          "the rest of the evaluation runs without it"
                          ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style_axes(ax, xlabel: str, ylabel: str, title: str | None):
    ax.grid(True, color=_GRID, linewidth=0.8, zorder=0)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_MUTED)
    ax.tick_params(colors=_MUTED, labelsize=9)
    ax.set_xlabel(xlabel, color=_INK, fontsize=10)
    ax.set_ylabel(ylabel, color=_INK, fontsize=10)
    if title:
        ax.set_title(title, color=_INK, fontsize=11, loc="left")


def plot_roc(methods: dict, out_path: str, title: str | None = None,
             log_x: bool = False) -> dict:
    """Overlay ROC curves.

    methods: {label: (scores, labels)} — insertion order fixes each
    method's color slot.  Returns {label: auc}.  log_x mirrors the
    reference's log-scale ROC variants (plotsearchroc.r).
    """
    plt = pyplot()

    fig, ax = plt.subplots(figsize=(5.2, 4.2), dpi=150)
    aucs = {}
    for i, (label, (scores, labels)) in enumerate(methods.items()):
        fpr, tpr = roc_curve(scores, labels)
        a = auc(scores, labels)
        aucs[label] = a
        color = _SERIES[i] if i < len(_SERIES) else _FALLBACK
        ax.plot(fpr, tpr, color=color, linewidth=2,
                linestyle=_STYLES[i % len(_STYLES)],
                label=f"{label} (AUC {a:.3f})", zorder=3)
    ax.plot([1e-6 if log_x else 0, 1], [1e-6 if log_x else 0, 1],
            color=_GRID, linewidth=1, zorder=1)
    if log_x:
        ax.set_xscale("log")
        ax.set_xlim(max(1e-5, 1.0 / max(len(s[0]) for s in
                                        methods.values())), 1)
    else:
        ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    _style_axes(ax, "False positive rate", "True positive rate", title)
    if len(methods) >= 2:
        ax.legend(frameon=False, fontsize=8, labelcolor=_INK,
                  loc="lower right")
    elif methods:
        only = next(iter(aucs))
        ax.set_title(f"{title or only} — AUC {aucs[only]:.3f}",
                     color=_INK, fontsize=11, loc="left")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return aucs


def plot_coverage_epq(methods: dict, out_path: str,
                      title: str | None = None) -> None:
    """Coverage vs errors-per-query (fitgumbeldist.r's acceptance
    figure): at each score threshold, x = false positives per query,
    y = fraction of true positives recovered.

    methods: {label: (scores, labels, nqueries)}.
    """
    plt = pyplot()

    fig, ax = plt.subplots(figsize=(5.2, 4.2), dpi=150)
    for i, (label, (scores, labels, nq)) in enumerate(methods.items()):
        s = np.asarray(scores, float)
        l = np.asarray(labels, int)
        order = np.argsort(-s, kind="stable")
        l = l[order]
        tp = np.cumsum(l)
        fp = np.cumsum(1 - l)
        npos = max(int(l.sum()), 1)
        color = _SERIES[i] if i < len(_SERIES) else _FALLBACK
        ax.plot(fp / max(nq, 1), tp / npos, color=color, linewidth=2,
                linestyle=_STYLES[i % len(_STYLES)], label=label,
                zorder=3)
    ax.set_xscale("log")
    ax.set_ylim(0, 1.02)
    _style_axes(ax, "Errors per query", "Coverage", title)
    if len(methods) >= 2:
        ax.legend(frameon=False, fontsize=8, labelcolor=_INK,
                  loc="lower right")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
