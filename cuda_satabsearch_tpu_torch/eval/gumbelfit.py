"""MLE Gumbel fitting of score distributions.

Copy of cuda_satabsearch_tpu/eval/gumbelfit.py (that package imports jax).

Reimplements the parameter-estimation core of the reference's
scripts/fitgumbeldist.r (evir::gumbel MLE on .slrtab scores): the
location ``a`` and scale ``b`` feed stats.gumbel.z_gumbel the same way
(mu = a + b*gamma, sigma = pi/sqrt(6)*b, gumbelstats.c:50-58).  The
reference's shipped constants were fit on the query200 benchmark at
4096 restarts (gumbelstats.h:21-23).
"""

from __future__ import annotations

import numpy as np


def fit_gumbel(scores) -> tuple[float, float]:
    """MLE fit of a right-skewed Gumbel; returns (a, b) = (loc, scale).

    Uses scipy when available, else a Newton iteration on the standard
    Gumbel MLE equations.
    """
    x = np.asarray(scores, dtype=np.float64)
    try:
        from scipy import stats

        loc, scale = stats.gumbel_r.fit(x)
        return float(loc), float(scale)
    except ImportError:  # pragma: no cover
        return _fit_gumbel_newton(x)


def _fit_gumbel_newton(x: np.ndarray, tol: float = 1e-10,
                       maxit: int = 200) -> tuple[float, float]:
    """Solve the Gumbel MLE scale equation
    b = mean(x) - sum(x*exp(-x/b))/sum(exp(-x/b)) by fixed point +
    bisection-safe Newton, then a = -b*log(mean(exp(-x/b)))."""
    xbar = x.mean()
    b = x.std() * np.sqrt(6.0) / np.pi or 1.0

    def g(b):
        w = np.exp(-(x - x.max()) / b)  # shifted for stability
        return xbar - (x * w).sum() / w.sum() - b

    for _ in range(maxit):
        h = b * 1e-6
        d = (g(b + h) - g(b - h)) / (2 * h)
        step = g(b) / d if d != 0 else 0.0
        bn = b - step
        if bn <= 0:
            bn = b / 2.0
        if abs(bn - b) < tol * max(1.0, b):
            b = bn
            break
        b = bn
    a = -b * np.log(np.mean(np.exp(-x / b)))
    return float(a), float(b)


def fit_from_slrtab(fh, label: int | None = 0) -> tuple[float, float]:
    """Fit from a .slrtab stream of 'score label' lines; by default use
    the label==0 (different-fold) scores like fitgumbeldist.r's null
    distribution fit.  label=None uses all scores."""
    scores = []
    for line in fh:
        parts = line.split()
        if len(parts) < 2 or parts[0].startswith("#"):
            continue
        s, l = float(parts[0]), int(parts[1])
        if label is None or l == label:
            scores.append(s)
    return fit_gumbel(scores)
