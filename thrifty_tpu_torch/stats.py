"""Statistical utilities."""

from __future__ import annotations

import numpy as np


def is_outlier(points: np.ndarray, thresh: float = 3.5) -> np.ndarray:
    """Modified-z-score (MAD-based) outlier mask.

    A point is an outlier when 0.6745*|x - median| / MAD > thresh
    (Iglewicz & Hoaglin; reference thrifty/stat_tools.py:8-41).
    """
    points = np.asarray(points, dtype=np.float64)
    if points.ndim == 1:
        points = points[:, None]
    median = np.median(points, axis=0)
    diff = np.sqrt(np.sum((points - median) ** 2, axis=-1))
    mad = np.median(diff)
    if mad == 0:
        # Reference semantics (inf/nan arithmetic): a point AT the
        # median scores 0/0=nan (not an outlier), any deviating point
        # scores inf (outlier).  Returning all-False here would keep a
        # wild point exactly when it is most obvious -- one corrupt
        # record among otherwise identical/quantized beacon SDOAs
        # would poison the fitted clock model.
        return diff > 0
    return 0.6745 * diff / mad > thresh


def lowess(x, y, frac: float = 0.025, min_points: int = 3):
    """Locally weighted linear regression (tricube weights).

    Self-contained stand-in for statsmodels' lowess (used by the
    reference's scripts/reldist_nearest.py:224 to overlay a smoothed
    trend); single robustness pass omitted (it=0 there too).  Returns
    the smoothed y aligned to the INPUT order of x (callers overlay it
    directly against their own x array).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    order = np.argsort(x)
    xs, ys = x[order], y[order]
    n = len(xs)
    k = max(int(np.ceil(frac * n)), min_points)
    k = min(k, n)
    out = np.empty(n)
    for i in range(n):
        lo = np.clip(i - k // 2, 0, n - k)
        xi, yi = xs[lo:lo + k], ys[lo:lo + k]
        d = np.abs(xi - xs[i])
        dmax = d.max()
        w = (1 - (d / dmax) ** 3) ** 3 if dmax > 0 else np.ones_like(d)
        sw = w.sum()
        xm = (w * xi).sum() / sw
        ym = (w * yi).sum() / sw
        cov = (w * (xi - xm) * (yi - ym)).sum()
        var = (w * (xi - xm) ** 2).sum()
        slope = cov / var if var > 0 else 0.0
        out[i] = ym + slope * (xs[i] - xm)
    smoothed = np.empty(n)
    smoothed[order] = out
    return smoothed
