"""Host Otsu thresholds (a copy of the JAX package's metrics/otsu_np.py,
which the port may not import)."""
from __future__ import annotations

import numpy as np


def otsu_np(x: np.ndarray) -> float:
    """STOtsu over unit-width integer bins spanning [min, max]."""
    mn, mx = float(x.min()), float(x.max())
    if mn == mx:
        return mn
    bins = int(mx - mn + 1)
    centers = np.arange(mn, mx + 1, dtype=np.float64)
    hist, _ = np.histogram(x.ravel(), bins=bins, range=(mn, mx))
    hist = hist.astype(np.float64)
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        m1 = np.cumsum(hist * centers) / w1
        m2 = (np.cumsum((hist * centers)[::-1]) / np.cumsum(hist[::-1]))[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    var12 = np.nan_to_num(var12, nan=-np.inf)
    return float(centers[:-1][int(np.argmax(var12))])


def otsu_skimage_np(x: np.ndarray) -> float:
    """skimage.filters.threshold_otsu(image, nbins=256): 256 uniform bins
    over [min, max], threshold = centre of the argmax inter-class-variance
    bin; min == max returns 0.0."""
    x = np.asarray(x, np.float64).ravel()
    if x.min() == x.max():
        return 0.0
    counts, bin_edges = np.histogram(x, bins=256)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2.0
    counts = counts.astype(np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / w1
    m2 = (np.cumsum((counts * centers)[::-1]) / np.cumsum(counts[::-1]))[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[:-1][int(np.argmax(var12))])
