"""Clustering quality metrics (numpy only). NMI follows Strehl & Ghosh (sqrt
normalization), the metric the paper reports in Tables 2-3."""
from __future__ import annotations

import numpy as np


def contingency(labels_a, labels_b) -> np.ndarray:
    a = np.asarray(labels_a).astype(np.int64).ravel()
    b = np.asarray(labels_b).astype(np.int64).ravel()
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same length")
    ka, kb = int(a.max()) + 1, int(b.max()) + 1
    M = np.zeros((ka, kb), np.float64)
    np.add.at(M, (a, b), 1.0)
    return M


def nmi(labels_a, labels_b) -> float:
    """Normalized mutual information, I(U;V) / sqrt(H(U) H(V)), in [0, 1]."""
    M = contingency(labels_a, labels_b)
    n = M.sum()
    if n == 0:
        return 0.0
    pij = M / n
    pi = pij.sum(1, keepdims=True)
    pj = pij.sum(0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pi @ pj)[nz])).sum())
    hu = float(-(pi[pi > 0] * np.log(pi[pi > 0])).sum())
    hv = float(-(pj[pj > 0] * np.log(pj[pj > 0])).sum())
    denom = np.sqrt(hu * hv)
    # Rounding can carry a perfect match a few ulps past 1.
    return float(np.clip(mi / denom, 0.0, 1.0)) if denom > 0 else 0.0
