"""Similarity / distance matrices for graph construction.

Host-side numpy re-implementation of the reference's
``tsl/ops/similarities.py`` (gaussian kernel, haversine geographical
distance, top-k sparsification, pearson, correntropy) without the sklearn
dependency — all pairwise kernels are written directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sgp import epsilon

_AVG_EARTH_RADIUS_KM = 6371.0088


def gaussian_kernel(x: np.ndarray, theta: Optional[float] = None
                    ) -> np.ndarray:
    """``exp(-(x/theta)^2)``; ``theta`` defaults to ``std(x)``
    (``tsl/ops/similarities.py:58-62``)."""
    if theta is None:
        theta = np.std(x)
    return np.exp(-np.square(x / theta))


def thresholded_gaussian_kernel(x: np.ndarray, theta: Optional[float] = None,
                                threshold: Optional[float] = None,
                                threshold_on_input: bool = False
                                ) -> np.ndarray:
    """Gaussian kernel with small weights (or large inputs) zeroed out
    (``tsl/ops/similarities.py:125-133`` behavior)."""
    weights = gaussian_kernel(x, theta)
    if threshold is None:
        return weights
    keep = (x <= threshold) if threshold_on_input else (weights >= threshold)
    return np.where(keep, weights, 0.0)


def geographical_distance(latlon: np.ndarray, to_rad: bool = True
                          ) -> np.ndarray:
    """Pairwise haversine distance in km for ``[N, 2]`` (lat, lon) points
    (``tsl/ops/similarities.py:65-101``)."""
    x = np.asarray(latlon, np.float64)
    if to_rad:
        x = np.radians(x)
    lat, lon = x[:, 0], x[:, 1]
    dlat = lat[:, None] - lat[None, :]
    dlon = lon[:, None] - lon[None, :]
    a = (np.sin(dlat / 2) ** 2
         + np.cos(lat)[:, None] * np.cos(lat)[None, :]
         * np.sin(dlon / 2) ** 2)
    return 2 * _AVG_EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def pearson_similarity(x: np.ndarray) -> np.ndarray:
    """Pearson correlation between rows of ``x [N, T]``
    (``tsl/ops/similarities.py:8-21``); unit diagonal."""
    xc = x - x.mean(1, keepdims=True)
    norms = np.linalg.norm(xc, axis=1)
    corr = (xc @ xc.T) / (norms[:, None] * norms[None, :] + 1e-8)
    np.fill_diagonal(corr, 1.0)
    return corr


def _rbf_kernel(x: np.ndarray, gamma: float) -> np.ndarray:
    """Pairwise ``exp(-gamma * ||xi - xj||^2)`` between rows of ``x``."""
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return np.exp(-gamma * np.maximum(d2, 0.0))


def correntropy(x: np.ndarray, period: int,
                mask: Optional[np.ndarray] = None,
                gamma: float = 0.05) -> np.ndarray:
    """Windowed correntropy similarity between the ``N`` columns of
    ``x [T, N]`` (``tsl/ops/similarities.py:24-55``): accumulate an RBF
    kernel over non-overlapping windows of length ``period``, masking
    windows with missing values, and average."""
    n = x.shape[1]
    if mask is None:
        mask = ~np.isnan(x)
    mask = np.asarray(mask).reshape(len(x), n).astype(bool)
    # trim to whole windows, then walk [n_win, period, N] chunk by chunk
    # (the reference's range(period, T, period) drops the window ending
    # exactly at T, hence the -1)
    n_win = max((len(x) - 1) // period, 0)
    chunks = np.nan_to_num(x[:n_win * period]).reshape(n_win, period, n)
    valid = mask[:n_win * period].reshape(n_win, period, n).all(axis=1)
    sim = np.zeros((n, n))
    tot = np.zeros((n, n))
    for chunk, ok in zip(chunks, valid):
        pair_ok = np.outer(ok, ok).astype(np.float64)
        sim += _rbf_kernel(chunk.T, gamma=gamma) * pair_ok
        tot += pair_ok
    return sim / (tot + epsilon)


def top_k(matrix: np.ndarray, k: int, include_self: bool = False,
          keep_values: bool = False) -> np.ndarray:
    """Keep the top-``k`` entries of each row, zeroing the rest
    (``tsl/ops/similarities.py:104-122`` behavior).

    Builds a boolean keep-mask from the per-row top-``k`` column set;
    with ``include_self=False`` the diagonal is forced below every
    candidate so a node never selects itself.
    """
    n_rows, n_cols = matrix.shape
    scores = np.array(matrix, dtype=np.float64, copy=True)
    if not include_self:
        assert n_rows == n_cols, "self-exclusion needs a square matrix"
        scores[np.diag_indices(n_rows)] = -np.inf
    keep = np.zeros_like(scores, dtype=bool)
    topk_cols = np.argpartition(scores, n_cols - k, axis=1)[:, n_cols - k:]
    np.put_along_axis(keep, topk_cols, True, axis=1)
    if keep_values:
        return np.where(keep, matrix, 0).astype(matrix.dtype)
    return keep.astype(matrix.dtype)
