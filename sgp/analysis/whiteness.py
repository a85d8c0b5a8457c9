"""AZ-whiteness test for forecast residuals on spatiotemporal graphs.

Re-derivation of ``tsl/ops/test.py:81-288`` (Zambon & Alippi, "AZ-
whiteness test", NeurIPS 2022): a sign-based statistic over spatial
(graph) and temporal (serial) edges of the residual signal, normally
distributed under the null of uncorrelated noise. Host-side numpy — it
is an offline analysis of residuals, not a training op.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
from scipy import special

from sgp.graph.sparse import Graph, coalesce, remove_self_loops


@dataclasses.dataclass
class AZWhitenessTestResult:
    statistic: float
    pvalue: float


@dataclasses.dataclass
class AZWhitenessMultiTestResult:
    statistic: float
    pvalue: float
    componentwise_tests: List[AZWhitenessTestResult]


def _pval(c: float) -> float:
    """Two-sided standard-gaussian p-value."""
    return 2.0 * (1.0 - 0.5 * (1.0 + special.erf(abs(c) / np.sqrt(2.0))))


def _undirected_no_loops(edge_index: np.ndarray,
                         edge_weight: np.ndarray):
    """Symmetrize (each undirected edge kept once per direction, weights
    averaged for duplicates) and drop self-loops, as the reference's
    ``_to_undirected_no_selfloops``."""
    g = Graph(edge_index[0], edge_index[1], edge_weight,
              int(edge_index.max()) + 1)
    g = remove_self_loops(coalesce(g, reduce="max"))
    # add reverse edges not present
    both = coalesce(Graph(
        np.concatenate([g.src, g.dst]),
        np.concatenate([g.dst, g.src]),
        np.concatenate([g.weight, g.weight]), g.num_nodes), reduce="max")
    return np.stack([both.src, both.dst]), both.weight


def az_whiteness_test(x: np.ndarray,
                      edge_index: np.ndarray,
                      mask: Optional[np.ndarray] = None,
                      edge_weight: Union[np.ndarray, float, None] = None,
                      edge_weight_temporal: Optional[float] = None,
                      lamb: float = 0.5,
                      multivariate: bool = False,
                      remove_median: bool = False
                      ) -> Union[AZWhitenessTestResult,
                                 AZWhitenessMultiTestResult]:
    """Run the test on residuals ``x [T, N, F]`` over the static spatial
    topology ``edge_index [2, E]``."""
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        x = x[..., None]
    if remove_median:
        x_ = x.copy()
        if mask is not None:
            x_[~np.asarray(mask, bool)] = np.nan
        x = x - np.nanmedian(x_, axis=-1, keepdims=True)
    f = x.shape[-1]
    if f == 1:
        multivariate = True
    if multivariate:
        return _az_test(x, mask, edge_index, edge_weight,
                        edge_weight_temporal, lamb)
    res = [_az_test(x[..., i:i + 1],
                    None if mask is None else
                    np.asarray(mask)[..., i:i + 1],
                    edge_index, edge_weight, edge_weight_temporal, lamb)
           for i in range(f)]
    c_multi = float(np.sum([r.statistic for r in res]) / np.sqrt(len(res)))
    return AZWhitenessMultiTestResult(c_multi, _pval(c_multi), res)


def _az_test(x, mask, edge_index, edge_weight, edge_weight_temporal,
             lamb) -> AZWhitenessTestResult:
    t, n, f = x.shape
    edge_index = np.asarray(edge_index)
    if edge_weight is None:
        edge_weight = 1.0
    if np.isscalar(edge_weight):
        edge_weight = float(edge_weight) * np.ones(edge_index.shape[1])
    assert np.all(edge_weight > 0)
    edge_index, edge_weight = _undirected_no_loops(edge_index, edge_weight)

    if mask is None:
        mask = np.ones_like(x)
    mask = np.asarray(mask).astype(int)
    mask_node = mask.max(axis=-1)                       # [T, N]
    x = x * mask
    # masked spatial edges per (t, e)
    edge_valid = (mask_node[:, edge_index[0]]
                  * mask_node[:, edge_index[1]]).astype(bool)   # [T, E]
    w_spatial = float(np.sum(
        np.broadcast_to(edge_weight[None], edge_valid.shape)[
            edge_valid] ** 2))

    if t == 1:
        n_temporal = 0
        edge_weight_temporal = 1.0
    else:
        n_temporal = int((mask[1:] * mask[:-1]).sum())
        if edge_weight_temporal is None or edge_weight_temporal == "auto":
            edge_weight_temporal = float(
                np.sqrt(w_spatial / max(n_temporal, 1)))
    w_temporal = edge_weight_temporal ** 2 * n_temporal

    xxs = (x[:, edge_index[0]] * x[:, edge_index[1]]).sum(-1)  # [T, E]
    xxt = (x[1:] * x[:-1]).sum(-1)                             # [T-1, N]
    c_spatial = float((edge_weight[None] * np.sign(xxs)).sum())
    c_temporal = float(edge_weight_temporal * np.sign(xxt).sum())

    assert 0 <= lamb <= 1
    c_tilde = lamb * c_spatial + (1 - lamb) * c_temporal
    w = lamb ** 2 * w_spatial + (1 - lamb) ** 2 * w_temporal
    c = c_tilde / np.sqrt(max(w, 1e-300))
    return AZWhitenessTestResult(float(c), float(_pval(c)))
