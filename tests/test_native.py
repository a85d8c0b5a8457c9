"""Native C++ graph kernels vs the numpy/scipy reference paths."""
import numpy as np
import pytest

from sgp import native
from sgp.graph import Graph, coalesce, k_hop_subgraph, normalize_adj

pytestmark = pytest.mark.skipif(not native.AVAILABLE,
                                reason="native graphcore not built")


def test_native_coalesce_matches_numpy(rng):
    n, e = 500, 5000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    s2, d2, w2 = native.coalesce_edges(src, dst, w, n)
    ref = coalesce(Graph(src, dst, w, n))  # numpy path (e < threshold)
    np.testing.assert_array_equal(s2, ref.src)
    np.testing.assert_array_equal(d2, ref.dst)
    np.testing.assert_allclose(w2, ref.weight, rtol=1e-5)


def test_native_khop_matches_scipy(rng):
    n, e = 400, 3000
    g = Graph(rng.integers(0, n, e), rng.integers(0, n, e), None, n)
    roots = rng.permutation(n)[:10]
    nodes_ref, _, _ = k_hop_subgraph(g, roots, k=2)
    mask = native.khop_mask(g.src, g.dst, n, roots, 2)
    np.testing.assert_array_equal(np.nonzero(mask)[0], nodes_ref)


def test_native_csr_spmm_matches_dense(rng):
    n, e, f = 100, 900, 16
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")
    mat = g.to_scipy()
    x = rng.standard_normal((n, f)).astype(np.float32)
    out = native.csr_spmm(mat.indptr, mat.indices, mat.data, x)
    np.testing.assert_allclose(out, g.to_dense() @ x, atol=1e-4)


def test_native_edge_sampling_unique():
    idx = native.sample_edges_uniform(10000, 500, seed=42)
    assert len(idx) == 500
    assert len(np.unique(idx)) == 500
    assert idx.max() < 10000
    # deterministic given the seed
    idx2 = native.sample_edges_uniform(10000, 500, seed=42)
    np.testing.assert_array_equal(idx, idx2)


def test_large_graph_uses_native_path(rng):
    """Above the threshold the native path kicks in and must agree."""
    n, e = 2000, 150_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    g = coalesce(Graph(src, dst, w, n))  # native (e >= 100k)
    # numpy oracle
    key = dst.astype(np.int64) * n + src
    order = np.argsort(key, kind="stable")
    uniq, first = np.unique(key[order], return_index=True)
    assert g.num_edges == len(uniq)
    np.testing.assert_allclose(g.to_scipy().sum(), w.sum(), rtol=1e-4)
