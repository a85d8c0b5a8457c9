"""Graph container and host-side graph algorithm tests (dense oracles)."""
import numpy as np
import pytest

from sgp.graph import (Graph, add_self_loops, coalesce, k_hop_subgraph,
                       normalize_adj, remove_self_loops, spgemm,
                       to_undirected, transpose, weighted_degree)
from sgp.graph.similarities import (correntropy, gaussian_kernel,
                                    geographical_distance,
                                    pearson_similarity, top_k)


def random_graph(rng, n=23, e=80):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return coalesce(Graph(src, dst, w, n))


def test_dense_roundtrip(rng):
    g = random_graph(rng)
    d = g.to_dense()
    g2 = Graph.from_dense(d)
    np.testing.assert_allclose(g2.to_dense(), d)


def test_transpose(rng):
    g = random_graph(rng)
    np.testing.assert_allclose(transpose(g).to_dense(), g.to_dense().T)


def test_to_undirected(rng):
    g = random_graph(rng)
    np.testing.assert_allclose(to_undirected(g).to_dense(),
                               g.to_dense() + g.to_dense().T, rtol=1e-6)


def test_self_loops(rng):
    g = random_graph(rng)
    d = add_self_loops(g).to_dense()
    np.testing.assert_allclose(np.diag(d), np.ones(g.num_nodes))
    off = g.to_dense().copy()
    np.fill_diagonal(off, 0)
    dd = d.copy()
    np.fill_diagonal(dd, 0)
    np.testing.assert_allclose(dd, off)
    d2 = remove_self_loops(add_self_loops(g)).to_dense()
    assert np.diag(d2).sum() == 0


def test_row_normalize(rng):
    g = random_graph(rng)
    d = normalize_adj(g, "row").to_dense()
    rs = d.sum(1)
    nonzero = g.to_dense().sum(1) > 0
    np.testing.assert_allclose(rs[nonzero], 1.0, rtol=1e-5)
    assert np.all(rs[~nonzero] == 0)


def test_sym_normalize(rng):
    g = to_undirected(random_graph(rng))
    a = g.to_dense()
    deg = a.sum(1)
    inv = np.where(deg > 0, deg ** -0.5, 0)
    expect = inv[:, None] * a * inv[None, :]
    np.testing.assert_allclose(normalize_adj(g, "sym").to_dense(), expect,
                               rtol=1e-5)


def test_spgemm(rng):
    a, b = random_graph(rng), random_graph(rng)
    np.testing.assert_allclose(spgemm(a, b).to_dense(),
                               a.to_dense() @ b.to_dense(), rtol=1e-5)


def test_weighted_degree(rng):
    g = random_graph(rng)
    np.testing.assert_allclose(weighted_degree(g, "in"),
                               g.to_dense().sum(1), rtol=1e-6)
    np.testing.assert_allclose(weighted_degree(g, "out"),
                               g.to_dense().sum(0), rtol=1e-6)


def test_k_hop_subgraph():
    # path graph 0->1->2->3->4 (operator direction: dst gets src features)
    g = Graph(np.array([0, 1, 2, 3]), np.array([1, 2, 3, 4]), None, 5)
    # who feeds node 4 within 2 hops: {2, 3, 4}
    nodes, sub, root_pos = k_hop_subgraph(g, np.array([4]), k=2)
    assert set(nodes.tolist()) == {2, 3, 4}
    assert nodes[root_pos[0]] == 4
    assert sub.num_edges == 2  # 2->3, 3->4 relabeled


def test_bsr_packing(rng):
    g = random_graph(rng, n=300, e=2000)
    blocks, cols, ptr = g.to_bsr(128)
    # reconstruct dense from BSR
    n_pad = (ptr.shape[0] - 1) * 128
    dense = np.zeros((n_pad, n_pad), np.float32)
    for r in range(len(ptr) - 1):
        for i in range(ptr[r], ptr[r + 1]):
            c = cols[i]
            dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = blocks[i]
    np.testing.assert_allclose(dense[:300, :300], g.to_dense(), rtol=1e-6)


def test_gaussian_kernel():
    x = np.array([[0., 1.], [1., 0.]])
    w = gaussian_kernel(x, theta=1.0)
    np.testing.assert_allclose(w, np.exp(-x ** 2))


def test_geographical_distance():
    # ~111 km per degree of latitude at the equator
    pts = np.array([[0.0, 0.0], [1.0, 0.0]])
    d = geographical_distance(pts)
    assert abs(d[0, 1] - 111.19) < 0.5
    assert d[0, 0] == 0


def test_pearson_similarity(rng):
    x = rng.random((5, 50))
    sim = pearson_similarity(x)
    expect = np.corrcoef(x)
    np.testing.assert_allclose(sim, expect, atol=1e-5)


def test_correntropy_shape(rng):
    x = rng.random((40, 6))
    sim = correntropy(x, period=10)
    assert sim.shape == (6, 6)
    np.testing.assert_allclose(sim, sim.T, atol=1e-12)


def test_top_k():
    m = np.array([[0.9, 0.5, 0.1], [0.2, 0.8, 0.3], [0.1, 0.2, 0.9]])
    r = top_k(m, 1, include_self=True, keep_values=True)
    np.testing.assert_allclose(r, np.diag([0.9, 0.8, 0.9]))
    r2 = top_k(m, 1, include_self=False)
    assert r2[0, 1] == 1 and r2[0, 0] == 0


def test_rcm_reordering_reduces_blocks(rng):
    """RCM ordering concentrates a geometric graph's edges near the
    diagonal -> fewer 128-blocks for the BSR SpMM to touch."""
    from sgp.graph.sparse import permute_nodes, rcm_order
    from sgp.graph.similarities import top_k
    n = 512
    pos = rng.random((n, 2)).astype(np.float32)
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    sim = np.exp(-d2 / 0.01)
    np.fill_diagonal(sim, 0)
    adj = top_k(sim, 10, include_self=True, keep_values=True)
    g = coalesce(Graph.from_dense(adj))
    perm = rcm_order(g)
    gp = permute_nodes(g, perm)
    _, cols_orig, _ = g.to_bsr(64)
    _, cols_rcm, _ = gp.to_bsr(64)
    assert len(cols_rcm) < len(cols_orig)
    # permutation preserves the graph: propagation results map back
    x = rng.standard_normal((n, 4)).astype(np.float32)
    out = g.to_dense() @ x
    out_p = gp.to_dense() @ x[perm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    np.testing.assert_allclose(out_p[inv], out, atol=1e-4)


def test_auto_band_localized_vs_shuffled():
    """auto_band returns variable-width windows for a banded (road)
    labeling and None for a shuffled one (no locality to exploit) or
    past the host-densify node guard."""
    from sgp.graph.sparse import auto_band, band_graph

    g = band_graph(2000, 4)
    band = auto_band(g, block=128)
    assert band is not None and isinstance(band[1], tuple)
    assert max(band[1]) < 2000 / 2
    # shuffled labels: same graph, no band structure
    rng = np.random.default_rng(0)
    perm = rng.permutation(2000)
    from sgp.graph.sparse import Graph
    g2 = Graph(perm[g.src], perm[g.dst], g.weight, 2000)
    assert auto_band(g2, block=128) is None
    assert auto_band(g, max_nodes=100) is None
    # stored zero weights are structure, not edges
    w = np.zeros(g.num_edges, np.float32)
    g3 = Graph(g.src, g.dst, w, 2000)
    b3 = auto_band(g3, block=128)
    assert b3 is not None and max(b3[1]) == 128   # empty windows
