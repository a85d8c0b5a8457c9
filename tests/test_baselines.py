"""Baseline model shape/semantics tests: DCRNN, GWNet, GatedGN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.models.dcrnn import DCRNNModel
from sgp.models.gated_gn import (GatedGraphNetworkConvModel,
                                 GatedGraphNetworkMLPModel)
from sgp.models.graph_layers import (DiffConv, GatedGraphNetwork,
                                     diff_conv_support)
from sgp.models.gwnet import GraphWaveNetModel

pytestmark = pytest.mark.slow


@pytest.fixture
def graph(rng):
    n = 10
    return coalesce(Graph(rng.integers(0, n, 40), rng.integers(0, n, 40),
                          rng.random(40).astype(np.float32), n))


def init_apply(model, *args, **kwargs):
    rng = jax.random.PRNGKey(0)
    params = model.init({"params": rng, "dropout": rng}, *args, **kwargs)
    return params, model.apply(params, *args, **kwargs)


def test_diff_conv_oracle(rng, graph):
    """DiffConv output == Linear(concat[x, A x, A^2 x, A' x, A'^2 x])."""
    sup = diff_conv_support(graph, add_backward=True, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((3, 10, 4)).astype(np.float32))
    m = DiffConv(out_channels=8, k=2)
    params, out = init_apply(m, x, sup)
    assert out.shape == (3, 10, 8)
    a_fwd = np.asarray(sup[0].mat)
    a_bwd = np.asarray(sup[1].mat)
    xs = np.asarray(x)
    feats = [xs]
    for a in (a_fwd, a_bwd):
        cur = xs
        for _ in range(2):
            cur = np.einsum("ij,bjf->bif", a, cur)
            feats.append(cur)
    feats = np.concatenate(feats, -1)
    kernel = np.asarray(params["params"]["Dense_0"]["kernel"])
    bias = np.asarray(params["params"]["Dense_0"]["bias"])
    np.testing.assert_allclose(np.asarray(out), feats @ kernel + bias,
                               atol=1e-4)


def test_gated_gn_layer_aggregates_by_dst(rng):
    n = 6
    # single edge 2 -> 4: only node 4 receives a message
    src = jnp.array([2])
    dst = jnp.array([4])
    x = jnp.asarray(rng.standard_normal((1, n, 8)).astype(np.float32))
    m = GatedGraphNetwork(output_size=8)
    params, out = init_apply(m, x, src, dst)
    assert out.shape == (1, n, 8)
    # removing the edge changes only node 4's output (messages are
    # summed into dst; update MLP sees agg=0 elsewhere)
    out_no = m.apply(params, x, jnp.array([2]), jnp.array([5]))
    diff = np.abs(np.asarray(out) - np.asarray(out_no)).sum(-1)[0]
    assert diff[4] > 0 and diff[5] > 0
    assert np.all(diff[[0, 1, 2, 3]] < 1e-6)


def test_dcrnn_cell_shared_hops_parity(rng, graph):
    """DCRNNCell's shared-SpMM gate computation equals the naive
    three-independent-DiffConv GRU cell (diffusion is channel-separable,
    so sharing the [x,h] hops and reusing the x-block for the candidate
    is exact, not approximate)."""
    from sgp.models.dcrnn import DCRNNCell
    sup = diff_conv_support(graph, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((2, 10, 4)).astype(np.float32))
    h = jnp.asarray(rng.standard_normal((2, 10, 16)).astype(np.float32))
    cell = DCRNNCell(hidden_size=16, k=2)
    params, out = init_apply(cell, x, h, sup)

    def naive(params, x, h, supports):
        xh = jnp.concatenate([x, h], -1)
        p = params["params"]
        dc = DiffConv(out_channels=16, k=2)
        r = jax.nn.sigmoid(dc.apply({"params": p["DiffConv_0"]}, xh,
                                    supports))
        u = jax.nn.sigmoid(dc.apply({"params": p["DiffConv_1"]}, xh,
                                    supports))
        xc = jnp.concatenate([x, r * h], -1)
        c = jnp.tanh(dc.apply({"params": p["DiffConv_2"]}, xc, supports))
        return u * h + (1.0 - u) * c

    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(naive(params, x, h, sup)),
                               atol=1e-5)


def test_dcrnn_model(rng, graph):
    sup = diff_conv_support(graph, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((2, 6, 10, 1)).astype(np.float32))
    u = jnp.asarray(rng.standard_normal((2, 6, 2)).astype(np.float32))
    m = DCRNNModel(hidden_size=16, ff_size=32, output_size=1, horizon=4,
                   n_layers=2, exog_size=2)
    _, out = init_apply(m, x, sup, u=u)
    assert out.shape == (2, 4, 10, 1)


def test_gwnet_model(rng, graph):
    sup = diff_conv_support(graph, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((2, 12, 10, 1)).astype(np.float32))
    m = GraphWaveNetModel(hidden_size=8, ff_size=16, output_size=1,
                          horizon=3, n_layers=4, n_nodes=10,
                          learned_adjacency=True, norm="batch")
    _, out = init_apply(m, x, sup)
    assert out.shape == (2, 3, 10, 1)


def test_gwnet_node_index_subgraph(rng, graph):
    """node_index-aware learned adjacency (lib/nn/models/gwnet_model.py):
    a node-subset batch uses the corresponding embedding rows."""
    sub_nodes = np.array([1, 3, 5, 7])
    sub_g = Graph(np.array([0, 1]), np.array([1, 2]), None, 4)
    sup = diff_conv_support(sub_g, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((2, 12, 4, 1)).astype(np.float32))
    m = GraphWaveNetModel(hidden_size=8, ff_size=16, output_size=1,
                          horizon=3, n_layers=2, n_nodes=10,
                          learned_adjacency=True, norm="layer")
    rngk = jax.random.PRNGKey(0)
    params = m.init({"params": rngk, "dropout": rngk}, x, sup,
                    node_index=jnp.asarray(sub_nodes))
    out = m.apply(params, x, sup, node_index=jnp.asarray(sub_nodes))
    assert out.shape == (2, 3, 4, 1)


def test_gated_gn_mlp_model(rng, graph):
    x = jnp.asarray(rng.standard_normal((2, 12, 10, 1)).astype(np.float32))
    src = jnp.asarray(graph.src.astype(np.int32))
    dst = jnp.asarray(graph.dst.astype(np.int32))
    m = GatedGraphNetworkMLPModel(input_window_size=12, hidden_size=16,
                                  output_size=1, horizon=4, n_nodes=10)
    _, out = init_apply(m, x, src=src, dst=dst)
    assert out.shape == (2, 4, 10, 1)
    # full-graph mode (no edges passed)
    _, out_full = init_apply(m, x)
    assert out_full.shape == (2, 4, 10, 1)


def test_gated_gn_conv_model(rng):
    x = jnp.asarray(rng.standard_normal((2, 25, 6, 1)).astype(np.float32))
    m = GatedGraphNetworkConvModel(input_window_size=25, hidden_size=16,
                                   output_size=1, horizon=4, n_nodes=6)
    _, out = init_apply(m, x)
    assert out.shape == (2, 4, 6, 1)


def test_gated_gn_ell_matches_coo(rng):
    """The scatter-free ELL aggregation (padded_incoming) computes the
    same function as the COO gather/segment-sum path with the SAME
    params (both layouts share the parameter structure)."""
    from sgp.graph.sparse import Graph, coalesce, padded_incoming

    n = 12
    g = coalesce(Graph(rng.integers(0, n, 60).astype(np.int32),
                       rng.integers(0, n, 60).astype(np.int32),
                       None, n))
    x = jnp.asarray(rng.standard_normal((2, n, 8)).astype(np.float32))
    layer = GatedGraphNetwork(output_size=8, sorted_edges=True)
    params = layer.init(jax.random.PRNGKey(0), x,
                        jnp.asarray(g.src), jnp.asarray(g.dst))
    out_coo = layer.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    si, m = padded_incoming(g)
    out_ell = layer.apply(params, x,
                          neigh=(jnp.asarray(si), jnp.asarray(m)))
    np.testing.assert_allclose(np.asarray(out_coo),
                               np.asarray(out_ell), atol=1e-5)


def test_gated_gn_dense_adj_matches_coo(rng):
    """The dense all-pairs matmul aggregation (adj=) computes the same
    function AND gradients as the COO gather/segment-sum path with the
    SAME params (all layouts share the parameter structure). Weighted
    edges count as present (messages are unweighted, like the edge
    path)."""
    from sgp.graph.sparse import Graph, coalesce

    n = 12
    g = coalesce(Graph(rng.integers(0, n, 60).astype(np.int32),
                       rng.integers(0, n, 60).astype(np.int32),
                       rng.random(60).astype(np.float32), n))
    x = jnp.asarray(rng.standard_normal((2, n, 8)).astype(np.float32))
    layer = GatedGraphNetwork(output_size=8, sorted_edges=True)
    params = layer.init(jax.random.PRNGKey(0), x,
                        jnp.asarray(g.src), jnp.asarray(g.dst))
    adj = jnp.asarray(g.to_dense())          # A[dst, src]

    def loss_coo(p):
        return layer.apply(p, x, jnp.asarray(g.src),
                           jnp.asarray(g.dst)).sum()

    def loss_adj(p):
        return layer.apply(p, x, adj=adj).sum()

    out_coo = layer.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    out_adj = layer.apply(params, x, adj=adj)
    np.testing.assert_allclose(np.asarray(out_coo),
                               np.asarray(out_adj), atol=1e-5)
    g_coo = jax.grad(loss_coo)(params)
    g_adj = jax.grad(loss_adj)(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_coo),
                    jax.tree_util.tree_leaves(g_adj)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4)


def test_gated_gn_model_dense_adj_matches_edges(rng):
    """Model-level: GatedGraphNetworkMLPModel(adj=) equals the explicit
    edge-list forward with identical params."""
    from sgp.graph.sparse import Graph, coalesce

    n = 9
    g = coalesce(Graph(rng.integers(0, n, 40).astype(np.int32),
                       rng.integers(0, n, 40).astype(np.int32),
                       None, n))
    x = jnp.asarray(rng.standard_normal((2, 25, n, 1)).astype(np.float32))
    m = GatedGraphNetworkMLPModel(input_window_size=25, hidden_size=16,
                                  output_size=1, horizon=4, n_nodes=n,
                                  sorted_edges=True)
    params = m.init({"params": jax.random.PRNGKey(0)}, x,
                    jnp.asarray(g.src), jnp.asarray(g.dst))
    out_e = m.apply(params, x, jnp.asarray(g.src), jnp.asarray(g.dst))
    out_a = m.apply(params, x, adj=jnp.asarray(g.to_dense()))
    np.testing.assert_allclose(np.asarray(out_e), np.asarray(out_a),
                               atol=1e-5)


def test_gated_gn_model_ell_matches_coo(rng):
    """Model-level: full forward with neigh= equals src/dst ."""
    from sgp.graph.sparse import Graph, coalesce, padded_incoming

    n = 10
    g = coalesce(Graph(rng.integers(0, n, 40).astype(np.int32),
                       rng.integers(0, n, 40).astype(np.int32),
                       None, n))
    x = jnp.asarray(rng.standard_normal((2, 12, n, 1)).astype(np.float32))
    m = GatedGraphNetworkMLPModel(input_window_size=12, hidden_size=16,
                                  output_size=1, horizon=3, n_nodes=n,
                                  enc_layers=1, gnn_layers=2,
                                  sorted_edges=True)
    params = m.init(jax.random.PRNGKey(1), x, src=jnp.asarray(g.src),
                    dst=jnp.asarray(g.dst))
    out_coo = m.apply(params, x, src=jnp.asarray(g.src),
                      dst=jnp.asarray(g.dst))
    si, msk = padded_incoming(g)
    out_ell = m.apply(params, x,
                      neigh=(jnp.asarray(si), jnp.asarray(msk)))
    np.testing.assert_allclose(np.asarray(out_coo),
                               np.asarray(out_ell), atol=1e-5)
