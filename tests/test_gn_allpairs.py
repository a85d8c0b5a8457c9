"""GatedGN dense all-pairs aggregation (the blocked-XLA ``adj=`` path of
``GatedGraphNetwork``) vs a plain-jnp oracle and the edge-list layer.

The layer's aggregated messages are read back through
``apply(..., mutable=["intermediates"])``; the oracle recomputes them
from the same parameters by materializing every ``[N, N]`` pair.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph.sparse import Graph, coalesce
from sgp.models.blocks import get_activation
from sgp.models.graph_layers import GatedGraphNetwork


def gn_allpairs_reference(p_i, p_j, mask, w2, b2, wg, bg,
                          activation: str = "silu"):
    """Pure-jnp oracle (small N only: materializes [B, N, N, h])."""
    act = get_activation(activation)
    s = p_i[..., :, None, :] + p_j[..., None, :, :]
    mb = act(act(s) @ w2 + b2)
    g = jax.nn.sigmoid(mb @ wg + bg)
    keep = (mask != 0).astype(jnp.float32)
    return jnp.einsum("ij,...ijh->...ih", keep,
                      (g * mb).astype(jnp.float32))


def _setup(seed, n=20, b=2, f=8, h=16, activation="silu", dtype=None,
           mask_p=0.3):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((b, n, f)).astype(np.float32))
    adj = jnp.asarray((rng.random((n, n)) < mask_p).astype(np.float32))
    layer = GatedGraphNetwork(output_size=h, activation=activation,
                              dtype=dtype)
    params = layer.init(jax.random.PRNGKey(seed), x, adj=adj)
    return layer, params, x, adj


def layer_aggregate(layer, params, x, **kw):
    _, state = layer.apply(params, x, mutable=["intermediates"], **kw)
    return state["intermediates"]["aggregate"][0]


def oracle_aggregate(params, x, adj, activation="silu"):
    p = params["params"]
    p_i = x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    p_j = x @ p["Dense_1"]["kernel"]
    return gn_allpairs_reference(
        p_i, p_j, adj, p["Dense_2"]["kernel"], p["Dense_2"]["bias"],
        p["Dense_3"]["kernel"], p["Dense_3"]["bias"], activation)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
def test_forward_matches_reference(activation):
    layer, params, x, adj = _setup(0, activation=activation)
    got = layer_aggregate(layer, params, x, adj=adj)
    want = oracle_aggregate(params, x, adj, activation)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_forward_padding_and_masked_rows():
    # n NOT a block multiple and one node with no incoming edges
    layer, params, x, adj = _setup(1, n=13)
    adj = adj.at[5, :].set(0.0)
    got = layer_aggregate(layer, params, x, adj=adj)
    want = oracle_aggregate(params, x, adj)
    assert got.shape == want.shape == (2, 13, 16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got)[:, 5], 0.0, atol=1e-6)


@pytest.mark.parametrize("activation", ["silu", "tanh"])
def test_gradients_match_reference(activation):
    layer, params, x, adj = _setup(2, n=12, b=1, activation=activation)

    def loss_layer(p, x):
        out = layer_aggregate(layer, p, x, adj=adj)
        return jnp.sum(out * jnp.cos(out))   # non-trivial cotangent

    def loss_ref(p, x):
        out = oracle_aggregate(p, x, adj, activation)
        return jnp.sum(out * jnp.cos(out))

    gl = jax.grad(loss_layer, argnums=(0, 1))(params, x)
    gr = jax.grad(loss_ref, argnums=(0, 1))(params, x)
    for name in ("Dense_0", "Dense_1", "Dense_2", "Dense_3"):
        for leaf in gl[0]["params"][name]:
            np.testing.assert_allclose(
                np.asarray(gl[0]["params"][name][leaf]),
                np.asarray(gr[0]["params"][name][leaf]),
                rtol=5e-5, atol=5e-5, err_msg=f"{name}/{leaf}")
    np.testing.assert_allclose(np.asarray(gl[1]), np.asarray(gr[1]),
                               rtol=5e-5, atol=5e-5, err_msg="x")


def test_gradients_under_jit_and_batch():
    layer, params, x, adj = _setup(3, n=9, b=3)

    @jax.jit
    def loss(p, x):
        return jnp.mean(layer_aggregate(layer, p, x, adj=adj) ** 2)

    def loss_ref(p, x):
        return jnp.mean(oracle_aggregate(p, x, adj) ** 2)

    gl = jax.grad(loss, argnums=(0, 1))(params, x)
    gr = jax.grad(loss_ref, argnums=(0, 1))(params, x)
    np.testing.assert_allclose(np.asarray(gl[1]), np.asarray(gr[1]),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(gl[0]["params"]["Dense_2"]["kernel"]),
        np.asarray(gr[0]["params"]["Dense_2"]["kernel"]),
        rtol=5e-5, atol=5e-5)


def test_bf16_messages_close_to_f32_oracle():
    layer, params, x, adj = _setup(4, n=16, dtype=jnp.bfloat16)
    got = layer_aggregate(layer, params, x, adj=adj)
    want = oracle_aggregate(params, x, adj)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0.05, atol=0.05)


def test_layer_allpairs_path_matches_edge_list():
    """GatedGraphNetwork(adj=) (blocked all-pairs) equals the explicit
    edge-list forward/backward with identical params."""
    rng = np.random.default_rng(7)
    n = 12
    g = coalesce(Graph(rng.integers(0, n, 60).astype(np.int32),
                       rng.integers(0, n, 60).astype(np.int32),
                       rng.random(60).astype(np.float32), n))
    x = jnp.asarray(rng.standard_normal((2, n, 8)).astype(np.float32))
    layer = GatedGraphNetwork(output_size=8, sorted_edges=True)
    params = layer.init(jax.random.PRNGKey(0), x,
                        jnp.asarray(g.src), jnp.asarray(g.dst))
    adj = jnp.asarray(g.to_dense())          # A[dst, src]

    out_coo = layer.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    out_ap = layer.apply(params, x, adj=adj)
    np.testing.assert_allclose(np.asarray(out_ap), np.asarray(out_coo),
                               rtol=2e-5, atol=2e-5)

    def loss_ap(p):
        return (layer.apply(p, x, adj=adj) ** 2).sum()

    def loss_coo(p):
        return (layer.apply(p, x, jnp.asarray(g.src),
                            jnp.asarray(g.dst)) ** 2).sum()

    for a, b in zip(jax.tree_util.tree_leaves(jax.grad(loss_ap)(params)),
                    jax.tree_util.tree_leaves(jax.grad(loss_coo)(params))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_layer_banded_allpairs_matches_full_sweep():
    """adj_band (RCM band windows) == the full N^2 sweep == the edge
    list, values AND grads — the windows cover every edge by
    construction."""
    from sgp.graph.sparse import band_windows

    rng = np.random.default_rng(11)
    n = 64
    # banded graph: edges within +-4 of the diagonal (an RCM-like
    # order; rcm_order itself is covered by test_halo)
    src = np.repeat(np.arange(n), 3)
    dst = np.clip(src + rng.integers(-4, 5, len(src)), 0, n - 1)
    g = coalesce(Graph(src.astype(np.int64), dst.astype(np.int64),
                       np.ones(len(src), np.float32), n))
    adj = jnp.asarray(g.to_dense())
    band = band_windows(np.asarray(adj), block=8, width_mult=8)
    assert band[1] < n                      # genuinely band-limited
    x = jnp.asarray(rng.standard_normal((2, n, 8)).astype(np.float32))
    layer = GatedGraphNetwork(output_size=8)
    params = layer.init(jax.random.PRNGKey(0), x, adj=adj)

    out_full = layer.apply(params, x, adj=adj)
    out_band = layer.apply(params, x, adj=adj, adj_band=band)
    np.testing.assert_allclose(np.asarray(out_band),
                               np.asarray(out_full), rtol=1e-5,
                               atol=1e-5)
    out_coo = layer.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    np.testing.assert_allclose(np.asarray(out_band),
                               np.asarray(out_coo), rtol=2e-5,
                               atol=2e-5)

    def loss(p, **kw):
        return (layer.apply(p, x, **kw) ** 2).sum()

    g_band = jax.grad(loss)(params, adj=adj, adj_band=band)
    g_full = jax.grad(loss)(params, adj=adj)
    for a, b in zip(jax.tree_util.tree_leaves(g_band),
                    jax.tree_util.tree_leaves(g_full)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)

    # variable-width windows (uniform=False): per-block widths hug
    # each block's band — same values and grads
    band_v = band_windows(np.asarray(adj), block=8, width_mult=8,
                          uniform=False)
    assert isinstance(band_v[1], tuple) and max(band_v[1]) <= band[1]
    out_var = layer.apply(params, x, adj=adj, adj_band=band_v)
    np.testing.assert_allclose(np.asarray(out_var),
                               np.asarray(out_full), rtol=1e-5,
                               atol=1e-5)
    g_var = jax.grad(loss)(params, adj=adj, adj_band=band_v)
    for a, b in zip(jax.tree_util.tree_leaves(g_var),
                    jax.tree_util.tree_leaves(g_full)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
