"""GatedGN ELL (padded-neighbor) aggregation — the ``neigh=`` path of
``GatedGraphNetwork`` — vs a plain-jnp oracle and the edge-list layer.

The layer's aggregated messages are read back through
``apply(..., mutable=["intermediates"])``; the oracle recomputes them
from the same parameters on the gathered ``[B, N, D, h]`` neighbors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph.sparse import Graph, coalesce, padded_incoming
from sgp.models.blocks import get_activation
from sgp.models.graph_layers import GatedGraphNetwork


def gn_ell_reference(p_i, pjn, nmask, w2, b2, wg, bg,
                     activation: str = "silu"):
    """Pure-jnp oracle of the gated ELL message sum."""
    act = get_activation(activation)
    s = p_i[..., :, None, :] + pjn
    mb = act(act(s) @ w2 + b2)
    g = jax.nn.sigmoid(mb @ wg.reshape(-1, 1) + bg)
    m = g * mb
    return jnp.sum((m * nmask[..., None]).astype(jnp.float32), axis=-2)


def _setup(seed, n=20, b=2, d=5, f=8, h=16, activation="silu",
           dtype=None, mask_p=0.85):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((b, n, f)).astype(np.float32))
    src_idx = jnp.asarray(rng.integers(0, n, (n, d)).astype(np.int32))
    nmask = jnp.asarray(rng.random((n, d)) < mask_p)
    layer = GatedGraphNetwork(output_size=h, activation=activation,
                              dtype=dtype)
    params = layer.init(jax.random.PRNGKey(seed), x,
                        neigh=(src_idx, nmask))
    return layer, params, x, (src_idx, nmask)


def layer_aggregate(layer, params, x, **kw):
    _, state = layer.apply(params, x, mutable=["intermediates"], **kw)
    return state["intermediates"]["aggregate"][0]


def oracle_aggregate(params, x, neigh, activation="silu"):
    p = params["params"]
    src_idx, nmask = neigh
    p_i = x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    p_j = x @ p["Dense_1"]["kernel"]
    pjn = jnp.take(p_j, src_idx, axis=-2)            # [B, N, D, h2]
    return gn_ell_reference(
        p_i, pjn, nmask.astype(jnp.float32), p["Dense_2"]["kernel"],
        p["Dense_2"]["bias"], p["Dense_3"]["kernel"],
        p["Dense_3"]["bias"], activation)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu", "elu"])
def test_forward_matches_reference(activation):
    layer, params, x, neigh = _setup(0, activation=activation)
    got = layer_aggregate(layer, params, x, neigh=neigh)
    want = oracle_aggregate(params, x, neigh, activation)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_forward_padding():
    # odd n and d, one node with no valid neighbors
    layer, params, x, (si, nm) = _setup(1, n=13, d=7)
    neigh = (si, nm.at[5, :].set(False))
    got = layer_aggregate(layer, params, x, neigh=neigh)
    want = oracle_aggregate(params, x, neigh)
    assert got.shape == want.shape == (2, 13, 16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got)[:, 5], 0.0, atol=1e-6)


@pytest.mark.parametrize("activation", ["silu", "tanh"])
def test_gradients_match_reference(activation):
    layer, params, x, neigh = _setup(2, n=12, b=1, d=6,
                                     activation=activation)

    def loss_layer(p, x):
        out = layer_aggregate(layer, p, x, neigh=neigh)
        return jnp.sum(out * jnp.cos(out))

    def loss_ref(p, x):
        out = oracle_aggregate(p, x, neigh, activation)
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


def test_gradients_under_jit():
    layer, params, x, neigh = _setup(3, n=9, b=3, d=4)

    @jax.jit
    def loss(p, x):
        return jnp.mean(layer_aggregate(layer, p, x, neigh=neigh) ** 2)

    def loss_ref(p, x):
        return jnp.mean(oracle_aggregate(p, x, neigh) ** 2)

    gl = jax.grad(loss, argnums=(0, 1))(params, x)
    gr = jax.grad(loss_ref, argnums=(0, 1))(params, x)
    np.testing.assert_allclose(np.asarray(gl[1]), np.asarray(gr[1]),
                               rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(gl[0]["params"]["Dense_2"]["kernel"]),
        np.asarray(gr[0]["params"]["Dense_2"]["kernel"]),
        rtol=5e-5, atol=5e-5)


def test_bf16_messages_close_to_f32_oracle():
    layer, params, x, neigh = _setup(4, n=16, d=6, dtype=jnp.bfloat16)
    got = layer_aggregate(layer, params, x, neigh=neigh)
    want = oracle_aggregate(params, x, neigh)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0.05, atol=0.05)


def _graph_case(seed, n, e, b, f=8):
    rng = np.random.default_rng(seed)
    g = coalesce(Graph(rng.integers(0, n, e).astype(np.int32),
                       rng.integers(0, n, e).astype(np.int32),
                       rng.random(e).astype(np.float32), n))
    si, nm = padded_incoming(g)
    x = jnp.asarray(rng.standard_normal((b, n, f)).astype(np.float32))
    return g, (jnp.asarray(si), jnp.asarray(nm)), x


def test_layer_ell_matches_edge_list():
    """GatedGraphNetwork(neigh=) == the explicit edge-list
    forward/backward with identical params."""
    g, neigh, x = _graph_case(7, n=12, e=60, b=2)
    layer = GatedGraphNetwork(output_size=8, sorted_edges=True)
    params = layer.init(jax.random.PRNGKey(0), x,
                        jnp.asarray(g.src), jnp.asarray(g.dst))
    out_coo = layer.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    out_ell = layer.apply(params, x, neigh=neigh)
    np.testing.assert_allclose(np.asarray(out_ell), np.asarray(out_coo),
                               rtol=2e-5, atol=2e-5)

    def loss_ell(p):
        return (layer.apply(p, x, neigh=neigh) ** 2).sum()

    def loss_coo(p):
        return (layer.apply(p, x, jnp.asarray(g.src),
                            jnp.asarray(g.dst)) ** 2).sum()

    for a, b in zip(jax.tree_util.tree_leaves(jax.grad(loss_ell)(params)),
                    jax.tree_util.tree_leaves(
                        jax.grad(loss_coo)(params))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


def test_layer_ell_bf16_close_to_f32_edge_list():
    """bf16 message dtype (the gatedgn_bf16 setting) on the ELL path
    stays close to the f32 edge-list layer with the same params."""
    g, neigh, x = _graph_case(8, n=10, e=40, b=3)
    layer16 = GatedGraphNetwork(output_size=16, dtype=jnp.bfloat16)
    layer32 = GatedGraphNetwork(output_size=16)
    params = layer16.init(jax.random.PRNGKey(1), x, neigh=neigh)
    out16 = layer16.apply(params, x, neigh=neigh)
    out32 = layer32.apply(params, x, jnp.asarray(g.src),
                          jnp.asarray(g.dst))
    np.testing.assert_allclose(np.asarray(out16, np.float32),
                               np.asarray(out32, np.float32),
                               rtol=0.05, atol=0.05)
