"""Node-sharded whole-series encoding + node-sharded closed-form ridge
(the multi-device memory-scaling path): sharded
result == single-device result; encoding stays 1/n per device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.encode import Reservoir
from sgp.encode.spatial import sgp_spatial_embedding
from sgp.graph import Graph, coalesce
from sgp.parallel import make_mesh
from sgp.parallel.encode import encode_series_sharded, sharded_ridge_nodes

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="needs 8 virtual devices")]


def make_graph(rng, n):
    return coalesce(Graph(rng.integers(0, n, 6 * n),
                          rng.integers(0, n, 6 * n),
                          rng.random(6 * n).astype(np.float32), n))


@pytest.mark.parametrize("n,bidir,gattr", [(24, False, True),
                                           (21, True, False)])
def test_encode_series_sharded_matches_single(rng, n, bidir, gattr):
    t, f = 30, 3
    g = make_graph(rng, n)
    x = rng.standard_normal((t, n, f)).astype(np.float32)
    res = Reservoir(input_size=f, hidden_size=8, num_layers=2, seed=1)
    mesh = make_mesh(8, 1)

    # single-device reference: reservoir + sgp_spatial_embedding (+ mean)
    h = res(jnp.asarray(x))
    parts = sgp_spatial_embedding(h, g, k=2, bidirectional=bidir)
    if gattr:
        parts = parts + [jnp.broadcast_to(h.mean(-2, keepdims=True),
                                          h.shape)]
    expect = np.asarray(jnp.concatenate(parts, -1))

    with mesh:
        out = encode_series_sharded(res, x, g, mesh, k=2, axis="data",
                                    bidirectional=bidir, global_attr=gattr)
    assert len(out.addressable_shards) == 8
    assert out.addressable_shards[0].data.nbytes * 8 == out.nbytes
    np.testing.assert_allclose(np.asarray(out)[:, :n], expect, atol=2e-5)
    # padded rows (if any) are exactly zero
    if out.shape[1] != n:
        pad = np.asarray(out)[:, n:]
        k_cols = expect.shape[-1] - (h.shape[-1] if gattr else 0)
        assert not pad[..., :k_cols].any()


def test_sharded_ridge_nodes_matches_flat(rng):
    """Node-sharded Gram/moment ridge == single-device ridge on the
    flattened masked rows (incl. a non-divisible N with padding)."""
    from sgp.train import ridge_regression

    t, n, d, c = 40, 13, 6, 2
    x = rng.standard_normal((t, n, d)).astype(np.float32)
    y = rng.standard_normal((t, n, c)).astype(np.float32)
    mask = rng.random((t, n, 1)) > 0.2
    rows = mask[..., 0].reshape(-1)
    w_ref, b_ref = ridge_regression(x.reshape(-1, d)[rows],
                                    y.reshape(-1, c)[rows], alpha=0.5)
    mesh = make_mesh(8, 1)
    with mesh:
        w, b = sharded_ridge_nodes(x, y, 0.5, mesh, mask=jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), atol=2e-4)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_ref), atol=2e-4)


def test_sharded_ridge_nodes_default_mask_ignores_padding(rng):
    from sgp.train import ridge_regression

    t, n, d, c = 25, 11, 4, 1
    x = rng.standard_normal((t, n, d)).astype(np.float32)
    y = rng.standard_normal((t, n, c)).astype(np.float32)
    w_ref, b_ref = ridge_regression(x.reshape(-1, d), y.reshape(-1, c),
                                    alpha=0.1)
    mesh = make_mesh(8, 1)
    with mesh:
        w, b = sharded_ridge_nodes(x, y, 0.1, mesh)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), atol=2e-4)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_ref), atol=2e-4)


def test_sharded_encode_feeds_sharded_iid_step(rng):
    """End-to-end multi-chip: sharded encode -> node-sharded fused IID
    training, nothing replicated, loss finite."""
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel.sharding import make_sharded_iid_step

    t, n, f = 40, 21, 2
    g = make_graph(np.random.default_rng(0), n)
    x = rng.standard_normal((t, n, f)).astype(np.float32)
    res = Reservoir(input_size=f, hidden_size=4, num_layers=1, seed=0)
    mesh = make_mesh(8, 1)
    with mesh:
        enc = encode_series_sharded(res, x, g, mesh, k=1,
                                    global_attr=True)
    n_pad = enc.shape[1]
    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    model = SGPModel(input_size=enc.shape[-1], order=3, n_nodes=n_pad,
                     hidden_size=16, mlp_size=8, output_size=1,
                     n_layers=1, horizon=2, positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, enc.shape[-1])),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    step = make_sharded_iid_step(
        model, opt, enc, jnp.asarray(target),
        jnp.ones((t, n, 1), bool), jnp.arange(t - 3), 1 + jnp.arange(2),
        ScalerParams(jnp.zeros(1), jnp.ones(1)), mesh, batch_size=64,
        steps_per_call=3)
    with mesh:
        p2, s2, loss = step(params, opt.init(params), key)
    assert np.isfinite(float(loss))
    # all big arrays node-sharded
    for arr in step.data[:3]:
        assert len(arr.addressable_shards) == 8
        assert arr.addressable_shards[0].data.nbytes * 8 == arr.nbytes


def test_encode_series_sharded_bf16_halo_payload(rng):
    """Compressed halo payloads through the full sharded encode match
    the f32-wire result to bf16 tolerance."""
    import jax.numpy as jnp
    from sgp.encode import Reservoir
    from sgp.graph import Graph, coalesce, normalize_adj
    from sgp.parallel import make_mesh
    from sgp.parallel.encode import encode_series_sharded

    n, t = 40, 12
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, n, 240), rng.integers(0, n, 240),
        rng.random(240).astype(np.float32), n)), "row")
    res = Reservoir(input_size=2, hidden_size=8, num_layers=1,
                    leaking_rate=0.9, spectral_radius=0.8, density=1.0)
    x = rng.standard_normal((t, n, 2)).astype(np.float32)
    mesh = make_mesh(1, 8)
    with mesh:
        ref = encode_series_sharded(res, x, g, mesh, k=2, axis="model")
        got = encode_series_sharded(res, x, g, mesh, k=2, axis="model",
                                    halo_payload="bfloat16")
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=5e-2)
