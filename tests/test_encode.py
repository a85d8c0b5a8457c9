"""Encoder pipeline: reservoir/GESN scans vs numpy oracles, K-hop
propagation vs dense powers, encode_dataset wiring."""
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.data import SpatioTemporalDataset, StandardScaler, Windowing
from sgp.encode import (GESNEncoder, GraphESN, Reservoir, SGPEncoder,
                        SGPSpatialEncoder, SGPTemporalEncoder,
                        encode_dataset, sgp_spatial_embedding,
                        sgp_spatial_support)
from sgp.graph import Graph, coalesce, normalize_adj
from sgp.ops.linalg import spectral_radius_exact


def make_weights(rng, sizes, alpha=0.9):
    """Random reservoir weights [(H, F_in)] chain."""
    ws = []
    for f_in, h in sizes:
        ws.append(dict(w_ih=rng.standard_normal((h, f_in)).astype(np.float32) * .5,
                       w_hh=rng.standard_normal((h, h)).astype(np.float32) * .1,
                       b_ih=rng.standard_normal(h).astype(np.float32) * .1,
                       alpha=alpha))
    return ws


def numpy_reservoir(ws, x, act=np.tanh):
    """Step-by-step reference of reservoir.py:158-186 (torch semantics)."""
    t, n, _ = x.shape
    h = [np.zeros((n, w["w_hh"].shape[0]), np.float32) for w in ws]
    out = []
    for s in range(t):
        inp = x[s]
        for i, w in enumerate(ws):
            pre = inp @ w["w_ih"].T + w["b_ih"] + h[i] @ w["w_hh"].T
            h[i] = (1 - w["alpha"]) * h[i] + w["alpha"] * act(pre)
            inp = h[i]
        out.append(np.concatenate(h, -1))
    return np.stack(out)


def test_reservoir_matches_numpy(rng):
    ws = make_weights(rng, [(3, 8), (8, 8)])
    x = rng.standard_normal((20, 5, 3)).astype(np.float32)
    res = Reservoir.from_arrays(ws)
    out = np.asarray(res(jnp.asarray(x)))
    expect = numpy_reservoir(ws, x)
    assert out.shape == (20, 5, 16)
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_reservoir_last_state(rng):
    ws = make_weights(rng, [(2, 4)])
    x = rng.standard_normal((10, 3, 2)).astype(np.float32)
    res = Reservoir.from_arrays(ws)
    full = np.asarray(res(jnp.asarray(x)))
    last = np.asarray(res(jnp.asarray(x), return_last_state=True))
    np.testing.assert_allclose(last, full[-1], atol=1e-6)


def test_reservoir_init_spectral_radius():
    res = Reservoir(input_size=2, hidden_size=32, spectral_radius=0.85,
                    density=0.7, seed=3)
    for p in res.layers:
        rho = spectral_radius_exact(np.asarray(p.w_hh))
        assert abs(rho - 0.85) < 1e-4
        # density: ~30% of entries zeroed
        frac_zero = float((np.asarray(p.w_hh) == 0).mean())
        assert 0.25 < frac_zero < 0.35


def test_reservoir_alpha_decay():
    res = Reservoir(input_size=2, hidden_size=4, num_layers=3,
                    leaking_rate=0.9, alpha_decay=True)
    assert [round(p.alpha, 4) for p in res.layers] == [0.9, 0.8, 0.7]


def test_self_norm_activation(rng):
    ws = make_weights(rng, [(2, 4)])
    x = rng.standard_normal((5, 3, 2)).astype(np.float32)
    res = Reservoir.from_arrays(ws, activation="self_norm")
    out = np.asarray(res(jnp.asarray(x)))
    def act(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    expect = numpy_reservoir(ws, x, act=act)
    np.testing.assert_allclose(out, expect, atol=1e-5)


def toy_graph(rng, n=12, e=40):
    return coalesce(Graph(rng.integers(0, n, e), rng.integers(0, n, e),
                          rng.random(e).astype(np.float32), n))


def test_spatial_embedding_powers(rng):
    g = toy_graph(rng)
    x = rng.standard_normal((4, g.num_nodes, 3)).astype(np.float32)
    res = sgp_spatial_embedding(jnp.asarray(x), g, k=3)
    a = normalize_adj(g, "row").to_dense()
    cur = x
    for j in range(4):
        np.testing.assert_allclose(np.asarray(res[j]), cur, atol=1e-4)
        cur = np.einsum("ij,tjf->tif", a, cur)


def test_spatial_embedding_bidirectional(rng):
    g = toy_graph(rng)
    x = rng.standard_normal((2, g.num_nodes, 2)).astype(np.float32)
    res = sgp_spatial_embedding(jnp.asarray(x), g, k=2, bidirectional=True)
    assert len(res) == 1 + 2 + 2
    from sgp.graph import transpose
    at = normalize_adj(transpose(g), "row").to_dense()
    np.testing.assert_allclose(np.asarray(res[3]),
                               np.einsum("ij,tjf->tif", at, x), atol=1e-4)


def test_spatial_embedding_undirected(rng):
    g = toy_graph(rng)
    x = rng.standard_normal((2, g.num_nodes, 2)).astype(np.float32)
    res = sgp_spatial_embedding(jnp.asarray(x), g, k=1, undirected=True)
    from sgp.graph import to_undirected
    a = normalize_adj(to_undirected(g), "sym").to_dense()
    np.testing.assert_allclose(np.asarray(res[1]),
                               np.einsum("ij,tjf->tif", a, x), atol=1e-4)


def test_spatial_embedding_one_hot(rng):
    g = toy_graph(rng)
    n = g.num_nodes
    x = rng.standard_normal((2, n, 2)).astype(np.float32)
    res = sgp_spatial_embedding(jnp.asarray(x), g, k=1,
                                one_hot_encoding=True)
    assert res[0].shape == (2, n, 2 + n)
    np.testing.assert_allclose(np.asarray(res[0][..., 2:]),
                               np.broadcast_to(np.eye(n), (2, n, n)))


def test_spatial_support_true_powers(rng):
    g = toy_graph(rng)
    sup = sgp_spatial_support(g, k=3)
    a = normalize_adj(g, "row").to_dense()
    np.testing.assert_allclose(sup[1].to_dense(), a @ a, atol=1e-5)
    np.testing.assert_allclose(sup[2].to_dense(), a @ a @ a, atol=1e-5)
    # reference quirk: A@A repeated
    sup_q = sgp_spatial_support(g, k=3, true_powers=False)
    np.testing.assert_allclose(sup_q[2].to_dense(), a @ a, atol=1e-5)


def test_spatial_support_global_attr(rng):
    g = toy_graph(rng)
    sup = sgp_spatial_support(g, k=1, global_attr=True)
    n = g.num_nodes
    np.testing.assert_allclose(sup[-1].to_dense(), np.full((n, n), 1 / n),
                               rtol=1e-5)


def numpy_gesn(ws, x, a):
    t, n, _ = x.shape
    h = [np.zeros((n, w["w_hh"].shape[0]), np.float32) for w in ws]
    out = []
    for s in range(t):
        inp = x[s]
        for i, w in enumerate(ws):
            pre = inp @ w["w_ih"].T + w["b_ih"] + a @ (h[i] @ w["w_hh"].T)
            h[i] = (1 - w["alpha"]) * h[i] + w["alpha"] * np.tanh(pre)
            inp = h[i]
        out.append(np.concatenate(h, -1))
    return np.stack(out)


def test_gesn_matches_numpy(rng):
    g = toy_graph(rng)
    from sgp.graph import add_self_loops
    gn = normalize_adj(add_self_loops(g), "row")
    from sgp.ops import build_operator
    ws = make_weights(rng, [(3, 6), (6, 6)])
    x = rng.standard_normal((15, g.num_nodes, 3)).astype(np.float32)
    gesn = GraphESN.from_arrays(ws)
    out = np.asarray(gesn(jnp.asarray(x), build_operator(gn, "dense")))
    expect = numpy_gesn(ws, x, gn.to_dense())
    np.testing.assert_allclose(out, expect, atol=1e-4)


def test_gesn_encoder_end_to_end(rng):
    g = toy_graph(rng)
    x = rng.standard_normal((10, g.num_nodes, 2)).astype(np.float32)
    enc = GESNEncoder(input_size=2, reservoir_size=8, reservoir_layers=2)
    out = np.asarray(enc(jnp.asarray(x), g))
    assert out.shape == (10, g.num_nodes, 16)
    assert np.isfinite(out).all()


def test_sgp_encoder_output_size(rng):
    g = toy_graph(rng)
    x = rng.standard_normal((8, g.num_nodes, 2)).astype(np.float32)
    enc = SGPEncoder(input_size=2, reservoir_size=8, reservoir_layers=2,
                     receptive_field=2, bidirectional=True, global_attr=True)
    out = np.asarray(enc(jnp.asarray(x), g))
    # D = (1 + 2*2 + 1[global]) * (2 layers * 8)
    assert out.shape == (8, g.num_nodes, 6 * 16)
    assert enc.output_size == 6 * 16
    # chunked streaming path matches one-shot
    out_chunked = enc(jnp.asarray(x), g, time_chunk=3)
    np.testing.assert_allclose(out_chunked, out, atol=1e-5)


def test_encode_dataset_wiring(rng, tmp_path):
    g = toy_graph(rng)
    n = g.num_nodes
    data = rng.standard_normal((30, n, 1)).astype(np.float32)
    u = rng.standard_normal((30, 2)).astype(np.float32)
    ds = SpatioTemporalDataset(data, graph=g, covariates={"u": u},
                               windowing=Windowing(window=1, horizon=3))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    enc = SGPEncoder(input_size=3, reservoir_size=4, receptive_field=1,
                     global_attr=False)
    cache = str(tmp_path / "enc.npz")
    encode_dataset(ds, enc, encode_exogenous=True, keep_raw=True,
                   save_path=cache)
    assert "encoded_x" in ds.covariates
    assert ds.input_keys == ["encoded_x"]
    b = ds.gather_batch(np.array([0, 1]))
    assert b.x.shape == (2, 1, n, 8)       # (1+k) * 4
    # keep_raw: u is the scaled raw series
    assert b.u.shape == (2, 1, n, 1)
    np.testing.assert_allclose(b.u[0, 0], ds.target_scaled[0], atol=1e-6)
    # cache roundtrip: re-encode loads identical values
    ds2 = SpatioTemporalDataset(data, graph=g, covariates={"u": u},
                                windowing=Windowing(window=1, horizon=3))
    ds2.fit_scaler(StandardScaler(axis=(0, 1)))
    encode_dataset(ds2, enc, encode_exogenous=True, keep_raw=True,
                   save_path=cache)
    np.testing.assert_allclose(ds2.covariates["encoded_x"].value,
                               ds.covariates["encoded_x"].value)


def test_streaming_encode_matches_oneshot(rng):
    """Fused streaming encode (reservoir state carried across chunks)
    must equal the one-shot encoder cast to the same dtype, including
    a non-divisible tail chunk and bidirectional + global_attr."""
    from sgp.encode import streaming_encode
    g = toy_graph(rng)
    x = jnp.asarray(rng.standard_normal((13, g.num_nodes, 2)),
                    jnp.float32)
    enc = SGPEncoder(input_size=2, reservoir_size=8, reservoir_layers=2,
                     receptive_field=2, bidirectional=True,
                     global_attr=True)
    ref = np.asarray(enc(x, g).astype(jnp.float32))
    out = streaming_encode(enc, x, g, time_chunk=4,
                           out_dtype=jnp.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)
    # bf16 output: same values after casting the oneshot result
    out_bf = streaming_encode(enc, x, g, time_chunk=4)
    np.testing.assert_array_equal(
        np.asarray(out_bf), np.asarray(enc(x, g).astype(jnp.bfloat16)))


def test_streaming_encode_packed_lanes(rng):
    """extra_lanes rides along each chunk: the output must equal
    pack_iid_data(encoded, target, mask) built from the separate
    one-shot encode."""
    from sgp.encode import streaming_encode
    from sgp.train.iid import pack_iid_data
    g = toy_graph(rng)
    t, c = 12, 2
    x = jnp.asarray(rng.standard_normal((t, g.num_nodes, 2)), jnp.float32)
    tgt = jnp.asarray(rng.standard_normal((t, g.num_nodes, c)),
                      jnp.float32)
    msk = jnp.asarray(rng.random((t, g.num_nodes, c)) > 0.4)
    h_off = np.array([1, 3])
    enc = SGPEncoder(input_size=2, reservoir_size=4, reservoir_layers=1,
                     receptive_field=1)
    lanes = pack_iid_data(jnp.zeros((t, g.num_nodes, 0), jnp.bfloat16),
                          tgt, msk, h_off)
    out = streaming_encode(enc, x, g, time_chunk=4, extra_lanes=lanes)
    expect = pack_iid_data(enc(x, g).astype(jnp.bfloat16), tgt, msk,
                           h_off)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(expect))


def test_streaming_encode_prebuilt_ops(rng):
    """ops= (build_streaming_ops) must give the same output as the
    per-call build — repeat callers prebuild once to avoid re-uploading
    the dense operator through the device link every call."""
    from sgp.encode import build_streaming_ops, streaming_encode
    g = toy_graph(rng)
    x = jnp.asarray(rng.standard_normal((9, g.num_nodes, 2)), jnp.float32)
    enc = SGPEncoder(input_size=2, reservoir_size=4, reservoir_layers=1,
                     receptive_field=2, global_attr=True)
    ops = build_streaming_ops(enc, g)
    out = streaming_encode(enc, x, g, time_chunk=4, ops=ops)
    ref = streaming_encode(enc, x, g, time_chunk=4)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_wavefront_matches_sequential(rng):
    """The layer-pipelined wavefront scan is a pure scheduling change:
    identical recurrence to the sequential scan at every chunk shape
    (ragged final chunk included), for outputs, carried states, and
    return_last_state."""
    from sgp.encode.reservoir import Reservoir, reservoir_scan

    res = Reservoir(input_size=5, hidden_size=16, num_layers=3, seed=3)
    for t in (7, 255, 256, 257, 300):
        x = jnp.asarray(
            rng.standard_normal((t, 4, 5)).astype(np.float32))
        seq = reservoir_scan(res.layers, "tanh", x, mode="sequential")
        wav = reservoir_scan(res.layers, "tanh", x, mode="wavefront")
        np.testing.assert_allclose(np.asarray(wav), np.asarray(seq),
                                   atol=1e-5)
        # state carried across a split stays aligned
        s1, h1 = reservoir_scan(res.layers, "tanh", x[:t // 2],
                                with_state=True, mode="wavefront")
        s2, _ = reservoir_scan(res.layers, "tanh", x[t // 2:], h0=h1,
                               with_state=True, mode="wavefront")
        np.testing.assert_allclose(
            np.asarray(jnp.concatenate([s1, s2], 0)), np.asarray(seq),
            atol=1e-5)
        ls = reservoir_scan(res.layers, "tanh", x,
                            return_last_state=True, mode="wavefront")
        np.testing.assert_allclose(
            np.asarray(ls), np.asarray(seq[-1]), atol=1e-5)
