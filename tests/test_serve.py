"""Online serving == offline pipeline: feeding raw observations
step-by-step through OnlineForecaster reproduces the offline
SGPEncoder-precompute + decoder forecasts exactly."""
import jax
import jax.numpy as jnp
import numpy as np

from sgp.data import ScalerParams
from sgp.encode import SGPEncoder
from sgp.graph import Graph, coalesce
from sgp.models import SGPModel
from sgp.serve import OnlineForecaster
import pytest

pytestmark = pytest.mark.slow


def _setup(rng, n=14, t=24, f=1):
    g = coalesce(Graph(rng.integers(0, n, 5 * n),
                       rng.integers(0, n, 5 * n),
                       rng.random(5 * n).astype(np.float32), n))
    x_raw = rng.standard_normal((t, n, f)).astype(np.float32) * 3 + 1
    enc = SGPEncoder(input_size=f, reservoir_size=6, reservoir_layers=2,
                     receptive_field=2, bidirectional=True,
                     global_attr=True, seed=3)
    scaler = ScalerParams(jnp.full((1, 1, f), 1.0),
                          jnp.full((1, 1, f), 3.0))
    # order = 1 self + 2 dirs x 2 hops + 1 global = 6 blocks
    model = SGPModel(input_size=enc.output_size, order=6, n_nodes=n,
                     hidden_size=16, mlp_size=8, output_size=f,
                     n_layers=1, horizon=3, positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, n, enc.output_size)))
    return g, x_raw, enc, scaler, model, params


def test_online_matches_offline(rng):
    g, x_raw, enc, scaler, model, params = _setup(rng)
    # offline: encode the whole scaled series, decode every step
    encoded = enc(scaler.transform(jnp.asarray(x_raw)), g)
    offline = model.apply(params, np.asarray(encoded)[:, None],
                          training=False)       # [T, H, N, F] (b=T)
    offline = scaler.inverse_transform(offline)

    fc = OnlineForecaster(enc, g, model, params, scaler)
    for t in range(x_raw.shape[0]):
        y = fc.step(x_raw[t])
        np.testing.assert_allclose(np.asarray(y), np.asarray(offline[t]),
                                   rtol=2e-5, atol=2e-5, err_msg=f"t={t}")


def test_warm_up_equals_stepping(rng):
    g, x_raw, enc, scaler, model, params = _setup(rng)
    a = OnlineForecaster(enc, g, model, params, scaler)
    for t in range(10):
        a.step(x_raw[t])
    b = OnlineForecaster(enc, g, model, params, scaler)
    b.warm_up(x_raw[:10])
    for ha, hb in zip(a.state, b.state):
        np.testing.assert_allclose(np.asarray(ha), np.asarray(hb),
                                   rtol=1e-5, atol=1e-6)
    ya = a.step(x_raw[10])
    yb = b.step(x_raw[10])
    np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                               rtol=1e-5, atol=1e-6)
    a.reset()
    assert not any(np.asarray(h).any() for h in a.state)


def test_online_matches_offline_bf16_store(rng):
    """store_dtype='bfloat16' makes online features carry the SAME
    rounding the offline bf16-stored encoding gave the decoder."""
    g, x_raw, enc, scaler, model, params = _setup(rng)
    encoded = enc(scaler.transform(jnp.asarray(x_raw)), g,
                  out_dtype="bfloat16")
    offline = model.apply(params, np.asarray(encoded)[:, None],
                          training=False)
    offline = scaler.inverse_transform(offline)

    fc = OnlineForecaster(enc, g, model, params, scaler,
                          store_dtype="bfloat16")
    for t in range(x_raw.shape[0]):
        y = fc.step(x_raw[t])
        np.testing.assert_allclose(np.asarray(y), np.asarray(offline[t]),
                                   rtol=2e-5, atol=2e-5, err_msg=f"t={t}")


def test_online_gesn_matches_offline(rng):
    """OnlineGESNForecaster reproduces the offline DynGESN pipeline:
    GESN encode + per-lag ridge readouts, fed step by step."""
    from sgp.encode import GESNEncoder
    from sgp.serve import OnlineGESNForecaster
    from sgp.train import closed_form_readout

    n, t, f, lags = 12, 30, 1, 3
    g = coalesce(Graph(rng.integers(0, n, 4 * n),
                       rng.integers(0, n, 4 * n),
                       rng.random(4 * n).astype(np.float32), n))
    x_raw = rng.standard_normal((t, n, f)).astype(np.float32) * 2 - 0.5
    scaler = ScalerParams(jnp.full((1, 1, f), -0.5),
                          jnp.full((1, 1, f), 2.0))
    enc = GESNEncoder(input_size=f, reservoir_size=5,
                      reservoir_layers=2, seed=4)
    x_scaled = scaler.transform(jnp.asarray(x_raw))
    encoded = np.asarray(enc(x_scaled, g))             # [T, N, D]
    d = encoded.shape[-1]
    tr = np.arange(t - lags)
    xs = encoded[tr].reshape(-1, d)
    ys = [np.asarray(x_scaled)[tr + 1 + l].reshape(-1, f)
          for l in range(lags)]
    readouts = closed_form_readout(xs, ys, alpha=0.3)
    fc = OnlineGESNForecaster(enc, g, readouts, scaler)
    for step_t in range(t):
        y = fc.step(x_raw[step_t])                     # [L, N, F] raw
        expect = np.stack([encoded[step_t] @ np.asarray(w)
                           + np.asarray(b) for w, b in readouts])
        expect = np.asarray(scaler.inverse_transform(
            jnp.asarray(expect)))
        np.testing.assert_allclose(np.asarray(y), expect, rtol=2e-4,
                                   atol=2e-5, err_msg=f"t={step_t}")
    # warm_up == stepping
    fc2 = OnlineGESNForecaster(enc, g, readouts, scaler)
    fc2.warm_up(x_raw[:10])
    fc.reset()
    for step_t in range(10):
        fc.step(x_raw[step_t])
    for ha, hb in zip(fc.state, fc2.state):
        np.testing.assert_allclose(np.asarray(ha), np.asarray(hb),
                                   rtol=1e-5, atol=1e-6)


def test_export_forecaster_roundtrip(rng, tmp_path):
    """jax.export artifact: the deserialized step reproduces the live
    forecaster exactly, with no encoder/model objects at load time."""
    from sgp.serve import export_forecaster, load_forecaster

    g, x_raw, enc, scaler, model, params = _setup(rng)
    fc = OnlineForecaster(enc, g, model, params, scaler)
    path = str(tmp_path / "fc.sgpserve")
    size = export_forecaster(fc, path)
    assert size > 0
    loaded = load_forecaster(path)
    assert loaded.input_shape == (x_raw.shape[1], x_raw.shape[2])
    for t in range(6):
        ya = fc.step(x_raw[t])
        yb = loaded.step(x_raw[t])
        np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                                   rtol=1e-6, atol=1e-7, err_msg=f"t={t}")


def _gesn_setup(rng, n=12, t=30, f=1, lags=3):
    from sgp.encode import GESNEncoder
    from sgp.train import closed_form_readout

    g = coalesce(Graph(rng.integers(0, n, 4 * n),
                       rng.integers(0, n, 4 * n),
                       rng.random(4 * n).astype(np.float32), n))
    x_raw = rng.standard_normal((t, n, f)).astype(np.float32) * 2 - 0.5
    scaler = ScalerParams(jnp.full((1, 1, f), -0.5),
                          jnp.full((1, 1, f), 2.0))
    enc = GESNEncoder(input_size=f, reservoir_size=5,
                      reservoir_layers=2, seed=4)
    x_scaled = scaler.transform(jnp.asarray(x_raw))
    encoded = np.asarray(enc(x_scaled, g))
    d = encoded.shape[-1]
    tr = np.arange(t - lags)
    readouts = closed_form_readout(
        encoded[tr].reshape(-1, d),
        [np.asarray(x_scaled)[tr + 1 + l].reshape(-1, f)
         for l in range(lags)], alpha=0.3)
    return g, x_raw, enc, scaler, readouts


def test_gesn_multi_stream_matches_independent(rng):
    """OnlineGESNForecaster n_streams: S streams in one dispatch == S
    independent single-stream forecasters."""
    from sgp.serve import OnlineGESNForecaster

    g, x_raw, enc, scaler, readouts = _gesn_setup(rng)
    s = 3
    streams = rng.standard_normal(
        (10, s) + x_raw.shape[1:]).astype(np.float32)
    fc_b = OnlineGESNForecaster(enc, g, readouts, scaler, n_streams=s)
    fc_b.warm_up(streams[:4])
    singles = [OnlineGESNForecaster(enc, g, readouts, scaler)
               for _ in range(s)]
    for i, f in enumerate(singles):
        f.warm_up(streams[:4, i])
    for t in range(4, 10):
        yb = np.asarray(fc_b.step(streams[t]))       # [S, L, N, C]
        assert yb.shape[0] == s
        for i, f in enumerate(singles):
            yi = np.asarray(f.step(streams[t, i]))
            np.testing.assert_allclose(yb[i], yi, rtol=2e-5, atol=2e-5,
                                       err_msg=f"t={t} stream={i}")


def test_export_gesn_roundtrip(rng, tmp_path):
    """The DynGESN serving path exports/loads through the same
    jax.export artifact format."""
    import pytest

    from sgp.serve import (OnlineGESNForecaster, export_forecaster,
                           load_forecaster)

    g, x_raw, enc, scaler, readouts = _gesn_setup(rng)
    fc = OnlineGESNForecaster(enc, g, readouts, scaler)
    path = str(tmp_path / "gesn.sgpserve")
    with pytest.raises(ValueError, match="exogenous"):
        export_forecaster(fc, path, example_u=np.zeros(2, np.float32))
    export_forecaster(fc, path)
    loaded = load_forecaster(path)
    assert loaded.input_shape == (x_raw.shape[1], x_raw.shape[2])
    for t in range(5):
        ya = fc.step(x_raw[t])
        yb = loaded.step(x_raw[t])
        np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                                   rtol=1e-5, atol=1e-6, err_msg=f"t={t}")


def test_export_multi_stream_roundtrip(rng, tmp_path):
    """n_streams forecasters export with the [S, N, C] input layout
    (the stream axis must not be mistaken for the node axis)."""
    from sgp.serve import export_forecaster, load_forecaster

    g, x_raw, enc, scaler, model, params = _setup(rng)
    s = 3
    fc = OnlineForecaster(enc, g, model, params, scaler, n_streams=s)
    path = str(tmp_path / "fc_ms.sgpserve")
    export_forecaster(fc, path)
    loaded = load_forecaster(path)
    assert loaded.input_shape == (s, x_raw.shape[1], x_raw.shape[2])
    streams = rng.standard_normal(
        (4, s) + x_raw.shape[1:]).astype(np.float32)
    for t in range(4):
        ya = fc.step(streams[t])
        yb = loaded.step(streams[t])
        np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                                   rtol=1e-6, atol=1e-7, err_msg=f"t={t}")


def test_export_with_exog(rng, tmp_path):
    """Exog-trained decoders: export without example_u raises a clear
    error; with it, the artifact signature includes u and round-trips."""
    import pytest

    from sgp.serve import export_forecaster, load_forecaster

    g, x_raw, enc, scaler, model, params = _setup(rng)
    f_u = 2
    model = SGPModel(input_size=enc.output_size, order=6,
                     n_nodes=x_raw.shape[1], hidden_size=16, mlp_size=8,
                     output_size=x_raw.shape[2], n_layers=1, horizon=3,
                     positional_encoding=True, exog_size=f_u)
    key = jax.random.PRNGKey(0)
    params = model.init(
        {"params": key, "dropout": key},
        jnp.zeros((1, x_raw.shape[1], enc.output_size)),
        u=jnp.zeros((1, 1, f_u)))
    fc = OnlineForecaster(enc, g, model, params, scaler)
    path = str(tmp_path / "fc_u.sgpserve")
    with pytest.raises(ValueError, match="exog"):
        export_forecaster(fc, path)
    export_forecaster(fc, path, example_u=np.zeros(f_u, np.float32))
    loaded = load_forecaster(path)
    assert loaded.u_shape == (f_u,)
    with pytest.raises(ValueError, match="exogenous"):
        loaded.step(x_raw[0])          # u required but missing
    for t in range(4):
        u_t = rng.standard_normal(f_u).astype(np.float32)
        ya = fc.step(x_raw[t], u_t)
        yb = loaded.step(x_raw[t], u_t)
        # the exported StableHLO program may fuse differently than the
        # live jit -> float-level (not bit-level) agreement
        np.testing.assert_allclose(np.asarray(ya), np.asarray(yb),
                                   rtol=1e-5, atol=1e-6, err_msg=f"t={t}")


def test_multi_stream_matches_independent(rng):
    """n_streams=3 serves three independent streams in one dispatch ==
    three separate single-stream forecasters."""
    g, x_raw, enc, scaler, model, params = _setup(rng)
    s = 3
    streams = rng.standard_normal(
        (12, s) + x_raw.shape[1:]).astype(np.float32)
    fc_b = OnlineForecaster(enc, g, model, params, scaler, n_streams=s)
    fc_b.warm_up(streams[:5])
    singles = [OnlineForecaster(enc, g, model, params, scaler)
               for _ in range(s)]
    for i, f in enumerate(singles):
        f.warm_up(streams[:5, i])
    for t in range(5, 12):
        yb = np.asarray(fc_b.step(streams[t]))       # [S, H, N, C]
        assert yb.shape[0] == s
        for i, f in enumerate(singles):
            yi = np.asarray(f.step(streams[t, i]))
            np.testing.assert_allclose(yb[i], yi, rtol=2e-5, atol=2e-5,
                                       err_msg=f"t={t} stream={i}")
