"""Fused windowed training step: learns, supports propagation in-step."""
import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data import ScalerParams
from sgp.data.sgp_loader import build_support_operators
from sgp.graph import Graph, coalesce
from sgp.models import SGPModel
from sgp.train.fused_window import make_fused_window_step
import pytest

pytestmark = pytest.mark.slow


def test_fused_window_learns(rng):
    t, n, c = 150, 8, 6
    e_static = rng.standard_normal((1, n, c)).astype(np.float32)
    x_full = np.broadcast_to(e_static, (t, n, c)).copy()
    w_true = rng.standard_normal((c, 1)).astype(np.float32)
    target = x_full @ w_true
    model = SGPModel(input_size=c, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, c)))
    opt = optax.adam(5e-3)
    step = make_fused_window_step(
        model, opt, jnp.asarray(x_full), jnp.asarray(target),
        jnp.ones((t, n, 1), bool), jnp.arange(t - 3), jnp.arange(1),
        1 + jnp.arange(2), ScalerParams(jnp.zeros(1), jnp.ones(1)),
        batch_size=16, steps_per_call=20)
    st = opt.init(params)
    losses = []
    for i in range(10):
        key, k = jax.random.split(key)
        params, st, loss = step(params, st, k)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses


def test_fused_window_with_support(rng):
    t, n, c = 60, 10, 3
    g = coalesce(Graph(rng.integers(0, n, 40), rng.integers(0, n, 40),
                       rng.random(40).astype(np.float32), n))
    ops = build_support_operators(g, k=2)
    x_full = rng.standard_normal((t, n, c)).astype(np.float32)
    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    model = SGPModel(input_size=c * 3, order=3, n_nodes=n, hidden_size=18,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=True)
    key = jax.random.PRNGKey(1)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, c * 3)))
    opt = optax.adam(1e-3)
    step = make_fused_window_step(
        model, opt, jnp.asarray(x_full), jnp.asarray(target),
        jnp.ones((t, n, 1), bool), jnp.arange(t - 3), jnp.arange(1),
        1 + jnp.arange(2), ScalerParams(jnp.zeros(1), jnp.ones(1)),
        support_ops=ops, batch_size=8)
    p2, _, loss = step(params, opt.init(params), key)
    assert np.isfinite(float(loss))


def test_fused_eval_matches_loader_eval(rng):
    """One-dispatch fused eval == the loader-based Predictor.evaluate
    on the same split (incl. non-divisible item count -> padding)."""
    from sgp.data import (SpatioTemporalDataset, StandardScaler,
                          WindowedLoader, Windowing)
    from sgp.train import Predictor
    from sgp.train.fused_window import make_fused_eval
    from sgp.train.metrics import MaskedMetrics

    t, n, c = 90, 6, 1
    data = rng.standard_normal((t, n, c)).astype(np.float32)
    mask = rng.random((t, n, c)) > 0.1
    ds = SpatioTemporalDataset(data, mask=mask,
                               windowing=Windowing(window=3, horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    model = SGPModel(input_size=c, order=1, n_nodes=n, hidden_size=12,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False)
    metrics = MaskedMetrics.forecasting()
    pred = Predictor(model, metrics=metrics)
    loader = WindowedLoader(ds, batch_size=16)
    first = next(iter(loader))
    pred.init(first, ds.scaler_params())
    expect = pred.evaluate(WindowedLoader(ds, batch_size=16))

    x_full = jnp.asarray(ds.input_array())
    eval_fn = make_fused_eval(
        model, x_full, jnp.asarray(ds.target), jnp.asarray(ds.mask),
        ds.indices(), jnp.asarray(ds.windowing.window_offsets()),
        jnp.asarray(ds.windowing.horizon_offsets()),
        ds.scaler_params(), metrics, batch_size=16)
    got = eval_fn(pred.params)
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=1e-4), k
