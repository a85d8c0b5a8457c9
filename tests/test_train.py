"""Training engine: metrics vs oracles, ridge vs sklearn, and the
end-to-end SGP slice on synthetic data (SURVEY.md §7.2)."""
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.data import (SpatioTemporalDataset, StandardScaler,
                      TemporalSplitter, WindowedLoader, Windowing)
from sgp.data.datasets import SyntheticDiffusion
from sgp.encode import SGPEncoder, encode_dataset
from sgp.models import SGPModel
from sgp.train import (MaskedMetrics, Predictor, masked_mae, masked_mape,
                       masked_mre, masked_mse, ridge_regression)
from sgp.train.metrics import MetricSpec


def test_masked_metrics_oracle(rng):
    y_hat = rng.standard_normal((8, 4, 3, 1)).astype(np.float32)
    y = rng.standard_normal((8, 4, 3, 1)).astype(np.float32)
    mask = rng.random(y.shape) > 0.3
    err = np.abs(y_hat - y)
    expect_mae = err[mask].mean()
    assert abs(float(masked_mae(y_hat, y, mask)) - expect_mae) < 1e-5
    expect_mse = ((y_hat - y) ** 2)[mask].mean()
    assert abs(float(masked_mse(y_hat, y, mask)) - expect_mse) < 1e-5
    expect_mre = err[mask].sum() / np.abs(y[mask]).sum()
    assert abs(float(masked_mre(y_hat, y, mask)) - expect_mre) < 1e-5


def test_metric_accumulation_matches_oneshot(rng):
    m = MaskedMetrics({"mae": MetricSpec("mae"),
                       "mae_at_2": MetricSpec("mae", at=2)})
    state = m.init()
    ys, yhs, masks = [], [], []
    for _ in range(3):
        y = rng.standard_normal((4, 5, 2, 1)).astype(np.float32)
        y_hat = rng.standard_normal((4, 5, 2, 1)).astype(np.float32)
        mask = rng.random(y.shape) > 0.2
        state = m.update(state, jnp.asarray(y_hat), jnp.asarray(y),
                         jnp.asarray(mask))
        ys.append(y); yhs.append(y_hat); masks.append(mask)
    out = m.compute(state)
    y, y_hat, mask = (np.concatenate(a) for a in (ys, yhs, masks))
    assert abs(out["mae"] - float(masked_mae(y_hat, y, mask))) < 1e-5
    assert abs(out["mae_at_2"]
               - float(masked_mae(y_hat[:, 2:3], y[:, 2:3],
                                  mask[:, 2:3]))) < 1e-5


def test_ridge_matches_sklearn(rng):
    from sklearn.linear_model import Ridge
    x = rng.standard_normal((500, 20)).astype(np.float32)
    y = rng.standard_normal((500, 3)).astype(np.float32)
    w, b = ridge_regression(x, y, alpha=0.5)
    ref = Ridge(alpha=0.5).fit(x, y)
    np.testing.assert_allclose(np.asarray(w), ref.coef_.T, atol=2e-3)
    np.testing.assert_allclose(np.asarray(b), ref.intercept_, atol=2e-3)
    # chunked accumulation gives the same result
    w2, b2 = ridge_regression(x, y, alpha=0.5, chunk=128)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-4)


def test_sgp_end_to_end_synthetic():
    """The minimum end-to-end slice: encode + train decoder on synthetic
    data, assert the model beats predicting the training mean."""
    d = SyntheticDiffusion(num_nodes=24, num_steps=600, seed=1)
    g = d.get_connectivity(threshold=0.3, include_self=False)
    ds = SpatioTemporalDataset(
        d.target, index=d.index, mask=d.mask, graph=g,
        covariates={"u": d.datetime_encoded("day")},
        windowing=Windowing(window=1, horizon=4))
    split = TemporalSplitter(val_len=0.1, test_len=0.2).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])
    enc = SGPEncoder(input_size=3, reservoir_size=16, reservoir_layers=2,
                     alpha_decay=True, receptive_field=2,
                     bidirectional=True, global_attr=True, seed=0)
    encode_dataset(ds, enc, encode_exogenous=True, keep_raw=False)

    order = (1 + 2 * 2 + 1) * 2
    model = SGPModel(input_size=enc.output_size, order=order,
                     n_nodes=ds.n_nodes, hidden_size=96, mlp_size=32,
                     output_size=1, n_layers=1, horizon=4,
                     positional_encoding=True, resnet=True)
    pred = Predictor(model, lr=5e-3, steps_per_epoch=20)
    train_loader = WindowedLoader(ds, split.train, batch_size=64,
                                  shuffle=True, limit_batches=20)
    val_loader = WindowedLoader(ds, split.val, batch_size=64)
    test_loader = WindowedLoader(ds, split.test, batch_size=64)
    pred.fit(train_loader, val_loader, epochs=5, scaler=ds.scaler_params(),
             log_every=0)
    res = pred.evaluate(test_loader, prefix="test_")
    # naive baseline: predict the global training mean
    mean = ds.target[ds.indices()[split.train]].mean()
    test_items = split.test
    b = ds.gather_batch(test_items)
    naive = float(masked_mae(np.full_like(b.y, mean), b.y, b.mask))
    assert res["test_mae"] < 0.7 * naive, (res, naive)


def test_predictor_checkpoint_roundtrip(tmp_path, rng):
    ds = SpatioTemporalDataset(
        rng.standard_normal((80, 6, 1)).astype(np.float32),
        windowing=Windowing(window=1, horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    ds.add_covariate("encoded_x",
                     rng.standard_normal((80, 6, 8)).astype(np.float32))
    ds.set_input_keys(["encoded_x"])
    model = SGPModel(input_size=8, order=2, n_nodes=6, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False)
    pred = Predictor(model, lr=1e-3)
    loader = WindowedLoader(ds, batch_size=16)
    pred.fit(loader, epochs=1, scaler=ds.scaler_params(), log_every=0)
    path = str(tmp_path / "ckpt.npz")
    pred.save(path)
    before = pred.predict(loader)
    pred.load(path)
    np.testing.assert_allclose(pred.predict(loader), before, atol=1e-6)
