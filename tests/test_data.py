"""Data layer: scalers, windowing index math, gather, splitters, loaders."""
import numpy as np
import pytest

from sgp.data import (AtTimeStepSplitter, IIDLoader, RobustScaler,
                      SpatioTemporalDataset, StandardScaler,
                      TemporalSplitter, WindowedLoader, Windowing,
                      datetime_encoded)
from sgp.data.datasets import SyntheticDiffusion


# -- scalers ---------------------------------------------------------------

def test_standard_scaler_roundtrip(rng):
    x = rng.standard_normal((100, 5, 1)).astype(np.float32) * 3 + 7
    s = StandardScaler(axis=(0, 1))
    xt = s.fit_transform(x)
    assert abs(xt.mean()) < 1e-5 and abs(xt.std() - 1) < 1e-4
    np.testing.assert_allclose(s.inverse_transform(xt), x, rtol=1e-4)


def test_standard_scaler_masked(rng):
    x = rng.standard_normal((50, 4, 1)).astype(np.float32)
    mask = rng.random(x.shape) > 0.3
    x_corrupt = np.where(mask, x, 1e6)  # huge values where invalid
    s = StandardScaler(axis=(0, 1)).fit(x_corrupt, mask=mask)
    assert abs(np.asarray(s.bias).item() - x[mask].mean()) < 1e-2
    assert np.asarray(s.scale).item() < 10  # corrupt values excluded


def test_robust_scaler(rng):
    x = rng.standard_normal((1000, 1, 1)).astype(np.float32)
    s = RobustScaler(axis=(0, 1), quantile_range=(10, 90)).fit(x)
    assert abs(np.asarray(s.bias).item() - np.median(x)) < 1e-2


def test_scaler_params_pytree(rng):
    import jax
    x = rng.standard_normal((10, 3, 1)).astype(np.float32)
    p = StandardScaler(axis=0).fit(x).params()
    out = jax.jit(lambda p, x: p.inverse_transform(p.transform(x)))(p, x)
    np.testing.assert_allclose(np.asarray(out), x, rtol=1e-4)


# -- windowing -------------------------------------------------------------

def test_windowing_counts():
    w = Windowing(window=12, horizon=12)
    # reference: indices = arange(0, T - sample_span + 1, stride)
    assert w.sample_span == 24
    assert len(w.indices(100)) == 77
    np.testing.assert_array_equal(w.window_offsets(), np.arange(12))
    np.testing.assert_array_equal(w.horizon_offsets(), 12 + np.arange(12))


def test_windowing_lag():
    # horizon 22 lag 7 -> 4 eval steps (sgp_pv.toml semantics)
    w = Windowing(window=1, horizon=22, horizon_lag=7)
    assert w.horizon_steps == 4
    np.testing.assert_array_equal(w.horizon_offsets(), 1 + np.array([0, 7, 14, 21]))


def test_gather_batch(rng):
    t, n, c = 50, 6, 2
    data = rng.standard_normal((t, n, c)).astype(np.float32)
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=3, horizon=4))
    batch = ds.gather_batch(np.array([0, 5]))
    assert batch.x.shape == (2, 3, n, c)
    assert batch.y.shape == (2, 4, n, c)
    np.testing.assert_allclose(batch.x[1], data[5:8])
    np.testing.assert_allclose(batch.y[1], data[8:12])


def test_gather_batch_scaled_input(rng):
    data = rng.standard_normal((40, 4, 1)).astype(np.float32) * 5 + 3
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=2, horizon=1))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    batch = ds.gather_batch(np.array([3]))
    # x is scaled, y stays raw
    np.testing.assert_allclose(
        batch.x[0], ds.scalers["target"].transform(data[3:5]), rtol=1e-5)
    np.testing.assert_allclose(batch.y[0], data[5:6])


def test_gather_iid_batch(rng):
    t, n = 30, 8
    data = rng.standard_normal((t, n, 1)).astype(np.float32)
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=1, horizon=3))
    b = ds.gather_iid_batch(np.array([2, 10]), np.array([1, 5]))
    assert b.x.shape == (2, 1, 1)
    np.testing.assert_allclose(b.x[0, 0], data[2, 1])
    np.testing.assert_allclose(b.y[1], data[11:14, 5])
    np.testing.assert_array_equal(b.node_index, [1, 5])


def test_exogenous_gather(rng):
    data = rng.standard_normal((20, 3, 1)).astype(np.float32)
    u = rng.standard_normal((20, 2)).astype(np.float32)
    ds = SpatioTemporalDataset(data, covariates={"u": u},
                               windowing=Windowing(window=2, horizon=2))
    b = ds.gather_batch(np.array([0]))
    assert b.u.shape == (1, 2, 2)
    np.testing.assert_allclose(b.u[0], u[0:2])
    np.testing.assert_allclose(b.u_horizon[0], u[2:4])


def test_input_keys_rewire(rng):
    data = rng.standard_normal((20, 3, 1)).astype(np.float32)
    enc = rng.standard_normal((20, 3, 7)).astype(np.float32)
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=1, horizon=2))
    ds.add_covariate("encoded_x", enc)
    ds.set_input_keys(["encoded_x"])
    b = ds.gather_batch(np.array([4]))
    assert b.x.shape == (1, 1, 3, 7)
    np.testing.assert_allclose(b.x[0, 0], enc[4])


def test_reduce(rng):
    data = rng.standard_normal((30, 3, 1)).astype(np.float32)
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=2, horizon=2))
    sub = ds.reduce(np.arange(10, 20))
    assert sub.n_steps == 10
    np.testing.assert_allclose(sub.target, data[10:20])


# -- splitters -------------------------------------------------------------

def _dated_dataset(t=200):
    data = np.arange(t, dtype=np.float32).reshape(t, 1, 1).repeat(2, 1)
    index = (np.datetime64("2020-01-01T00:00")
             + np.arange(t) * np.timedelta64(1, "h")).astype("datetime64[ns]")
    return SpatioTemporalDataset(data, index=index,
                                 windowing=Windowing(window=4, horizon=4))


def test_temporal_splitter():
    ds = _dated_dataset()
    sp = TemporalSplitter(val_len=0.1, test_len=0.2).split(ds)
    assert len(sp.test) > 0 and len(sp.val) > 0
    # reference semantics (samples_offset = ceil(window/stride)): the
    # last train WINDOW ends before the first val window starts (train
    # horizons may still overlap val windows, as in the reference)
    last_train_window_end = (ds.indices()[sp.train[-1]]
                             + ds.windowing.window - 1)
    first_val_step = ds.indices()[sp.val[0]]
    assert last_train_window_end < first_val_step


def test_at_time_step_splitter():
    ds = _dated_dataset()
    sp = AtTimeStepSplitter(
        first_val_ts=(2020, 1, 5, 0, 0),
        last_val_ts=(2020, 1, 7, 0, 0),
        first_test_ts=(2020, 1, 7, 1, 0)).split(ds)
    assert len(sp.train) and len(sp.val) and len(sp.test)
    # reference parity: train covers everything before the first test item
    # (including val items); val and test are disjoint and ordered
    assert sp.train.max() < sp.test.min()
    assert sp.val.max() < sp.test.min()
    # val horizons start after the val timestamp boundary
    first_val_horizon_step = ds.indices()[sp.val.min()] + ds.windowing.horizon_offset
    assert ds.index[first_val_horizon_step] >= np.datetime64("2020-01-05T00:00")


def test_datetime_encoded():
    index = (np.datetime64("2020-01-01T00:00")
             + np.arange(24) * np.timedelta64(1, "h")).astype("datetime64[ns]")
    enc = datetime_encoded(index, "day")
    assert enc.shape == (24, 2)
    # sin at midnight=0, cos=1; at 6:00 sin=1
    np.testing.assert_allclose(enc[0], [0, 1], atol=1e-5)
    np.testing.assert_allclose(enc[6], [1, 0], atol=1e-5)


# -- loaders ---------------------------------------------------------------

def test_windowed_loader(rng):
    ds = SpatioTemporalDataset(
        rng.standard_normal((60, 4, 1)).astype(np.float32),
        windowing=Windowing(window=2, horizon=2))
    loader = WindowedLoader(ds, batch_size=16)
    batches = list(loader)
    assert len(batches) == len(loader)
    assert sum(b.x.shape[0] for b in batches) == len(ds)


def test_iid_loader(rng):
    ds = SpatioTemporalDataset(
        rng.standard_normal((60, 4, 1)).astype(np.float32),
        windowing=Windowing(window=1, horizon=2))
    loader = IIDLoader(ds, batch_size=8, num_batches=3)
    batches = list(loader)
    assert len(batches) == 3
    assert all(b.x.shape == (8, 1, 1) for b in batches)


# -- synthetic dataset -----------------------------------------------------

def test_synthetic_dataset():
    d = SyntheticDiffusion(num_nodes=32, num_steps=300)
    assert d.target.shape == (300, 32, 1)
    g = d.get_connectivity(threshold=0.3, include_self=False)
    assert g.num_edges > 0
    assert (g.src != g.dst).all()
    enc = d.datetime_encoded("day")
    assert enc.shape == (300, 2)
