"""AZ-whiteness test, profiling hooks, metric extras, imputation ops,
aggregation ops."""
import numpy as np
import pytest

from sgp.analysis import az_whiteness_test
from sgp.data import SpatioTemporalDataset, Windowing
from sgp.data.aggregation import (spatial_aggregate, temporal_aggregate,
                                  temporal_mean)
from sgp.data.imputation import (ImputationDataset, add_missing_values,
                                 sample_mask)
from sgp.graph import Graph, coalesce
from sgp.obs import StepTimer, Throughput, time_fn
from sgp.train.metrics import (masked_pinball, metric_at_steps,
                               masked_mae, multi_loss)


def test_az_whiteness_white_noise(rng):
    """Uncorrelated noise -> high p-value; AR(1)-correlated -> low."""
    t, n = 400, 20
    edges = np.stack([rng.integers(0, n, 60), rng.integers(0, n, 60)])
    white = rng.standard_normal((t, n, 1))
    res = az_whiteness_test(white, edges)
    assert res.pvalue > 0.01
    # serially correlated residuals
    corr = np.cumsum(rng.standard_normal((t, n, 1)) * 0.2, axis=0)
    res2 = az_whiteness_test(corr, edges)
    assert res2.pvalue < 0.01
    assert abs(res2.statistic) > abs(res.statistic)


def test_az_whiteness_multivariate_split(rng):
    t, n = 100, 10
    edges = np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)])
    x = rng.standard_normal((t, n, 3))
    res = az_whiteness_test(x, edges, multivariate=False)
    assert len(res.componentwise_tests) == 3
    assert 0 <= res.pvalue <= 1


def test_step_timer_and_throughput():
    timer = StepTimer()
    for _ in range(3):
        with timer.time("phase"):
            pass
    s = timer.summary()
    assert s["phase"]["count"] == 3
    tp = Throughput()
    tp.start()
    tp.add(1000)
    assert tp.rate() > 0


def test_time_fn():
    import jax.numpy as jnp
    import jax
    f = jax.jit(lambda x: x * 2)
    dt = time_fn(f, jnp.ones(8), iters=3)
    assert dt >= 0


def test_pinball_loss(rng):
    y = np.zeros((4, 2, 1, 1), np.float32)
    y_hat = np.ones_like(y)  # over-prediction by 1
    # q=0.9 penalizes under-prediction more; over-prediction cost = 0.1
    v = float(masked_pinball(y_hat, y, q=0.9))
    assert abs(v - 0.1) < 1e-6
    v2 = float(masked_pinball(-y_hat, y, q=0.9))
    assert abs(v2 - 0.9) < 1e-6


def test_multi_loss_and_wrappers(rng):
    y = rng.standard_normal((4, 6, 2, 1)).astype(np.float32)
    y_hat = rng.standard_normal((4, 6, 2, 1)).astype(np.float32)
    combo = multi_loss([masked_mae, masked_mae], weights=[0.5, 0.5])
    np.testing.assert_allclose(float(combo(y_hat, y)),
                               float(masked_mae(y_hat, y)), rtol=1e-6)
    at = metric_at_steps(masked_mae, [2])
    np.testing.assert_allclose(
        float(at(y_hat, y)),
        float(masked_mae(y_hat[:, 2:3], y[:, 2:3])), rtol=1e-6)


def test_sample_mask_blackouts(rng):
    m = sample_mask((500, 10, 1), p=0.01, p_noise=0.05, min_seq=5,
                    max_seq=10, rng=rng)
    frac = m.mean()
    assert 0.05 < frac < 0.5


def test_imputation_dataset(rng):
    data = rng.standard_normal((60, 8, 1)).astype(np.float32) + 5
    ds = ImputationDataset(data, windowing=Windowing(window=8, horizon=1))
    add_missing_values(ds, p_fault=0.01, p_noise=0.2, seed=1)
    b = ds.gather_batch(np.array([0, 3]))
    ev = ds.covariates["eval_mask"].value.astype(bool)
    # hidden points zeroed in input
    assert (np.asarray(b.x)[0][ev[0:8]] == 0).all()
    # target is the raw window
    np.testing.assert_allclose(b.y[1], data[3:11])
    # trainer contract: mask = training-observed (valid & ~eval),
    # eval_mask = the hidden points
    np.testing.assert_array_equal(b["eval_mask"][0], ev[0:8])
    np.testing.assert_array_equal(b["mask"][0], ~ev[0:8])
    assert not (b["mask"] & b["eval_mask"]).any()


def test_temporal_aggregate(rng):
    x = np.arange(12, dtype=np.float32).reshape(12, 1, 1)
    out = temporal_aggregate(x, 3, "mean")
    np.testing.assert_allclose(out[:, 0, 0], [1, 4, 7, 10])
    out_sum = temporal_aggregate(x, 3, "sum")
    np.testing.assert_allclose(out_sum[:, 0, 0], [3, 12, 21, 30])


def test_spatial_aggregate():
    x = np.ones((4, 6, 1), np.float32)
    clusters = np.array([0, 0, 1, 1, 1, 2])
    out = spatial_aggregate(x, clusters, "sum")
    np.testing.assert_allclose(out[0, :, 0], [2, 3, 1])
    out_m = spatial_aggregate(x, clusters, "mean")
    np.testing.assert_allclose(out_m[0, :, 0], [1, 1, 1])


def test_temporal_mean_seasonal(rng):
    # two weeks of hourly data with a daily pattern
    t = 24 * 14
    index = (np.datetime64("2020-01-06T00:00")  # a Monday
             + np.arange(t) * np.timedelta64(1, "h")).astype("datetime64[ns]")
    pattern = np.sin(2 * np.pi * np.arange(24) / 24)
    x = np.tile(pattern, 14)[:, None].astype(np.float32)
    profile = temporal_mean(x, index)
    np.testing.assert_allclose(profile, x, atol=1e-5)
