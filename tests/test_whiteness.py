

"""Online serving monitor built on the AZ-whiteness test."""
import numpy as np


def test_residual_whiteness_monitor_flags_structure(rng):
    """Rolling serving monitor: white residuals stay unflagged, strong
    spatial correlation across edges gets flagged."""
    from sgp.obs import ResidualWhitenessMonitor

    n = 20
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    mon = ResidualWhitenessMonitor(ring, window=48, alpha=0.01,
                                   min_steps=16)
    res = None
    for t in range(40):
        res = mon.update(rng.standard_normal((n, 1)))
    assert res is not None and not res.flagged

    mon.reset()
    assert mon.update(rng.standard_normal((n, 1))) is None
    for t in range(40):   # one shared value per step -> perfectly
        val = rng.standard_normal()            # edge-correlated
        res = mon.update(np.full((n, 1), val)
                         + 0.01 * rng.standard_normal((n, 1)))
    assert res.flagged and res.pvalue < 1e-4


def test_monitor_uses_graph_edge_weights(rng):
    """A weighted Graph's edge weights flow into the spatial statistic:
    the rolling result matches an offline az_whiteness_test run with the
    same weights (and differs from the unweighted one)."""
    from sgp.analysis import az_whiteness_test
    from sgp.graph import Graph
    from sgp.obs import ResidualWhitenessMonitor

    n, w = 16, 12
    src = np.arange(n)
    dst = (np.arange(n) + 1) % n
    weights = (0.1 + rng.random(n)).astype(np.float32) * 3
    g = Graph(src, dst, weights, n)
    mon = ResidualWhitenessMonitor(g, window=w, min_steps=w)
    x = rng.standard_normal((w, n, 1))
    res = None
    for t in range(w):
        res = mon.update(x[t])
    offline = az_whiteness_test(x, np.stack([src, dst]),
                                edge_weight=np.asarray(weights,
                                                       np.float64))
    assert res.statistic == offline.statistic
    unweighted = az_whiteness_test(x, np.stack([src, dst]))
    assert res.statistic != unweighted.statistic


def test_monitor_rejects_window_smaller_than_min_steps():
    """window < min_steps would cap the buffer below the test gate and
    silently never fire — rejected loudly at construction."""
    import pytest

    from sgp.obs import ResidualWhitenessMonitor

    ring = np.stack([np.arange(4), (np.arange(4) + 1) % 4])
    with pytest.raises(ValueError, match="min_steps"):
        ResidualWhitenessMonitor(ring, window=4, min_steps=8)
    with pytest.raises(ValueError, match="min_steps"):
        ResidualWhitenessMonitor(ring, window=4, min_steps=1)
