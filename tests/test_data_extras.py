"""Dataset persistence, windowing context, datetime one-hots, MTS
benchmark loader plumbing."""
import numpy as np
import pytest

from sgp.data import SpatioTemporalDataset, Windowing
from sgp.data.splitters import datetime_onehot
from sgp.graph import Graph, coalesce


def make_ds(rng, t=40, n=6):
    g = coalesce(Graph(rng.integers(0, n, 20), rng.integers(0, n, 20),
                       rng.random(20).astype(np.float32), n))
    index = (np.datetime64("2021-03-01T00:00")
             + np.arange(t) * np.timedelta64(30, "m")
             ).astype("datetime64[ns]")
    ds = SpatioTemporalDataset(
        rng.standard_normal((t, n, 1)).astype(np.float32), index=index,
        graph=g, covariates={"u": rng.standard_normal(
            (t, 2)).astype(np.float32)},
        windowing=Windowing(window=3, horizon=4))
    return ds


def test_save_load_roundtrip(rng, tmp_path):
    ds = make_ds(rng)
    path = str(tmp_path / "ds.npz")
    ds.save(path)
    ds2 = SpatioTemporalDataset.load(path)
    np.testing.assert_allclose(ds2.target, ds.target)
    np.testing.assert_array_equal(ds2.index, ds.index)
    np.testing.assert_allclose(ds2.covariates["u"].value,
                               ds.covariates["u"].value)
    assert ds2.windowing == ds.windowing
    np.testing.assert_allclose(ds2.graph.to_dense(), ds.graph.to_dense())
    b1, b2 = ds.gather_batch([0, 1]), ds2.gather_batch([0, 1])
    np.testing.assert_allclose(b1.x, b2.x)


def test_change_windowing_context(rng):
    ds = make_ds(rng)
    base_len = len(ds)
    with ds.change_windowing(window=1, horizon=1):
        assert ds.windowing.window == 1
        assert len(ds) > base_len
    assert ds.windowing.window == 3
    assert len(ds) == base_len


def test_overlapping_indices(rng):
    ds = make_ds(rng)
    over = ds.overlapping_indices([0, 1, 30], [2])
    assert 0 in over and 1 in over and 30 not in over


def test_datetime_onehot():
    index = (np.datetime64("2021-03-01T00:00")  # a Monday
             + np.arange(48) * np.timedelta64(1, "h")
             ).astype("datetime64[ns]")
    enc = datetime_onehot(index, ["weekday", "hour"])
    assert enc.shape == (48, 31)
    assert enc[0, 0] == 1  # Monday
    assert enc[25, 1] == 1  # Tuesday
    np.testing.assert_allclose(enc.sum(-1), 2.0)


def test_mts_benchmark_loader(rng, tmp_path):
    from sgp.data.datasets.mts_benchmarks import ElectricityBenchmark
    root = tmp_path / "ElectricityBenchmark"
    root.mkdir()
    vals = rng.random((100, 5)).astype(np.float32)
    np.savetxt(root / "electricity.txt", vals, delimiter=",")
    d = ElectricityBenchmark(root=str(root))
    assert d.target.shape == (100, 5, 1)
    sim = d.get_similarity("pearson")
    assert sim.shape == (5, 5)
    g = d.get_connectivity(method="pearson", knn=2, include_self=False)
    assert g.num_edges > 0


def test_holidays_onehot():
    from sgp.data.splitters import holidays_onehot
    index = (np.datetime64("2021-12-24T00:00")
             + np.arange(5 * 24) * np.timedelta64(1, "h")
             ).astype("datetime64[ns]")
    out = holidays_onehot(index, holidays_list=["2021-12-25"])
    assert out.shape == (120, 1)
    assert out[24:48].all() and not out[:24].any()


def test_disjoint_months_window_disjoint():
    """disjoint_months: items fully inside the months vs fully outside;
    straddlers dropped from both (tsl splitters.py:287-312)."""
    import numpy as np
    from sgp.data import (SpatioTemporalDataset, Windowing,
                          disjoint_months)
    t = 24 * 90                       # ~3 months hourly from Jan 1
    index = (np.datetime64("2020-01-01T00:00")
             + np.arange(t) * np.timedelta64(1, "h"))
    ds = SpatioTemporalDataset(
        np.random.default_rng(0).random((t, 4, 1)).astype(np.float32),
        index=index,
        windowing=Windowing(window=24, horizon=12))
    other, feb = disjoint_months(ds, months=2)
    starts = ds.indices()
    month_of = index.astype("datetime64[M]").astype(int) % 12 + 1
    w_start = month_of[starts]
    w_end = month_of[starts + 23]
    assert np.all(w_start[feb] == 2) and np.all(w_end[feb] == 2)
    assert np.all(w_start[other] != 2) and np.all(w_end[other] != 2)
    # straddlers in neither set
    assert len(other) + len(feb) < len(starts)
    # horizon mode selects by the horizon steps instead
    _, feb_h = disjoint_months(ds, months=2, synch_mode="horizon")
    ho = ds.windowing.horizon_offset
    assert np.all(month_of[starts[feb_h] + ho] == 2)


def test_disjoint_months_splitter():
    import numpy as np
    from sgp.data import (DisjointMonthsSplitter,
                          SpatioTemporalDataset, Windowing)
    t = 24 * 120
    index = (np.datetime64("2020-01-01T00:00")
             + np.arange(t) * np.timedelta64(1, "h"))
    ds = SpatioTemporalDataset(
        np.random.default_rng(0).random((t, 3, 1)).astype(np.float32),
        index=index,
        windowing=Windowing(window=12, horizon=6))
    sp = DisjointMonthsSplitter(val_months=(3,), test_months=(4,)
                                ).split(ds)
    assert len(sp.train) and len(sp.val) and len(sp.test)
    assert not np.intersect1d(sp.train, sp.val).size
    assert not np.intersect1d(sp.train, sp.test).size
    assert not np.intersect1d(sp.val, sp.test).size


def test_dummy_graph():
    import numpy as np
    from sgp.graph import dummy_graph
    assert dummy_graph("none", 5) is None
    ident = dummy_graph("identity", 5)
    assert ident.num_edges == 5 and np.all(ident.src == ident.dst)
    full = dummy_graph("full", 6)
    assert full.num_edges == 36
    rnd = dummy_graph("random", 50, edge_prob=0.2, directed=False)
    d = rnd.to_scipy().toarray()
    assert np.allclose(d, d.T)        # symmetrized
    assert 0 < rnd.num_edges < 50 * 49
