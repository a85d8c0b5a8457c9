"""Collate-time SGP propagation loaders vs precomputed-embedding oracle."""
import jax.numpy as jnp
import numpy as np

from sgp.data import SpatioTemporalDataset, Windowing
from sgp.data.sgp_loader import (SGPIIDLoader, SGPLoader, apply_support,
                                 build_support_operators)
from sgp.graph import Graph, coalesce, normalize_adj


def make(rng, t=30, n=12, e=50):
    g = coalesce(Graph(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.random(e).astype(np.float32), n))
    ds = SpatioTemporalDataset(
        rng.standard_normal((t, n, 2)).astype(np.float32), graph=g,
        windowing=Windowing(window=1, horizon=2))
    return ds, g


def test_apply_support_matches_powers(rng):
    ds, g = make(rng)
    ops = build_support_operators(g, k=3)
    x = jnp.asarray(rng.standard_normal((5, 12, 2)).astype(np.float32))
    out = np.asarray(apply_support(x, ops))
    a = normalize_adj(g, "row").to_dense()
    expect = [np.asarray(x)]
    cur = np.asarray(x)
    for _ in range(3):
        cur = np.einsum("ij,tjf->tif", a, cur)
        expect.append(cur)
    np.testing.assert_allclose(out, np.concatenate(expect, -1), atol=1e-4)


def test_sgp_loader_channels(rng):
    ds, g = make(rng)
    ops = build_support_operators(g, k=2, global_attr=True)
    loader = SGPLoader(ds, ops, batch_size=8)
    b = next(iter(loader))
    # channels: (1 + k + global) * 2
    assert b["x"].shape == (8, 1, 12, (1 + 2 + 1) * 2)


def test_sgp_iid_loader_matches_full(rng):
    ds, g = make(rng)
    ops = build_support_operators(g, k=2)
    loader = SGPIIDLoader(ds, ops, batch_size=16, num_batches=1, seed=0)
    b = next(iter(loader))
    assert b["x"].shape == (16, 1, (1 + 2) * 2)  # [B, W, C']
    # oracle: propagate whole series, gather at (t, n)
    a = normalize_adj(g, "row").to_dense()
    x_full = ds.input_array()
    feats = [x_full]
    cur = x_full
    for _ in range(2):
        cur = np.einsum("ij,tjf->tif", a, cur)
        feats.append(cur)
    full = np.concatenate(feats, -1)
    # recover sampled (t, n) from the batch to compare
    # (re-draw with the same seed)
    rng2 = np.random.default_rng(0)
    t_idx = rng2.choice(ds.indices(), 16)
    n_idx = rng2.integers(0, ds.n_nodes, 16)
    np.testing.assert_allclose(np.asarray(b["x"])[:, 0],
                               full[t_idx, n_idx], atol=1e-4)
