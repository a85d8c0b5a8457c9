"""Subgraph/subset sampling: static shapes, root-only loss, device-side
support construction."""
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.data import SpatioTemporalDataset, Windowing
from sgp.data.subgraph import SubgraphLoader, SubsetLoader, cap_edges
from sgp.graph import Graph, coalesce, normalize_adj
from sgp.models.graph_layers import (diff_conv_support,
                                     diff_conv_support_from_arrays)


def make_ds(rng, t=50, n=30, e=200):
    g = coalesce(Graph(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.random(e).astype(np.float32), n))
    ds = SpatioTemporalDataset(
        rng.standard_normal((t, n, 1)).astype(np.float32), graph=g,
        windowing=Windowing(window=4, horizon=4))
    return ds, g


def test_subset_loader(rng):
    ds, _ = make_ds(rng)
    loader = SubsetLoader(ds, batch_size=8, num_nodes=10, limit_batches=3)
    batches = list(loader)
    assert len(batches) == 3
    for b in batches:
        assert b.x.shape == (8, 4, 10, 1)
        assert len(b.target_nodes) == 10


def test_subgraph_loader_static_shapes(rng):
    ds, g = make_ds(rng)
    loader = SubgraphLoader(ds, batch_size=4, num_roots=5, k=2,
                            max_edges=64, pad_nodes=20, limit_batches=4)
    shapes = set()
    for b in loader:
        shapes.add((b.x.shape, b.sub_src.shape, b.sub_dst.shape))
        assert b.x.shape == (4, 4, 20, 1)
        assert b.sub_src.shape == (64,)
        # roots are inside the node set
        assert (b.target_nodes < 20).all()
    assert len(shapes) == 1  # static across batches -> no recompiles


def test_subgraph_root_features_correct(rng):
    ds, g = make_ds(rng)
    loader = SubgraphLoader(ds, batch_size=2, num_roots=3, k=1,
                            max_edges=100, pad_nodes=15, limit_batches=1,
                            shuffle=False, seed=1)
    b = next(iter(loader))
    # x values at each node position match the dataset at node_index
    items = np.arange(len(ds))[:2]
    full = ds.gather_batch(items)
    np.testing.assert_allclose(b.x, full.x[:, :, b.node_index, :])


def test_cap_edges(rng):
    g = coalesce(Graph(rng.integers(0, 20, 500), rng.integers(0, 20, 500),
                       rng.random(500).astype(np.float32), 20))
    capped = cap_edges(g, 50, rng, uniform=True)
    assert capped.num_edges == 50
    capped_w = cap_edges(g, 50, rng, uniform=False)
    assert capped_w.num_edges == 50


def test_support_from_padded_arrays(rng):
    """Device-side normalized supports from zero-padded edges must match
    host-side supports of the unpadded graph."""
    g = coalesce(Graph(rng.integers(0, 12, 60), rng.integers(0, 12, 60),
                       rng.random(60).astype(np.float32), 12))
    host = diff_conv_support(g, operator_mode="dense")
    e_pad = 100
    src = np.zeros(e_pad, np.int32)
    dst = np.zeros(e_pad, np.int32)
    w = np.zeros(e_pad, np.float32)
    src[:g.num_edges] = g.src
    dst[:g.num_edges] = g.dst
    w[:g.num_edges] = g.weight
    dev = diff_conv_support_from_arrays(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(w), 12)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    for h_op, d_op in zip(host, dev):
        np.testing.assert_allclose(np.asarray(d_op @ jnp.asarray(x)),
                                   np.asarray(h_op @ jnp.asarray(x)),
                                   atol=1e-5)
