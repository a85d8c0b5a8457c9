"""Device SpMM paths vs dense oracle; segment ops; power iteration."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.ops import (build_operator, power_iteration_spectral_radius,
                     segment_mean, segment_softmax, segment_sum, spmm)
from sgp.ops.linalg import spectral_radius_exact


def random_graph(rng, n=50, e=300):
    g = Graph(rng.integers(0, n, e), rng.integers(0, n, e),
              rng.random(e).astype(np.float32), n)
    return normalize_adj(coalesce(g), "row")


@pytest.mark.parametrize("mode", ["dense", "coo", "bsr"])
def test_spmm_matches_dense_oracle(rng, mode):
    g = random_graph(rng)
    x = rng.standard_normal((g.num_nodes, 16)).astype(np.float32)
    expect = g.to_dense() @ x
    op = build_operator(g, mode=mode)
    out = np.asarray(spmm(op, jnp.asarray(x)))
    np.testing.assert_allclose(out, expect, atol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "coo"])
def test_spmm_batched(rng, mode):
    g = random_graph(rng, n=17, e=60)
    x = rng.standard_normal((3, 4, g.num_nodes, 8)).astype(np.float32)
    expect = np.einsum("ij,btjf->btif", g.to_dense(), x)
    op = build_operator(g, mode=mode)
    out = np.asarray(spmm(op, jnp.asarray(x)))
    np.testing.assert_allclose(out, expect, atol=1e-4)


def test_bsr_spmm_large_multiblock(rng):
    g = random_graph(rng, n=400, e=4000)
    x = rng.standard_normal((g.num_nodes, 200)).astype(np.float32)
    expect = g.to_dense() @ x
    out = np.asarray(spmm(build_operator(g, "bsr"), jnp.asarray(x)))
    np.testing.assert_allclose(out, expect, atol=1e-3)


def test_bsr_spmm_with_empty_block_rows(rng):
    # all edges land in the first 100 nodes -> later block rows are empty
    g = Graph(rng.integers(0, 100, 500), rng.integers(0, 100, 500),
              rng.random(500).astype(np.float32), 400)
    g = coalesce(g)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    expect = g.to_dense() @ x
    out = np.asarray(spmm(build_operator(g, "bsr"), jnp.asarray(x)))
    np.testing.assert_allclose(out, expect, atol=1e-4)


def test_global_mean_operator(rng):
    from sgp.ops import GlobalMeanOperator
    x = rng.standard_normal((4, 10, 3)).astype(np.float32)
    out = np.asarray(GlobalMeanOperator(10) @ jnp.asarray(x))
    expect = np.broadcast_to(x.mean(axis=-2, keepdims=True), x.shape)
    np.testing.assert_allclose(out, expect, atol=1e-6)


def test_operator_through_jit(rng):
    g = random_graph(rng, n=20, e=60)
    op = build_operator(g, "coo")
    x = jnp.asarray(rng.standard_normal((20, 4)).astype(np.float32))

    @jax.jit
    def f(op, x):
        return spmm(op, x)

    np.testing.assert_allclose(np.asarray(f(op, x)),
                               g.to_dense() @ np.asarray(x), atol=1e-4)


def test_segment_ops(rng):
    data = jnp.asarray(rng.standard_normal((6, 3)).astype(np.float32))
    ids = jnp.array([0, 0, 1, 2, 2, 2])
    s = np.asarray(segment_sum(data, ids, 3))
    np.testing.assert_allclose(s[0], np.asarray(data)[:2].sum(0), atol=1e-6)
    m = np.asarray(segment_mean(data, ids, 3))
    np.testing.assert_allclose(m[2], np.asarray(data)[3:].mean(0), atol=1e-6)


def test_segment_softmax(rng):
    scores = jnp.asarray(rng.standard_normal(7).astype(np.float32))
    ids = jnp.array([0, 0, 0, 1, 1, 2, 2])
    sm = np.asarray(segment_softmax(scores, ids, 3))
    np.testing.assert_allclose(sm[:3].sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(sm[3:5].sum(), 1.0, atol=1e-5)


def test_power_iteration_matches_eigvals(rng):
    w = rng.standard_normal((64, 64)).astype(np.float32) / 8
    exact = spectral_radius_exact(w)
    approx = float(power_iteration_spectral_radius(jnp.asarray(w)))
    assert abs(approx - exact) / exact < 1e-3


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_bsr_variants_match_oracle(rng, precision):
    """BSR SpMM with f32 block storage (precision 'highest') and bf16
    block storage (precision 'default', f32 accumulation) against the
    dense f32 product."""
    g = random_graph(rng, n=300, e=3000)
    x = rng.standard_normal((g.num_nodes, 96)).astype(np.float32)
    expect = g.to_dense() @ x
    op = build_operator(g, "bsr", precision=precision)
    assert op.blocks.dtype == (jnp.float32 if precision == "highest"
                               else jnp.bfloat16)
    atol = 1e-4 if precision == "highest" else 0.1
    out = np.asarray(spmm(op, jnp.asarray(x)))
    np.testing.assert_allclose(out, expect, atol=atol)
    # and through a jit boundary as a pytree argument
    out2 = np.asarray(jax.jit(lambda o, v: o @ v)(op, jnp.asarray(x)))
    np.testing.assert_allclose(out2, expect, atol=atol)
