"""Functional ops and pattern utilities."""
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.data.patterns import broadcast, check_pattern, parse_pattern
from sgp.ops.functional import (expand_then_cat, gated_tanh,
                                reverse_tensor, sparse_multi_head_attention,
                                sparse_softmax)


def test_expand_then_cat(rng):
    a = jnp.asarray(rng.standard_normal((4, 6, 8)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((4, 1, 2)).astype(np.float32))
    out = expand_then_cat([a, b], -1)
    assert out.shape == (4, 6, 10)
    np.testing.assert_allclose(np.asarray(out[..., 8:]),
                               np.broadcast_to(np.asarray(b), (4, 6, 2)))


def test_gated_tanh(rng):
    x = jnp.asarray(rng.standard_normal((3, 8)).astype(np.float32))
    out = np.asarray(gated_tanh(x))
    a, b = np.split(np.asarray(x), 2, -1)
    np.testing.assert_allclose(out, np.tanh(a) / (1 + np.exp(-b)),
                               atol=1e-6)


def test_reverse_tensor(rng):
    x = jnp.arange(12).reshape(2, 6)
    np.testing.assert_array_equal(np.asarray(reverse_tensor(x, 1)),
                                  np.asarray(x)[:, ::-1])


def test_sparse_softmax_sums_to_one(rng):
    scores = jnp.asarray(rng.standard_normal(10).astype(np.float32))
    dst = jnp.asarray(np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3]))
    sm = np.asarray(sparse_softmax(scores, dst, 4))
    for seg in ([0, 1, 2], [3, 4], [5, 6, 7, 8], [9]):
        np.testing.assert_allclose(sm[seg].sum(), 1.0, atol=1e-5)


def test_sparse_mha_matches_dense(rng):
    """On a full bipartite edge list, sparse MHA == dense softmax attn."""
    n, h, d = 5, 2, 4
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    k = rng.standard_normal((n, h, d)).astype(np.float32)
    v = rng.standard_normal((n, h, d)).astype(np.float32)
    src = np.tile(np.arange(n), n)
    dst = np.repeat(np.arange(n), n)
    out = np.asarray(sparse_multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(src), jnp.asarray(dst), n))
    # dense oracle
    logits = np.einsum("nhd,mhd->hnm", q, k) / np.sqrt(d)
    att = np.exp(logits - logits.max(-1, keepdims=True))
    att /= att.sum(-1, keepdims=True)
    expect = np.einsum("hnm,mhd->nhd", att, v)
    np.testing.assert_allclose(out, expect, atol=1e-4)


def test_pattern_parse_and_broadcast(rng):
    assert check_pattern("s n f") == "t n c"
    assert parse_pattern("t c") == ["t", "c"]
    with pytest.raises(ValueError):
        parse_pattern("t x c")
    x = rng.standard_normal((10, 3)).astype(np.float32)  # [t c]
    out = broadcast(x, "t c", "t n c", n=5)
    assert out.shape == (10, 5, 3)
    np.testing.assert_allclose(out[:, 2], x)
