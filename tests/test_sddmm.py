"""Block-sparse SDDMM + attention vs dense and edge-list oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph.sparse import Graph, coalesce
from sgp.ops.functional import sparse_multi_head_attention
from sgp.ops.sddmm import (bsr_attention_structure, bsr_sddmm,
                           bsr_masked_softmax,
                           bsr_multi_head_attention)


def _graph(rng, n=300, e=2500):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.standard_normal(e).astype(np.float32)
    return coalesce(Graph(src, dst, w, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_matches_dense(rng, dtype):
    """Scores at stored blocks equal the dense Q @ K^T there (f32
    oracle; bf16 inputs accumulate in f32, within bf16 input rounding)."""
    g = _graph(rng)
    struct = bsr_attention_structure(g)
    d = 40   # non-multiple of 128: exercises lane padding
    q = jnp.asarray(rng.standard_normal((g.num_nodes, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((g.num_nodes, d)), jnp.float32)
    blocks = np.asarray(bsr_sddmm(q.astype(dtype), k.astype(dtype),
                                  struct))
    assert blocks.dtype == np.float32
    atol = 1e-4 if dtype == "float32" else 0.15
    dense = np.asarray(q) @ np.asarray(k).T
    br = np.asarray(struct.block_rows)
    bc = np.asarray(struct.block_cols)
    n = g.num_nodes
    for b in range(len(br)):
        r0, c0 = br[b] * 128, bc[b] * 128
        want = np.zeros((128, 128), np.float32)
        rs, cs = min(128, n - r0), min(128, n - c0)
        want[:rs, :cs] = dense[r0:r0 + rs, c0:c0 + cs]
        np.testing.assert_allclose(blocks[b], want, atol=atol)


def test_masked_softmax_rows_sum_to_one(rng):
    g = _graph(rng)
    struct = bsr_attention_structure(g)
    q = jnp.asarray(rng.standard_normal((g.num_nodes, 16)), jnp.float32)
    att = np.asarray(bsr_masked_softmax(
        bsr_sddmm(q, q, struct), struct))
    mask = np.asarray(struct.mask_blocks)
    # never attends outside true edges
    assert (att[~mask] == 0).all()
    # each destination row with >=1 edge sums to 1
    br = np.asarray(struct.block_rows)
    n_rows = struct.n_block_rows * 128
    sums = np.zeros(n_rows)
    cnts = np.zeros(n_rows)
    for b in range(att.shape[0]):
        rows = br[b] * 128 + np.arange(128)
        sums[rows] += att[b].sum(1)
        cnts[rows] += mask[b].sum(1)
    np.testing.assert_allclose(sums[cnts > 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(sums[cnts == 0], 0.0, atol=0)


def test_block_attention_matches_edge_list(rng):
    """The block-sparse MHA equals the edge-list oracle
    (``ops/functional.py::sparse_multi_head_attention``) on the same
    graph."""
    g = _graph(rng, n=200, e=1500)
    struct = bsr_attention_structure(g)
    h, d = 2, 8
    q = jnp.asarray(rng.standard_normal((g.num_nodes, h, d)),
                    jnp.float32)
    k = jnp.asarray(rng.standard_normal((g.num_nodes, h, d)),
                    jnp.float32)
    v = jnp.asarray(rng.standard_normal((g.num_nodes, h, d)),
                    jnp.float32)
    got = np.asarray(bsr_multi_head_attention(q, k, v, struct))
    want = np.asarray(sparse_multi_head_attention(
        q, k, v, jnp.asarray(g.src), jnp.asarray(g.dst), g.num_nodes))
    # nodes with no incoming edge: block path gives 0, edge-list gives
    # 0 as well (segment_sum over empty) — compare everywhere
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_block_attention_jit_structure_as_arg(rng):
    """The structure is a pytree usable as a jit argument."""
    g = _graph(rng, n=150, e=900)
    struct = bsr_attention_structure(g)
    q = jnp.asarray(rng.standard_normal((g.num_nodes, 1, 8)),
                    jnp.float32)
    f = jax.jit(lambda qq, s: bsr_multi_head_attention(qq, qq, qq, s))
    out = f(q, struct)
    assert out.shape == q.shape
    assert np.isfinite(np.asarray(out)).all()
