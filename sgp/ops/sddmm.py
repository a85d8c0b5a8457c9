"""Block-sparse SDDMM + attention on the 128x128 BSR structure.

SDDMM (sampled dense-dense matmul) computes ``(Q @ K^T)[i, j]`` ONLY at
the stored positions of a sparse pattern — the kernel behind sparse
graph attention (the reference's edge-list form lives in
``tsl/nn/functional.py:73-161``; ``sgp.ops.functional`` carries the
edge-list parity port). The edge-list form is a random gather per edge;
this module instead samples whole 128x128 blocks of the score matrix so
every step is a batched matmul, reusing the exact BSR packing of
:class:`~sgp.ops.spmm.BSROperator`:

- :func:`bsr_sddmm` — scores at stored blocks.
- :func:`bsr_masked_softmax` — per-destination-row softmax across a
  block row, masked to the true edge positions.
- :func:`bsr_multi_head_attention` — SDDMM -> masked softmax -> block
  SpMM: full sparse attention as batched matmuls.

Build the pattern once per graph with :func:`bsr_attention_structure`;
the result is a pytree of device arrays, safe as a jit argument.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 128


@jax.tree_util.register_pytree_node_class
class BSRAttentionStructure:
    """Static block pattern of a graph's adjacency, for attention.

    ``mask_blocks`` marks the TRUE edge positions inside each stored
    block (BSR stores whole 128x128 tiles; a tile at a nonzero block
    position still has zeros where no edge exists — attention must not
    attend there). Built from unit edge weights so explicit zero-weight
    edges stay attendable. A pytree whose sizes are static aux data,
    so instances pass through jit boundaries as arguments."""

    def __init__(self, block_rows, block_cols, mask_blocks,
                 n_block_rows: int, num_nodes: int):
        self.block_rows = block_rows     # [nnzb] int32, sorted
        self.block_cols = block_cols     # [nnzb] int32
        self.mask_blocks = mask_blocks   # [nnzb, B, B] bool
        self.n_block_rows = int(n_block_rows)
        self.num_nodes = int(num_nodes)

    def tree_flatten(self):
        return ((self.block_rows, self.block_cols, self.mask_blocks),
                (self.n_block_rows, self.num_nodes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def bsr_attention_structure(g) -> BSRAttentionStructure:
    """Pack a host :class:`~sgp.graph.sparse.Graph`'s connectivity
    into the block pattern (host-side, once per graph)."""
    from sgp.graph.sparse import Graph

    unit = Graph(g.src, g.dst, np.ones(len(g.src), np.float32),
                 g.num_nodes)
    blocks, cols, ptr = unit.to_bsr(BLOCK)
    rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int32),
                     np.diff(ptr))
    return BSRAttentionStructure(
        jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(blocks != 0.0), len(ptr) - 1, g.num_nodes)


def _pad_tiles(x: jnp.ndarray, n_block_rows: int) -> jnp.ndarray:
    """[N, D] -> [n_block_rows, B, D_pad] node tiles (zero padded)."""
    n, d = x.shape
    d_pad = ((d + BLOCK - 1) // BLOCK) * BLOCK
    out = jnp.zeros((n_block_rows * BLOCK, d_pad), x.dtype)
    out = out.at[:n, :d].set(x)
    return out.reshape(n_block_rows, BLOCK, d_pad)


def bsr_sddmm_xla(q: jnp.ndarray, k: jnp.ndarray,
                  block_rows: jnp.ndarray, block_cols: jnp.ndarray,
                  n_block_rows: int) -> jnp.ndarray:
    """Scores ``Q @ K^T`` at the stored blocks: gather the q/k node
    tiles per block, ONE batched matmul. q/k: [N, D]; returns
    [nnzb, B, B] f32 (full f32 precision for f32 inputs)."""
    qt = _pad_tiles(q, n_block_rows)[block_rows]      # [nnzb, B, D]
    kt = _pad_tiles(k, n_block_rows)[block_cols]      # [nnzb, B, D]
    prec = (jax.lax.Precision.HIGHEST
            if q.dtype == jnp.float32 else None)
    return jax.lax.dot_general(
        qt, kt, (((2,), (2,)), ((0,), (0,))),
        precision=prec, preferred_element_type=jnp.float32)


def bsr_sddmm(q: jnp.ndarray, k: jnp.ndarray,
              struct: BSRAttentionStructure) -> jnp.ndarray:
    """[nnzb, B, B] f32 scores at the stored blocks."""
    if struct.block_rows.shape[0] == 0:
        return jnp.zeros((0, BLOCK, BLOCK), jnp.float32)
    return bsr_sddmm_xla(q, k, struct.block_rows, struct.block_cols,
                         struct.n_block_rows)


def bsr_masked_softmax(logit_blocks: jnp.ndarray,
                       struct: BSRAttentionStructure) -> jnp.ndarray:
    """Softmax over each destination row's TRUE edges, across all the
    row's stored blocks. Rows with no edges produce zero weights."""
    neg = jnp.finfo(jnp.float32).min
    l = jnp.where(struct.mask_blocks, logit_blocks, neg)
    # per-block row maxima -> per-destination-row maxima
    m_blk = l.max(axis=2)                                # [nnzb, B]
    m_row = jax.ops.segment_max(m_blk, struct.block_rows,
                                num_segments=struct.n_block_rows,
                                indices_are_sorted=True)  # [nbr, B]
    m_row = jnp.maximum(m_row, neg)      # empty rows: -inf -> finite
    p = jnp.where(struct.mask_blocks,
                  jnp.exp(l - m_row[struct.block_rows][:, :, None]),
                  0.0)
    denom = jax.ops.segment_sum(p.sum(axis=2), struct.block_rows,
                                num_segments=struct.n_block_rows,
                                indices_are_sorted=True)  # [nbr, B]
    # NOT 1e-38: subnormal in f32, flushed to zero by XLA -> 0/0
    denom = jnp.maximum(denom, 1e-30)
    return p / denom[struct.block_rows][:, :, None]


def _block_spmv(att_blocks: jnp.ndarray, v: jnp.ndarray,
                struct: BSRAttentionStructure) -> jnp.ndarray:
    """att @ v with the attention weights in block form (the SpMM tail
    of attention; same batched-matmul + sorted-segment-sum scheme as
    :func:`~sgp.ops.spmm.bsr_spmm_xla`)."""
    vt = _pad_tiles(v, struct.n_block_rows)[struct.block_cols]
    mm = jax.lax.dot_general(
        att_blocks, vt.astype(jnp.float32),
        (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    agg = jax.ops.segment_sum(mm, struct.block_rows,
                              num_segments=struct.n_block_rows,
                              indices_are_sorted=True)
    out = agg.reshape(struct.n_block_rows * BLOCK, -1)
    return out[:struct.num_nodes, :v.shape[-1]].astype(v.dtype)


def bsr_multi_head_attention(q: jnp.ndarray, k: jnp.ndarray,
                             v: jnp.ndarray,
                             struct: BSRAttentionStructure,
                             scale: float | None = None) -> jnp.ndarray:
    """Sparse multi-head attention with block-sampled scores: per-edge
    logits ``<q_dst, k_src>``, softmax over each node's in-edges,
    weighted value aggregation — numerically the edge-list
    ``sparse_multi_head_attention`` (``ops/functional.py:53``), with
    gather/scatter replaced by batched block matmuls. q/k/v: [N, H, D];
    returns [N, H, D]."""
    d = q.shape[-1]
    s = scale if scale is not None else d ** -0.5

    def head(qh, kh, vh):
        logits = bsr_sddmm(qh, kh, struct) * s
        att = bsr_masked_softmax(logits, struct)
        return _block_spmv(att, vh, struct)

    out = jax.vmap(head, in_axes=1, out_axes=1)(q, k, v)
    return out
