"""Device-side sparse matrix × dense matrix products (the propagation op).

Replacement for torch_sparse's ``SparseTensor @ x``
(``lib/sgp_preprocessing.py:200-203``, ``lib/nn/reservoir/
graph_reservoir.py:82-83``, ``tsl/nn/layers/graph_convs/diff_conv.py``).

Three interchangeable operator representations, all jit-compatible pytrees:

- :class:`DenseOperator` — the operator materialized dense ``[N, N]``;
  ``x' = A @ x`` is a single matmul. Used for every benchmark graph in the
  reference (N <= 6,435; density 1.5-15%).
- :class:`BSROperator` — 128x128 block-sparse rows: a tile gather, one
  batched matmul over the stored blocks and a sorted segment-sum; for
  graphs too large for a dense operator that are block-structured.
- :class:`COOOperator` — gather + ``segment_sum``; the fallback and
  correctness oracle, and the only O(E) path for extremely sparse graphs.

``build_operator`` picks a representation from graph size/density.
"""
from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from sgp.graph.sparse import Graph


@jax.tree_util.register_pytree_node_class
class DenseOperator:
    """Dense ``A[dst, src]``; propagation is one matmul.

    ``precision`` is the matmul precision for float32 inputs:
    ``'highest'`` (default) gives full f32 accuracy for parity with the
    reference's fp32 SpMM; ``'default'`` lets the backend round the
    inputs (TF32 on NVIDIA tensor cores) — fine for training, not for
    activation-allclose checks.
    """

    def __init__(self, mat: jnp.ndarray, precision: str = "highest"):
        self.mat = mat
        self.precision = precision

    @property
    def num_nodes(self) -> int:
        return self.mat.shape[0]

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        # x: [..., N, F] -> contract over N
        return jnp.einsum("ij,...jf->...if", self.mat, x,
                          precision=self.precision,
                          preferred_element_type=jnp.float32
                          ).astype(x.dtype)

    def transpose(self) -> "DenseOperator":
        return DenseOperator(self.mat.T, self.precision)

    def tree_flatten(self):
        return (self.mat,), self.precision

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux)


@jax.tree_util.register_pytree_node_class
class COOOperator:
    """COO gather/segment-sum: ``out[d] += w_e * x[s_e]``."""

    def __init__(self, src, dst, weight, num_nodes: int):
        self.src = src
        self.dst = dst
        self.weight = weight
        self._num_nodes = int(num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim == 2:  # [N, F]
            msgs = x[self.src] * self.weight[:, None]
            return jax.ops.segment_sum(msgs, self.dst,
                                       num_segments=self._num_nodes)
        # [..., N, F]: flatten leading dims, vmap the 2-D case
        lead = x.shape[:-2]
        flat = x.reshape((-1,) + x.shape[-2:])
        out = jax.vmap(lambda xi: self @ xi)(flat)
        return out.reshape(lead + out.shape[-2:])

    def transpose(self) -> "COOOperator":
        return COOOperator(self.dst, self.src, self.weight, self._num_nodes)

    def tree_flatten(self):
        return (self.src, self.dst, self.weight), self._num_nodes

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux)


def bsr_spmm_xla(blocks: jnp.ndarray,        # [nnzb, B, B]
                 block_cols: jnp.ndarray,    # [nnzb]
                 block_rows: jnp.ndarray,    # [nnzb] (sorted)
                 x: jnp.ndarray, num_nodes: int,
                 n_block_rows: int) -> jnp.ndarray:
    """BSR SpMM: gather the x tile per stored block (one wide tile
    gather), ONE batched matmul over all blocks, then a sorted
    segment-sum over block rows. bf16 blocks move x as bf16 too and
    accumulate in f32; f32 blocks multiply at full f32 precision."""
    block = blocks.shape[-1]
    f = x.shape[-1]
    n_pad = n_block_rows * block
    xdt = jnp.bfloat16 if blocks.dtype == jnp.bfloat16 else x.dtype
    x_pad = jnp.zeros((n_pad, f), xdt)
    x_pad = x_pad.at[:x.shape[0]].set(x.astype(xdt))
    xt = x_pad.reshape(n_block_rows, block, f)[block_cols]
    prec = (jax.lax.Precision.HIGHEST
            if blocks.dtype == jnp.float32 else None)
    mm = jax.lax.dot_general(blocks, xt, (((2,), (1,)), ((0,), (0,))),
                             precision=prec,
                             preferred_element_type=jnp.float32)
    agg = jax.ops.segment_sum(mm, block_rows,
                              num_segments=n_block_rows,
                              indices_are_sorted=True)
    return agg.reshape(n_pad, f)[:num_nodes].astype(x.dtype)


@jax.tree_util.register_pytree_node_class
class BSROperator:
    """128x128 block-sparse operator (:func:`bsr_spmm_xla`).

    Construct via :meth:`from_bsr` (host prep happens once there); the
    instance is then a pure pytree of device arrays, safe to pass through
    jit (``__matmul__`` never touches host numpy).
    """

    BLOCK = 128

    def __init__(self, blocks, block_cols, block_rows, num_nodes: int,
                 n_block_rows: int):
        self.blocks = blocks                # [nnzb, B, B] f32 or bf16
        self.block_cols = block_cols        # [nnzb]
        self.block_rows = block_rows        # [nnzb] (sorted)
        self._num_nodes = int(num_nodes)
        self._n_block_rows = int(n_block_rows)

    @classmethod
    def from_bsr(cls, blocks, block_cols, row_ptr, num_nodes: int,
                 dtype=jnp.float32) -> "BSROperator":
        """From ``Graph.to_bsr`` output: the block store in the compute
        dtype (bf16 storage halves the dominant memory traffic) and the
        CSR row offsets expanded to one sorted block-row id per block."""
        ptr = np.asarray(row_ptr, np.int64)
        rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int32),
                         np.diff(ptr))
        return cls(jnp.asarray(np.asarray(blocks), dtype),
                   jnp.asarray(np.asarray(block_cols, np.int32)),
                   jnp.asarray(rows), num_nodes, len(ptr) - 1)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def _spmm2d(self, x: jnp.ndarray) -> jnp.ndarray:
        return bsr_spmm_xla(self.blocks, self.block_cols,
                            self.block_rows, x, self._num_nodes,
                            self._n_block_rows)

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        if x.ndim == 2:
            return self._spmm2d(x)
        lead = x.shape[:-2]
        flat = x.reshape((-1,) + x.shape[-2:])
        out = jax.vmap(self._spmm2d)(flat)
        return out.reshape(lead + out.shape[-2:])

    def tree_flatten(self):
        return ((self.blocks, self.block_cols, self.block_rows),
                (self._num_nodes, self._n_block_rows))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
class GlobalMeanOperator:
    """The dense ``1/N`` matrix of the reference's ``global_attr`` support
    (``lib/sgp_preprocessing.py:155-158``) — i.e. broadcast mean over nodes.
    Implemented as an O(N·F) reduction instead of an O(N²·F) matmul."""

    def __init__(self, num_nodes: int):
        self._num_nodes = int(num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        mean = jnp.mean(x, axis=-2, keepdims=True)
        return jnp.broadcast_to(mean, x.shape)

    def transpose(self) -> "GlobalMeanOperator":
        return self

    def tree_flatten(self):
        return (), self._num_nodes

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux)


Operator = Union[DenseOperator, COOOperator, BSROperator, GlobalMeanOperator]


def build_operator(g: Graph, mode: str = "auto", dtype=jnp.float32,
                   precision: str = "highest") -> Operator:
    """Lift a host :class:`Graph` into a device propagation operator.

    ``auto`` heuristic: dense for graphs whose ``[N, N]`` operator takes
    at most 512 MB (every reference benchmark), BSR when larger but
    block-structured, COO otherwise.
    """
    if mode == "auto":
        dense_bytes = g.num_nodes * g.num_nodes * np.dtype(np.float32).itemsize
        if dense_bytes <= 512 * 1024 * 1024:  # <= 512 MB dense operator
            mode = "dense"
        else:
            blocks, cols, ptr = g.to_bsr(BSROperator.BLOCK)
            block_density = len(cols) / max(
                1, (ptr.shape[0] - 1) ** 2)
            mode = "bsr" if block_density < 0.5 else "coo"
    if mode == "dense":
        # scatter the edge list into [N, N] ON DEVICE: the edge list
        # (~E*12 bytes) crosses to the device instead of the N^2
        # host-densified matrix. .add matches scipy's duplicate-sum
        # semantics (edges are coalesced anyway).
        src = jnp.asarray(g.src.astype(np.int32))
        dst = jnp.asarray(g.dst.astype(np.int32))
        w = jnp.asarray(g.weight, dtype)
        mat = jax.jit(
            lambda s, d, ww: jnp.zeros(
                (g.num_nodes, g.num_nodes), dtype).at[d, s].add(ww)
        )(src, dst, w)
        return DenseOperator(mat, precision)
    if mode == "bsr":
        blocks, cols, ptr = g.to_bsr(BSROperator.BLOCK)
        # precision='default' -> bf16 block storage: halves the
        # dominant memory traffic; accumulation stays f32.
        bsr_dtype = (jnp.bfloat16 if precision == "default"
                     and dtype == jnp.float32 else dtype)
        return BSROperator.from_bsr(blocks, cols, ptr, g.num_nodes,
                                    bsr_dtype)
    if mode == "coo":
        return COOOperator(jnp.asarray(g.src), jnp.asarray(g.dst),
                           jnp.asarray(g.weight, dtype), g.num_nodes)
    raise ValueError(f"unknown operator mode {mode!r}")


def dense_adj_mask(g: Graph, dtype=jnp.bfloat16) -> jnp.ndarray:
    """Binary dense adjacency ``mask[dst, src]`` (the repo's
    ``Graph.to_dense`` orientation) scattered ON DEVICE from the edge
    list — uploads ``~E*8`` bytes instead of the ``N^2`` host-densified
    matrix. The GatedGN dense all-pairs aggregation input."""
    src_h, dst_h = g.src, g.dst
    if g.weight is not None:
        # explicitly-stored zeros are structure, not edges — keep
        # parity with the host (to_dense() != 0) semantics
        keep = np.asarray(g.weight) != 0
        src_h, dst_h = src_h[keep], dst_h[keep]
    src = jnp.asarray(src_h.astype(np.int32))
    dst = jnp.asarray(dst_h.astype(np.int32))
    n = g.num_nodes
    return jax.jit(
        lambda s, d: jnp.zeros((n, n), dtype).at[d, s].set(
            jnp.ones((), dtype)))(src, dst)


def spmm(op: Operator, x: jnp.ndarray) -> jnp.ndarray:
    """``x' = A @ x`` for any operator representation."""
    return op @ x
