"""Trainable graph layers (flax).

- :class:`DiffConv` — DCRNN diffusion convolution
  (``tsl/nn/layers/graph_convs/diff_conv.py:12-105``): concat of
  ``[x?, A x, ..., A^k x, A' x, ..., A'^k x]`` through one Linear. The
  support operators (row-normalized forward + transposed-normalized
  backward) are prepared host-side by :func:`diff_conv_support` and
  passed as pytrees — each hop is one matmul.
- :class:`ConditionalBlock` — exogenous conditioning
  (``tsl/nn/blocks/encoders/conditional.py:9-67``).
- :class:`GatedGraphNetwork` — edge-gated message passing
  (``tsl/nn/layers/graph_convs/gated_gn.py:9-64``, Satorras et al.);
  dense-operator variant: messages aggregated via the (unweighted,
  row-normalized) adjacency.
"""
from __future__ import annotations

from typing import List, Sequence

import flax.linen as nn
import jax.numpy as jnp
import numpy as np

from sgp.graph.sparse import Graph, normalize_adj, transpose
from sgp.models.blocks import get_activation
from sgp.ops.spmm import Operator, build_operator

# Blocked-XLA all-pairs rematerialization: None = auto (checkpoint the
# per-block message chain only when the saved [.., N, N, h] residuals
# would exceed ~6 GB); True/False force it.
ALLPAIRS_REMAT = None


def diff_conv_support(g: Graph, add_backward: bool = True,
                      operator_mode: str = "auto",
                      precision: str = "highest") -> List[Operator]:
    """Normalized forward (+ transposed) diffusion operators
    (``diff_conv.py:50-66``). ``precision='default'`` lets dense
    operators round f32 inputs on the tensor cores (TF32 on NVIDIA
    GPUs, as the reference's CUDA matmuls may); keep ``'highest'``
    for activation-parity checks."""
    ops = [build_operator(normalize_adj(g, "row"), operator_mode,
                          precision=precision)]
    if add_backward:
        ops.append(build_operator(normalize_adj(transpose(g), "row"),
                                  operator_mode, precision=precision))
    return ops


def diff_conv_support_from_arrays(src, dst, weight, num_nodes: int,
                                  add_backward: bool = True
                                  ) -> List[Operator]:
    """Device-side support construction from (padded) edge arrays — for
    per-batch subgraphs shipped as static-shaped tensors
    (``sgp/data/subgraph.py``). Zero-weight padding edges contribute
    nothing to degrees or aggregation. Jit-safe."""
    import jax
    from sgp.ops.spmm import COOOperator

    def normalized(s, d, w):
        deg = jax.ops.segment_sum(w, d, num_segments=num_nodes)
        inv = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1e-38), 0.0)
        return COOOperator(s, d, w * inv[d], num_nodes)

    ops = [normalized(src, dst, weight)]
    if add_backward:
        ops.append(normalized(dst, src, weight))
    return ops


class DiffConv(nn.Module):
    out_channels: int
    k: int
    root_weight: bool = True

    @staticmethod
    def hops(x, supports: Sequence[Operator], k: int) -> list:
        """The K-hop diffusion terms ``[op^1 x, .., op^k x]`` per
        support, in the concat order ``__call__`` consumes. Exposed so
        callers applying several DiffConvs to overlapping inputs (the
        DCRNN gates) can compute the SpMMs once: diffusion is linear
        and channel-separable, ``op @ [a, b] = [op @ a, op @ b]``."""
        out = []
        for op in supports:
            cur = x
            for _ in range(k):
                cur = op @ cur
                out.append(cur)
        return out

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator], hops=None):
        """``hops`` (optional) short-circuits the SpMM loop with
        precomputed :meth:`hops` output — same values, shared work.
        The parameter tree is identical either way."""
        out = [x] if self.root_weight else []
        out.extend(self.hops(x, supports, self.k)
                   if hops is None else hops)
        return nn.Dense(self.out_channels)(jnp.concatenate(out, -1))


class ConditionalBlock(nn.Module):
    output_size: int
    activation: str = "relu"
    dropout: float = 0.0
    skip_connection: bool = False

    @nn.compact
    def __call__(self, x, u, training: bool = False):
        act = get_activation(self.activation)
        out = act(nn.Dense(self.output_size)(x))
        cond = act(nn.Dense(self.output_size)(u))
        out = nn.Dense(self.output_size)(out) \
            + nn.Dense(self.output_size, use_bias=False)(cond)
        out = act(out)
        if self.dropout > 0:
            out = nn.Dropout(self.dropout, deterministic=not training)(out)
        if self.skip_connection:
            out = nn.Dense(self.output_size)(x) + out
        return out


class GraphConv(nn.Module):
    """``D^-1 A X Theta (+ X Theta_root) + b`` message passing with
    row-normalized aggregation (``tsl/nn/base/graph_conv.py:11-75``).
    Takes a pre-normalized operator."""
    output_size: int
    root_weight: bool = True
    use_bias: bool = True

    @nn.compact
    def __call__(self, x, op: Operator):
        out = op @ nn.Dense(self.output_size, use_bias=False)(x)
        if self.root_weight:
            out = out + nn.Dense(self.output_size, use_bias=False,
                                 name="root")(x)
        if self.use_bias:
            out = out + self.param("bias", nn.initializers.zeros,
                                   (self.output_size,))
        return out


class GATConv(nn.Module):
    """Graph attention convolution (``graph_convs/gat_conv.py:19-287``,
    PyG-style): per-edge attention logits from source+destination
    projections, softmax over each destination's incoming edges
    (segment softmax), multi-head concat."""
    output_size: int
    heads: int = 1
    concat: bool = True
    negative_slope: float = 0.2

    @nn.compact
    def __call__(self, x, src: jnp.ndarray, dst: jnp.ndarray):
        import jax
        from sgp.ops.scatter import segment_softmax
        h, dh = self.heads, self.output_size
        n = x.shape[-2]
        xp = nn.DenseGeneral((h, dh))(x)             # [..., n, h, dh]
        a_src = self.param("a_src", nn.initializers.lecun_normal(),
                           (h, dh))
        a_dst = self.param("a_dst", nn.initializers.lecun_normal(),
                           (h, dh))
        alpha_src = (xp * a_src).sum(-1)             # [..., n, h]
        alpha_dst = (xp * a_dst).sum(-1)
        logits = (jnp.take(alpha_src, src, axis=-2)
                  + jnp.take(alpha_dst, dst, axis=-2))  # [..., e, h]
        logits = nn.leaky_relu(logits, self.negative_slope)

        def one(logits_e, msgs_e):
            att = jax.vmap(lambda l: segment_softmax(l, dst, n),
                           in_axes=-1, out_axes=-1)(logits_e)
            weighted = msgs_e * att[..., None]       # [e, h, dh]
            return jax.ops.segment_sum(weighted, dst, num_segments=n)

        msgs = jnp.take(xp, src, axis=-3)            # [..., e, h, dh]
        if x.ndim == 2:
            out = one(logits, msgs)
        else:
            lead = x.shape[:-2]
            out = jax.vmap(one)(
                logits.reshape((-1,) + logits.shape[-2:]),
                msgs.reshape((-1,) + msgs.shape[-3:]))
            out = out.reshape(lead + (n, h, dh))
        if self.concat:
            return out.reshape(out.shape[:-2] + (h * dh,))
        return out.mean(-2)


class SpatioTemporalAttention(nn.Module):
    """Temporal then spatial attention sandwich
    (``graph_convs/spatio_temporal_att.py:7-59``)."""
    hidden_size: int
    n_heads: int = 1
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        from sgp.models.attention import MultiHeadAttention
        if x.shape[-1] != self.hidden_size:
            x = nn.Dense(self.hidden_size)(x)
        h = MultiHeadAttention(self.hidden_size, self.n_heads, "time",
                               dropout=self.dropout)(x, training=training)
        x = nn.LayerNorm()(x + h)
        h = MultiHeadAttention(self.hidden_size, self.n_heads, "nodes",
                               dropout=self.dropout)(x, training=training)
        return nn.LayerNorm()(x + h)


def gather_nodes(v: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``jnp.take(v, idx, axis=-2)`` performed in NODE-MAJOR layout.

    For ``v [..., N, F]`` with leading batch dims, the direct take
    fetches one strided ``[B, 1, F]`` slab per index — B separate
    narrow reads. Transposing to ``[N, B*F]`` first makes each index
    one contiguous row (the transposes fuse into producer/consumer).
    Identical values to the plain take.
    """
    if v.ndim == 2:                       # no batch dims: already major
        return jnp.take(v, idx, axis=0)
    lead = v.shape[:-2]
    f = v.shape[-1]
    vt = jnp.moveaxis(v, -2, 0).reshape(v.shape[-2], -1)   # [N, B*F]
    g = jnp.take(vt, idx, axis=0)                          # [E, B*F]
    g = g.reshape((idx.shape[0],) + lead + (f,))
    return jnp.moveaxis(g, 0, len(lead))                   # [..., E, F]


class GatedGraphNetwork(nn.Module):
    """Edge-gated message passing (``gated_gn.py:9-64``):
    ``m_ij = sigmoid(g(f([x_i, x_j]))) * f([x_i, x_j])`` sum-aggregated
    into the destination, then an update MLP with skip.

    Layout: the first edge-MLP layer is LINEAR in ``[x_i, x_j]``,
    so its two weight halves run as node-space GEMMs (``E/N`` ~ 100x
    fewer rows on k-nn graphs) and only the halved-width projections
    are gathered into edge space — same function space and parameter
    count as the reference's concat Dense, ~4x less gather traffic
    than gathering the raw features. The remaining edge compute is the
    irreducible gather -> MLP -> segment-sum pattern (SURVEY.md §2.6
    PyG MessagePassing row). ``sorted_edges=True`` (edges sorted by
    ``dst``, e.g. from ``coalesce``) lets XLA lower the aggregation
    without a full scatter sort.

    Passing ``neigh=(src_idx [N, D], mask [N, D])`` (from
    :func:`sgp.graph.sparse.padded_incoming`) switches to the ELL
    layout: messages live in an ``[..., N, D, F]`` array and the
    aggregation is a contiguous ``sum`` over the neighbor axis — no
    scatter lowering at all, the fast path for static full-graph
    training. Passing ``adj`` (dense ``[N, N]`` with ``adj[dst, src]
    != 0`` marking an edge, the repo's ``Graph.to_dense`` orientation)
    computes ALL ``N^2`` messages as blocked batched GEMMs and
    mask-reduces over the src axis — gather-free and
    density-insensitive, the win region for dense-ish graphs (Table-2
    "full" rows at 7–15% density) where per-edge gathers at small
    batch hit the 64-byte-row latency floor. All layouts share the
    same parameter structure (one init/checkpoint serves any of them).

    ``dtype`` (e.g. ``jnp.bfloat16``) runs the edge/message compute in
    that dtype — the ``[..., N, D, h]`` message intermediates dominate
    the layer's HBM traffic, so halving their bytes roughly halves the
    bandwidth-bound step time; params stay f32, the output is cast
    back to the input dtype."""
    output_size: int
    activation: str = "silu"
    sorted_edges: bool = False
    dtype: object = None
    # per-LAYER residual budget (GB) for the all-pairs remat-off auto
    # heuristic: stacks of L layers each save their own [.., N, W, h]
    # residual set, so callers divide a TOTAL budget by L
    # (``gated_gn.py::_decode`` passes 12/gnn_layers)
    resid_budget_gb: float = 6.0

    @nn.compact
    def __call__(self, x, src: jnp.ndarray = None,
                 dst: jnp.ndarray = None,
                 edge_mask: jnp.ndarray = None, neigh=None,
                 adj: jnp.ndarray = None, adj_band=None):
        import jax
        act = get_activation(self.activation)
        in_dtype = x.dtype
        n = x.shape[-2]
        p_i = nn.Dense(self.output_size // 2,
                       dtype=self.dtype)(x)                 # W_i x + b
        p_j = nn.Dense(self.output_size // 2, use_bias=False,
                       dtype=self.dtype)(x)                 # W_j x
        # shared message/gate layers — created here (same auto-names /
        # param tree for every aggregation layout) and called once or
        # per block below
        d_msg = nn.Dense(self.output_size, dtype=self.dtype)
        d_gate = nn.Dense(1, dtype=self.dtype)
        if adj is not None:
            # Dense all-pairs messages as matmuls (``adj [N, N]``,
            # nonzero = edge). For dense-ish graphs (the Table-2 "full"
            # rows, 7-15% density) computing ALL N^2 messages as
            # batched GEMMs over dst-row blocks is density-insensitive
            # and gather-free — the GatedGN analog of the dense
            # diffusion supports. Per-block ``jax.checkpoint`` keeps
            # the [blk, N, h] intermediates out of the backward
            # residual set (they are recomputed), so peak memory stays
            # one block deep.
            h2 = p_i.shape[-1]
            dt = self.dtype or in_dtype
            # materialize the shared kernels once (tiny dummy rows) so
            # the block fn can take them as explicit jax arguments
            _ = d_msg(jnp.zeros((1, h2), dt))
            _ = d_gate(jnp.zeros((1, self.output_size), dt))
            w2 = d_msg.variables["params"]["kernel"].astype(dt)
            b2 = d_msg.variables["params"]["bias"].astype(dt)
            wg = d_gate.variables["params"]["kernel"].astype(dt)
            bg = d_gate.variables["params"]["bias"].astype(dt)
            acc = jnp.float32 if self.dtype is not None else in_dtype
            mask = (adj != 0).astype(dt)                # [N, N]

            def msg_block_fn(pi_b, pj, mask_b, w2, b2, wg, bg):
                # pi_b [.., blk, h2]; pj [.., N, h2]; mask_b [blk, N]
                t = act(pi_b[..., :, None, :] + pj[..., None, :, :])
                mb = act(t @ w2 + b2)            # [..., blk, N, h]
                g = nn.sigmoid(mb @ wg + bg)
                return jnp.einsum("ij,...ijh->...ih", mask_b,
                                  g * mb,
                                  preferred_element_type=acc)

            # rematerialize only when the saved [.., N, W, h]
            # per-layer residuals would crowd HBM (~>6 GB at this
            # batch); below that the ~1/3 recompute is pure waste
            # (ALLPAIRS_REMAT forces: True = always checkpoint,
            # False = never)
            if adj_band is None:
                w_mean = n
            elif isinstance(adj_band[1], (tuple, list)):
                w_mean = sum(adj_band[1]) / len(adj_band[1])
            else:
                w_mean = adj_band[1]
            bsz = int(np.prod(p_i.shape[:-2])) or 1
            resid_gb = bsz * n * w_mean * self.output_size * \
                jnp.zeros((), dt).dtype.itemsize / 2 ** 30
            use_ckpt = (resid_gb > self.resid_budget_gb
                        if ALLPAIRS_REMAT is None
                        else ALLPAIRS_REMAT)
            msg_block = (jax.checkpoint(msg_block_fn) if use_ckpt
                         else msg_block_fn)

            pj_c = p_j.astype(dt)
            parts = []
            if adj_band is not None:
                # band-limited sweep (graph.sparse.band_windows):
                # under an RCM node order each dst row-block's
                # edges live in a narrow column window, so only
                # N*W candidate pairs are computed instead of N^2
                # — all entries outside a window are zero in
                # ``mask`` by construction, same math. ``w_cols``
                # may be a per-block tuple (uniform=False: each
                # block hugs its own band — 21-26% fewer pairs on
                # the Table-2 full graphs)
                band_blk, w_cols, los = adj_band
                per_blk = isinstance(w_cols, (tuple, list))
                for bi, i0 in enumerate(range(0, n, band_blk)):
                    lo = los[bi]
                    w = w_cols[bi] if per_blk else w_cols
                    parts.append(msg_block(
                        p_i[..., i0:i0 + band_blk, :].astype(dt),
                        pj_c[..., lo:lo + w, :],
                        mask[i0:i0 + band_blk, lo:lo + w],
                        w2, b2, wg, bg))
            else:
                itemsize = jnp.zeros((), dt).dtype.itemsize
                blk = max(128, min(n, int(2 ** 28 / max(
                    n * self.output_size * itemsize, 1))))
                for i0 in range(0, n, blk):
                    parts.append(msg_block(
                        p_i[..., i0:i0 + blk, :].astype(dt), pj_c,
                        mask[i0:i0 + blk], w2, b2, wg, bg))
            agg = jnp.concatenate(parts, axis=-2) \
                if len(parts) > 1 else parts[0]
        else:
            if neigh is not None:
                src_idx, nmask = neigh
                d = src_idx.shape[1]
                pj_n = gather_nodes(p_j, src_idx.reshape(-1))
                pj_n = pj_n.reshape(pj_n.shape[:-2] + (n, d, -1))
                m = act(p_i[..., :, None, :] + pj_n)  # [.., N, D, h]
            else:
                m = act(gather_nodes(p_i, dst) + gather_nodes(p_j, src))
            m = act(d_msg(m))
            gate = nn.sigmoid(d_gate(m))
            m = gate * m
        # accumulate the neighbor sum in f32 when messages are bf16 —
        # the upcast fuses into the reduction, so the [.., N, D, h]
        # intermediate still lives in HBM at half width
        acc = jnp.float32 if self.dtype is not None else in_dtype
        if adj is not None:
            pass                                  # agg computed above
        elif neigh is not None:
            agg = jnp.sum((m * nmask[..., None]).astype(acc),
                          axis=-2)  # over D
        else:
            if edge_mask is not None:
                # zero padding edges (static-shape subgraph batches)
                m = m * edge_mask[..., :, None]
            if self.sorted_edges and not isinstance(dst, jax.core.Tracer):
                # sorted_edges feeds indices_are_sorted=True below; an
                # unsorted dst would aggregate silently wrong. Concrete
                # arrays (eager call, or trace-time constants) are
                # checked once here; tracers can't be (callers passing
                # dst through jit must sort on the host — coalesce does)
                dn = np.asarray(dst)
                if dn.size and np.any(np.diff(dn) < 0):
                    raise ValueError(
                        "sorted_edges=True but dst is not sorted "
                        "ascending; sort edges by dst on the host "
                        "(graph.coalesce) or pass sorted_edges=False")
            m = m.astype(acc)
            seg = lambda mb: jax.ops.segment_sum(
                mb, dst, num_segments=n,
                indices_are_sorted=self.sorted_edges)
            if m.ndim == 2:
                agg = seg(m)
            else:
                # node-major scatter: one segment-sum over [E, B*F]
                # wide rows instead of a vmapped per-batch scatter of
                # narrow rows (same layout win as gather_nodes)
                lead = m.shape[:-2]
                mt = jnp.moveaxis(m, -2, 0).reshape(m.shape[-2], -1)
                agg = jnp.moveaxis(
                    seg(mt).reshape((n,) + lead + (m.shape[-1],)),
                    0, len(lead))
        # the aggregated messages, readable with
        # ``apply(..., mutable=["intermediates"])`` (layout tests)
        self.sow("intermediates", "aggregate", agg)
        out = nn.Dense(self.output_size, dtype=self.dtype)(
            jnp.concatenate([agg, x.astype(agg.dtype)], -1))
        out = nn.Dense(self.output_size, dtype=self.dtype)(act(out))
        skip = x if x.shape[-1] == self.output_size \
            else nn.Dense(self.output_size, dtype=self.dtype)(x)
        return (out + skip).astype(in_dtype)
