"""Functional NN ops (``tsl/nn/functional.py`` counterparts).

``expand_then_cat`` (:24-37), ``gated_tanh`` (:41-57),
``reverse_tensor`` (:61-69), ``sparse_softmax`` (:73-112) and
``sparse_multi_head_attention`` (:116-161) — the torch_scatter-backed
ops re-expressed with XLA segment reductions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from sgp.ops.scatter import segment_softmax


def expand_then_cat(tensors: Sequence[jnp.ndarray],
                    axis: int = -1) -> jnp.ndarray:
    """Broadcast all tensors to a common shape (except ``axis``) then
    concatenate."""
    shapes = [list(t.shape) for t in tensors]
    ndim = max(len(s) for s in shapes)
    tensors = [t.reshape((1,) * (ndim - t.ndim) + t.shape)
               for t in tensors]
    ax = axis % ndim
    target = [max(t.shape[d] for t in tensors) if d != ax else -1
              for d in range(ndim)]
    out = []
    for t in tensors:
        shape = [target[d] if d != ax else t.shape[d]
                 for d in range(ndim)]
        out.append(jnp.broadcast_to(t, shape))
    return jnp.concatenate(out, axis=ax)


def gated_tanh(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """``tanh(a) * sigmoid(b)`` with a/b the two halves of ``axis``."""
    a, b = jnp.split(x, 2, axis=axis)
    return jnp.tanh(a) * jax.nn.sigmoid(b)


def reverse_tensor(x: jnp.ndarray, axis: int = 1) -> jnp.ndarray:
    return jnp.flip(x, axis=axis)


def sparse_softmax(scores: jnp.ndarray, index: jnp.ndarray,
                   num_nodes: int) -> jnp.ndarray:
    """Edge-score softmax per destination node."""
    return segment_softmax(scores, index, num_nodes)


def sparse_multi_head_attention(q: jnp.ndarray, k: jnp.ndarray,
                                v: jnp.ndarray,
                                src: jnp.ndarray, dst: jnp.ndarray,
                                num_nodes: int,
                                scale: Optional[float] = None
                                ) -> jnp.ndarray:
    """Sparse (edge-list) multi-head attention: per-edge logits
    ``<q_dst, k_src>``, softmax over incoming edges, weighted value
    aggregation. q/k/v: ``[n, h, d]``; returns ``[n, h, d]``."""
    d = q.shape[-1]
    scale = scale or d ** -0.5
    logits = (jnp.take(q, dst, axis=0)
              * jnp.take(k, src, axis=0)).sum(-1) * scale  # [e, h]
    att = jax.vmap(lambda l: segment_softmax(l, dst, num_nodes),
                   in_axes=-1, out_axes=-1)(logits)
    weighted = jnp.take(v, src, axis=0) * att[..., None]
    return jax.ops.segment_sum(weighted, dst, num_segments=num_nodes)
