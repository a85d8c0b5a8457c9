"""Segment ops — XLA-native replacement for torch_scatter.

The reference leans on torch_scatter for message aggregation and sparse
softmax (``tsl/nn/functional.py:73-161``, ``tsl/ops/connectivity.py:191``).
Here they lower to XLA segment reductions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum(data: jnp.ndarray, segment_ids: jnp.ndarray,
                num_segments: int) -> jnp.ndarray:
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)


def segment_mean(data: jnp.ndarray, segment_ids: jnp.ndarray,
                 num_segments: int) -> jnp.ndarray:
    tot = jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)
    cnt = jax.ops.segment_sum(jnp.ones_like(segment_ids, jnp.float32),
                              segment_ids, num_segments=num_segments)
    return tot / jnp.maximum(cnt, 1.0).reshape(
        (num_segments,) + (1,) * (data.ndim - 1))


def segment_softmax(scores: jnp.ndarray, segment_ids: jnp.ndarray,
                    num_segments: int) -> jnp.ndarray:
    """Numerically-stable softmax within segments (sparse softmax,
    ``tsl/nn/functional.py:73-112``)."""
    seg_max = jax.ops.segment_max(scores, segment_ids,
                                  num_segments=num_segments)
    scores = scores - seg_max[segment_ids]
    exp = jnp.exp(scores)
    seg_sum = jax.ops.segment_sum(exp, segment_ids,
                                  num_segments=num_segments)
    return exp / (seg_sum[segment_ids] + 1e-16)
