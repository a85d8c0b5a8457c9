"""Attention primitives and transformer blocks (flax).

Counterparts of the reference attention stack:
``tsl/nn/base/attention/attention.py:22-143`` (axis-selectable MHA +
AttentionEncoder), ``linear_attention.py:15-105`` (causal linear
attention), ``tsl/nn/layers/positional_encoding.py`` (sinusoidal),
``tsl/nn/blocks/encoders/transformer.py:11-197`` (temporal /
spatiotemporal transformer layers) and
``tsl/nn/models/transformer_model.py`` — all lowered to dense
matmuls with the attention axis moved into position.
"""
from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax.numpy as jnp
import numpy as np

from sgp.models.blocks import get_activation, maybe_cat_exog
from sgp.models.flax_blocks import MLP


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding over the steps axis of
    ``[b s ... c]`` (``layers/positional_encoding.py:7-42``)."""
    max_len: int = 5000

    @nn.compact
    def __call__(self, x):
        d = x.shape[-1]
        pos = np.arange(self.max_len)[:, None]
        div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
        pe = np.zeros((self.max_len, d), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)[:, :d // 2]
        pe_arr = jnp.asarray(pe[:x.shape[1]])
        shape = (1, x.shape[1]) + (1,) * (x.ndim - 3) + (d,)
        return x + pe_arr.reshape(shape)


def _move_axis_to_seq(x, axis: str):
    """[b s n c] -> sequence-major layout for attention over 'time'
    (steps) or 'nodes'."""
    if axis == "time":
        return x.transpose(0, 2, 1, 3)     # [b n s c]
    return x                                # [b s n c]: attend over n


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA over the ``axis`` dimension of
    ``[b s n c]`` inputs (``attention.py:70-143``)."""
    embed_dim: int
    num_heads: int = 1
    axis: str = "time"
    causal: bool = False
    dropout: float = 0.0

    @nn.compact
    def __call__(self, query, key=None, value=None,
                 training: bool = False):
        key = query if key is None else key
        value = key if value is None else value
        squeeze = query.ndim == 3
        if squeeze:  # [b s c] -> [b s 1 c]
            query, key, value = (a[:, :, None, :]
                                 for a in (query, key, value))
        q = _move_axis_to_seq(query, self.axis)
        k = _move_axis_to_seq(key, self.axis)
        v = _move_axis_to_seq(value, self.axis)
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        b, o, s, _ = q.shape

        def proj(x, name):
            return nn.DenseGeneral((h, dh), name=name)(x)
        qh, kh, vh = proj(q, "q"), proj(k, "k"), proj(v, "v")
        logits = jnp.einsum("boshd,bothd->bohst", qh, kh) / np.sqrt(dh)
        if self.causal:
            causal_mask = jnp.tril(
                jnp.ones((s, kh.shape[2]), bool))
            logits = jnp.where(causal_mask, logits, -1e30)
        attn = nn.softmax(logits, axis=-1)
        if self.dropout > 0:
            attn = nn.Dropout(self.dropout,
                              deterministic=not training)(attn)
        out = jnp.einsum("bohst,bothd->boshd", attn, vh)
        out = nn.DenseGeneral(self.embed_dim, axis=(-2, -1),
                              name="out")(out)
        if self.axis == "time":
            out = out.transpose(0, 2, 1, 3)
        if squeeze:
            out = out[:, :, 0, :]
        return out


class AttentionEncoder(nn.Module):
    """QKV input projections + MHA (``attention.py:22-68``)."""
    embed_dim: int
    num_heads: int = 1
    axis: str = "time"
    activation: Optional[str] = None
    causal: bool = False

    @nn.compact
    def __call__(self, x, training: bool = False):
        act = (get_activation(self.activation) if self.activation
               else (lambda v: v))
        q = act(nn.Dense(self.embed_dim)(x))
        k = act(nn.Dense(self.embed_dim)(x))
        v = act(nn.Dense(self.embed_dim)(x))
        return MultiHeadAttention(self.embed_dim, self.num_heads,
                                  self.axis, self.causal)(
            q, k, v, training=training)


class CausalLinearAttention(nn.Module):
    """Linear attention with the causal cumulative-sum trick
    (``linear_attention.py:15-105``): ``phi(q)_t (sum_{<=t} phi(k)_s
    v_s^T)`` with ``phi = elu + 1``."""
    embed_dim: int
    num_heads: int = 1

    @nn.compact
    def __call__(self, x):
        # x: [b s c] or [b s n c] (attention over s)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[:, :, None, :]
        x = x.transpose(0, 2, 1, 3)  # [b n s c]
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        q = nn.DenseGeneral((h, dh))(x)
        k = nn.DenseGeneral((h, dh))(x)
        v = nn.DenseGeneral((h, dh))(x)
        phi_q, phi_k = nn.elu(q) + 1, nn.elu(k) + 1
        kv = jnp.cumsum(jnp.einsum("bnshd,bnshe->bnshde", phi_k, v),
                        axis=2)
        z = jnp.cumsum(phi_k, axis=2)
        num = jnp.einsum("bnshd,bnshde->bnshe", phi_q, kv)
        den = jnp.einsum("bnshd,bnshd->bnsh", phi_q, z)[..., None]
        out = num / jnp.maximum(den, 1e-6)
        out = nn.DenseGeneral(self.embed_dim, axis=(-2, -1))(out)
        out = out.transpose(0, 2, 1, 3)
        return out[:, :, 0, :] if squeeze else out


class TransformerLayer(nn.Module):
    """Pre-norm transformer block attending over time or nodes
    (``transformer.py:11-98``)."""
    hidden_size: int
    ff_size: int
    n_heads: int = 1
    axis: str = "time"
    causal: bool = True
    activation: str = "elu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        if x.shape[-1] != self.hidden_size:
            x = nn.Dense(self.hidden_size)(x)
        h = nn.LayerNorm()(x)
        h = MultiHeadAttention(self.hidden_size, self.n_heads, self.axis,
                               causal=self.causal,
                               dropout=self.dropout)(h, training=training)
        x = x + h
        h = nn.LayerNorm()(x)
        h = MLP(self.ff_size, self.hidden_size,
                activation=self.activation,
                dropout=self.dropout)(h, training=training)
        return x + h


class SpatioTemporalTransformerLayer(nn.Module):
    """Temporal attention then spatial attention then FF
    (``transformer.py:100-197``)."""
    hidden_size: int
    ff_size: int
    n_heads: int = 1
    causal: bool = True
    activation: str = "elu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        x = TransformerLayer(self.hidden_size, self.ff_size,
                             self.n_heads, "time", self.causal,
                             self.activation, self.dropout)(
            x, training=training)
        x = TransformerLayer(self.hidden_size, self.ff_size,
                             self.n_heads, "nodes", False,
                             self.activation, self.dropout)(
            x, training=training)
        return x


class TransformerModel(nn.Module):
    """Forecasting transformer (``tsl/nn/models/transformer_model.py``):
    input+exog projection, positional encoding, stacked (spatio)temporal
    transformer layers, last-step MLP readout to the horizon."""
    hidden_size: int
    ff_size: int
    output_size: int
    horizon: int
    n_layers: int = 1
    n_heads: int = 1
    axis: str = "time"  # 'time' or 'both'
    activation: str = "elu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, u=None, training: bool = False, **kwargs):
        # x: [b s n c]
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        x = nn.Dense(self.hidden_size)(x)
        x = PositionalEncoding()(x)
        for _ in range(self.n_layers):
            if self.axis == "both":
                x = SpatioTemporalTransformerLayer(
                    self.hidden_size, self.ff_size, self.n_heads,
                    activation=self.activation, dropout=self.dropout)(
                    x, training=training)
            else:
                x = TransformerLayer(
                    self.hidden_size, self.ff_size, self.n_heads,
                    self.axis, activation=self.activation,
                    dropout=self.dropout)(x, training=training)
        h = x[:, -1]  # [b n c]
        out = MLP(self.ff_size, self.output_size * self.horizon,
                  activation=self.activation)(h, training=training)
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).transpose(0, 2, 1, 3)
