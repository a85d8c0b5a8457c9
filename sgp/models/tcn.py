"""Temporal convolutions (flax).

Counterparts of ``tsl/nn/base/temporal_conv.py`` +
``tsl/nn/blocks/encoders/tcn.py``: dilated (optionally causal, optionally
gated-tanh) convolutions over the time axis of ``[b s n c]`` tensors.
XLA lowers these to convolutions with (batch*nodes) as the batch dim.
"""
from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from sgp.models.blocks import get_activation


class TemporalConv(nn.Module):
    """Conv over time; input ``[b s n c]``. ``causal_pad`` left-pads by
    ``(k-1)*dilation`` so output length == input length."""
    output_channels: int
    kernel_size: int
    dilation: int = 1
    causal_pad: bool = True
    gated: bool = False

    @nn.compact
    def __call__(self, x):
        b, s, n, c = x.shape
        xt = x.transpose(0, 2, 1, 3)          # [b n s c]
        if self.causal_pad:
            pad = (self.kernel_size - 1) * self.dilation
            xt = jnp.pad(xt, ((0, 0), (0, 0), (pad, 0), (0, 0)))
        feats = self.output_channels * (2 if self.gated else 1)
        out = nn.Conv(feats, kernel_size=(self.kernel_size,),
                      kernel_dilation=(self.dilation,), padding="VALID")(xt)
        if self.gated:
            a, g = jnp.split(out, 2, axis=-1)
            out = jnp.tanh(a) * nn.sigmoid(g)
        return out.transpose(0, 2, 1, 3)      # [b s' n c]


class TemporalConvNet(nn.Module):
    """Stacked temporal convs (``tcn.py:9-95``); activation applied
    between layers unless gated."""
    hidden_channels: int
    kernel_size: int
    dilation: int = 1
    n_layers: int = 1
    gated: bool = False
    causal_padding: bool = True
    exponential_dilation: bool = False
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        act = (lambda v: v) if self.gated \
            else get_activation(self.activation)
        d = self.dilation
        for i in range(self.n_layers):
            if self.exponential_dilation:
                d = self.dilation ** i
            x = TemporalConv(self.hidden_channels, self.kernel_size,
                             dilation=d, causal_pad=self.causal_padding,
                             gated=self.gated)(x)
            x = act(x)
            if self.dropout > 0:
                x = nn.Dropout(self.dropout,
                               deterministic=not training)(x)
        return x


class Norm(nn.Module):
    """Norm dispatcher (``tsl/nn/layers/norm/norm.py:10-34``). ``batch``
    is a stateless batch norm (batch statistics at train and eval; no
    running averages — documented divergence from torch BatchNorm's
    running stats, irrelevant for full-batch eval)."""
    kind: str = "none"

    @nn.compact
    def __call__(self, x, time_mask=None):
        """``time_mask [s]`` (bool) restricts the ``batch`` statistics to
        valid time positions — used by constant-length-buffer stacks
        (GWNet scan-over-layers) to reproduce the shrinking-buffer
        semantics exactly. ``layer``/``none`` are per-position and
        ignore it."""
        if self.kind == "none":
            return x
        if self.kind == "layer":
            # statistics in f32 even under bf16 end-to-end compute
            return nn.LayerNorm(dtype=jnp.float32)(x).astype(x.dtype)
        if self.kind == "batch":
            xf = x.astype(jnp.float32)   # f32 stats under bf16 compute
            if time_mask is None:
                mean = xf.mean(axis=tuple(range(x.ndim - 1)),
                               keepdims=True)
                var = xf.var(axis=tuple(range(x.ndim - 1)),
                             keepdims=True)
            else:
                w = time_mask.astype(jnp.float32).reshape(
                    (1, -1) + (1,) * (x.ndim - 2))
                axes = tuple(range(x.ndim - 1))
                cnt = jnp.maximum(
                    w.sum() * (x.size // (x.shape[1] * x.shape[-1])), 1.0)
                mean = (xf * w).sum(axis=axes, keepdims=True) / cnt
                var = (jnp.square(xf - mean) * w).sum(
                    axis=axes, keepdims=True) / cnt
            scale = self.param("scale", nn.initializers.ones,
                               (x.shape[-1],))
            bias = self.param("bias", nn.initializers.zeros,
                              (x.shape[-1],))
            out = (xf - mean) * jax.lax.rsqrt(var + 1e-5) \
                * scale.astype(jnp.float32) + bias.astype(jnp.float32)
            return out.astype(x.dtype)
        raise ValueError(self.kind)
