"""DCRNN baseline (flax).

Re-design of ``tsl/nn/models/stgn/dcrnn_model.py:11-79`` +
``blocks/encoders/dcrnn.py`` + ``gcrnn.py:6-20``: a GRU whose gates are
diffusion convolutions, scanned over the window with ``lax.scan``;
the diffusion supports (forward + transposed row-normalized operators)
are prepared host-side and passed at call time as pytrees.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from sgp.models.blocks import maybe_cat_exog
from sgp.models.flax_blocks import MLPDecoder
from sgp.models.graph_layers import ConditionalBlock, DiffConv
from sgp.ops.spmm import Operator


class DCRNNCell(nn.Module):
    hidden_size: int
    k: int = 2
    root_weight: bool = True

    @nn.compact
    def __call__(self, x, h, supports: Sequence[Operator]):
        # Diffusion is linear and channel-separable, so the three
        # gates' SpMMs share work instead of each running their own
        # K-hop loop (3 full-width loops -> one [x,h] + one r*h loop,
        # bit-identical results): r and u consume the same [x,h] hops,
        # and the candidate's [x, r*h] hops reuse the x-channel block.
        f_in = x.shape[-1]
        xh = jnp.concatenate([x, h], -1)
        hops_xh = DiffConv.hops(xh, supports, self.k)
        r = nn.sigmoid(DiffConv(self.hidden_size, self.k,
                                self.root_weight)(
                                    xh, supports, hops=hops_xh))
        u = nn.sigmoid(DiffConv(self.hidden_size, self.k,
                                self.root_weight)(
                                    xh, supports, hops=hops_xh))
        w = r * h
        hops_xc = [jnp.concatenate([hx[..., :f_in], hw], -1)
                   for hx, hw in zip(hops_xh,
                                     DiffConv.hops(w, supports, self.k))]
        xc = jnp.concatenate([x, w], -1)
        c = jnp.tanh(DiffConv(self.hidden_size, self.k,
                              self.root_weight)(
                                  xc, supports, hops=hops_xc))
        return u * h + (1.0 - u) * c


class DCRNN(nn.Module):
    hidden_size: int
    n_layers: int = 1
    k: int = 2
    root_weight: bool = True

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator]):
        # x: [b s n c] -> last hidden of top layer [b n h]. The window
        # is short and static (<= 12 steps in every config), so the time
        # loop is unrolled — each cell instance is called once per step,
        # which shares its parameters across steps (flax semantics).
        b, s, n, _ = x.shape
        cells = [DCRNNCell(self.hidden_size, self.k, self.root_weight)
                 for _ in range(self.n_layers)]
        h = [jnp.zeros((b, n, self.hidden_size), x.dtype)
             for _ in range(self.n_layers)]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(cells):
                h[i] = cell(inp, h[i], supports)
                inp = h[i]
        return h[-1]


class DCRNNModel(nn.Module):
    """Conditional input encoder + DCRNN + MLP decoder."""
    hidden_size: int
    ff_size: int
    output_size: int
    horizon: int
    n_layers: int = 1
    exog_size: int = 0
    kernel_size: int = 2
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator], u=None,
                 training: bool = False):
        # x: [b s n c]
        if u is not None and self.exog_size:
            if u.ndim == 3:
                u = u[:, :, None, :]
            u = jnp.broadcast_to(u, x.shape[:3] + (u.shape[-1],))
            x = ConditionalBlock(self.hidden_size,
                                 activation=self.activation)(x, u)
        else:
            x = nn.Dense(self.hidden_size)(x)
        h = DCRNN(self.hidden_size, self.n_layers,
                  self.kernel_size)(x, supports)
        return MLPDecoder(self.ff_size, self.output_size,
                          horizon=self.horizon,
                          activation=self.activation,
                          dropout=self.dropout)(h, training=training)
