"""Gated Graph Network baselines (flax).

``GatedGraphNetworkMLPModel`` re-designs ``lib/nn/models/
gated_gn_model.py:83-159`` (+ the tsl base ``gated_gn_model.py:16-120``):
time-flattened MLP encoder with residual blocks, optional node-index-
aware positional embedding, a stack of edge-gated GN layers, residual
decoder and linear horizon readout. ``full_graph=True`` builds the
all-pairs edge list (the model becomes dense spatial attention).
``GatedGraphNetworkConvModel`` (``:162-196``) swaps the MLP encoder for
a strided residual CNN over the window.
"""
from __future__ import annotations

import math
from typing import Optional

import flax.linen as nn
import jax.numpy as jnp
import numpy as np

from sgp.models.blocks import get_activation, maybe_cat_exog
from sgp.models.flax_blocks import StaticGraphEmbedding
from sgp.models.graph_layers import GatedGraphNetwork


def full_graph_edges(n: int):
    """All-pairs edge list (``cartesian_prod``,
    ``gated_gn_model.py:127-130``), emitted dst-major so the
    aggregation qualifies for the sorted segment-sum fast path."""
    dst = np.repeat(np.arange(n, dtype=np.int32), n)
    src = np.tile(np.arange(n, dtype=np.int32), n)
    return src, dst


class _GatedGNBase(nn.Module):
    input_window_size: int
    hidden_size: int
    output_size: int
    horizon: int
    n_nodes: int
    enc_layers: int = 2
    gnn_layers: int = 2
    positional_encoding: bool = True
    activation: str = "silu"
    sorted_edges: bool = False   # edges pre-sorted by dst (coalesce)
    # 'bfloat16' runs the GN message layers (the HBM-dominant
    # [.., N, D, h] intermediates) in bf16 with f32 params and f32
    # neighbor accumulation — the fast training configuration;
    # None keeps everything f32 (reference parity)
    compute_dtype: Optional[str] = None

    def _dt(self):
        return (jnp.bfloat16 if self.compute_dtype in
                ("bf16", "bfloat16") else None)

    def _decode(self, x, node_index, src, dst, edge_mask=None,
                sorted_edges: bool = False, neigh=None, adj=None,
                adj_band=None):
        act = get_activation(self.activation)
        dt = self._dt()
        if self.positional_encoding:
            x = x + StaticGraphEmbedding(self.n_nodes, self.hidden_size)(
                token_index=node_index)
        for _ in range(self.gnn_layers):
            x = GatedGraphNetwork(
                self.hidden_size, self.activation,
                sorted_edges=sorted_edges, dtype=dt,
                # every layer saves its own all-pairs residual set:
                # split a ~12 GB total budget across the stack
                resid_budget_gb=12.0 / max(self.gnn_layers, 1))(
                x, src, dst, edge_mask=edge_mask, neigh=neigh, adj=adj,
                adj_band=adj_band)
        x = act(nn.Dense(self.hidden_size, dtype=dt)(x)) + x
        # horizon readout stays f32
        out = nn.Dense(self.horizon * self.output_size)(
            x.astype(jnp.float32))
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).transpose(0, 2, 1, 3)

    def _edges(self, x, src, dst):
        """Returns ``(src, dst, sorted)`` — the generated full-graph
        list is dst-major, an explicit list is sorted only if the
        caller says so (``sorted_edges``; subgraph padding appends
        dst=0 entries, which breaks the order)."""
        if src is None:
            s, d = (jnp.asarray(a) for a in
                    full_graph_edges(x.shape[-2]))
            return s, d, True
        return src, dst, self.sorted_edges


class GatedGraphNetworkMLPModel(_GatedGNBase):

    @nn.compact
    def __call__(self, x, src=None, dst=None, u=None, node_index=None,
                 edge_mask=None, neigh=None, adj=None, adj_band=None,
                 training: bool = False, **kwargs):
        # x: [b s n f]; neigh=(src_idx [N, D], mask) selects the
        # scatter-free ELL aggregation (padded_incoming); adj
        # ([N, N], A[dst, src] orientation) selects the dense
        # all-pairs matmul aggregation for dense-ish graphs
        act = get_activation(self.activation)
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        src, dst, srt = (None, None, False) \
            if (neigh is not None or adj is not None) \
            else self._edges(x, src, dst)
        xw = x[:, -self.input_window_size:]
        b, s, n, f = xw.shape
        h = xw.transpose(0, 2, 1, 3).reshape(b, n, s * f)
        h = nn.Dense(self.hidden_size)(h)
        for _ in range(self.enc_layers):
            blk = nn.Dense(self.hidden_size)(
                act(nn.Dense(self.hidden_size)(h)))
            h = blk + h
        return self._decode(h, node_index, src, dst, edge_mask,
                            sorted_edges=srt, neigh=neigh, adj=adj,
                            adj_band=adj_band)


class Conv1dResidual(nn.Module):
    hidden_size: Optional[int] = None

    @nn.compact
    def __call__(self, x):
        # x: [b, s, c] conv over s with kernel 1
        c = x.shape[-1]
        hidden = self.hidden_size or c // 2
        h = nn.silu(nn.Conv(hidden, kernel_size=(1,))(x))
        return x + nn.Conv(c, kernel_size=(1,))(h)


class CNNResidual(nn.Module):
    """Strided log-depth CNN window encoder
    (``gated_gn_model.py:30-80``)."""
    out_channels: int
    input_window_size: int
    hidden_size: int = 64
    max_hidden_size: int = 256
    kernel_size: int = 5

    @nn.compact
    def __call__(self, x):
        # x: [b, s, c] -> [b, out_channels]
        n_layers = math.ceil(math.log(self.input_window_size,
                                      self.kernel_size))
        hidden = self.hidden_size
        length = self.input_window_size
        for i in range(max(n_layers, 1)):
            if i > 0:
                hidden = min(hidden * 2, self.max_hidden_size)
            pad = int((-length) % self.kernel_size)
            x = jnp.pad(x, ((0, 0), (pad, 0), (0, 0)))
            x = nn.Conv(hidden, kernel_size=(self.kernel_size,),
                        strides=(self.kernel_size,), padding="VALID")(x)
            x = Conv1dResidual()(x)
            length = (length + pad) // self.kernel_size
        x = x.reshape(x.shape[0], -1)
        if x.shape[-1] != self.out_channels:
            x = nn.Dense(self.out_channels)(x)
        return x


class GatedGraphNetworkConvModel(_GatedGNBase):

    @nn.compact
    def __call__(self, x, src=None, dst=None, u=None, node_index=None,
                 edge_mask=None, training: bool = False, **kwargs):
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        src, dst, srt = self._edges(x, src, dst)
        xw = x[:, -self.input_window_size:]
        b, s, n, f = xw.shape
        flat = xw.transpose(0, 2, 1, 3).reshape(b * n, s, f)
        h = CNNResidual(self.hidden_size, self.input_window_size,
                        hidden_size=self.hidden_size)(flat)
        h = h.reshape(b, n, -1)
        return self._decode(h, node_index, src, dst, edge_mask,
                            sorted_edges=srt)
