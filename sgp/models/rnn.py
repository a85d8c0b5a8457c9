"""GRU/LSTM baselines (``tsl/nn/models/rnn_model.py:12-154``).

``RNNModel``: per-node recurrent encoder over the window (cuDNN GRU/LSTM
in the reference -> ``nn.RNN``/``lax.scan`` cells here) + MLP decoder.
``FCRNNModel``: the fully-connected variant — all nodes' channels
flattened into one sequence (``rnn_model.py:117-154``).
"""
from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from sgp.models.blocks import maybe_cat_exog
from sgp.models.flax_blocks import MLPDecoder


class _RNNStack(nn.Module):
    hidden_size: int
    n_layers: int = 1
    cell: str = "gru"

    @nn.compact
    def __call__(self, x):
        # x: [b, s, f] -> last hidden [b, hidden]
        for _ in range(self.n_layers):
            cell = (nn.GRUCell(self.hidden_size) if self.cell == "gru"
                    else nn.OptimizedLSTMCell(self.hidden_size))
            x = nn.RNN(cell)(x)
        return x[:, -1]


class RNNModel(nn.Module):
    output_size: int
    horizon: int
    hidden_size: int = 64
    ff_size: int = 64
    rec_layers: int = 1
    ff_layers: int = 1
    cell_type: str = "gru"
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, u=None, training: bool = False, **kwargs):
        # x: [b s n f] — nodes fold into the batch (per-node recurrence)
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        xt = x.transpose(0, 2, 1, 3).reshape(b * n, s, f)
        h = _RNNStack(self.hidden_size, self.rec_layers, self.cell_type)(xt)
        h = h.reshape(b, n, -1)
        return MLPDecoder(self.ff_size, self.output_size,
                          horizon=self.horizon, n_layers=self.ff_layers,
                          activation=self.activation, dropout=self.dropout
                          )(h, training=training)


class FCRNNModel(nn.Module):
    """FC-LSTM/GRU: one sequence over the flattened (node, channel) axis."""
    n_nodes: int
    output_size: int
    horizon: int
    hidden_size: int = 64
    ff_size: int = 64
    rec_layers: int = 1
    ff_layers: int = 1
    cell_type: str = "gru"
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, u=None, training: bool = False, **kwargs):
        # x: [b s n f] -> [b s (n f)]
        if u is not None:
            if u.ndim == 3:
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], axis=-1)
        b, s, n, f = x.shape
        xt = x.reshape(b, s, n * f)
        h = _RNNStack(self.hidden_size, self.rec_layers, self.cell_type)(xt)
        h = h[:, None, :]  # [b 1 hidden] — single "node"
        out = MLPDecoder(self.ff_size, self.output_size * self.n_nodes,
                         horizon=self.horizon, n_layers=self.ff_layers,
                         activation=self.activation, dropout=self.dropout
                         )(h, training=training)      # [b h 1 (n c)]
        return out.reshape(b, self.horizon, self.n_nodes, self.output_size)
