"""Additional spatiotemporal blocks and models completing the zoo.

Counterparts of the reference components present in the zoo but unused
by the five experiment scripts (SURVEY.md §2.4 "unused" rows) — provided
for API-surface parity:

- GraphConv-gated recurrent cells / encoders
  (``blocks/encoders/gcgru.py``, ``gclstm.py``, ``dense_dcrnn.py``)
- STCN block + model (``encoders/stcn.py``, ``models/stgn/stcn_model.py``)
- TCN model (``models/tcn_model.py``), RNN-enc/GCN-dec model
  (``models/stgn/rnn2gcn_model.py``)
- decoders: MultiHorizonMLPDecoder (``decoders/multi_step_mlp_decoder``),
  GCNDecoder (``decoders/gcn_decoder``), AttPool (``decoders/att_pool``)
- ConditionalTCNBlock (``encoders/conditional.py:90+``), InputEncoder
  (``encoders/input_encoder.py``)
- nn ops: Lambda / Concatenate / Select (``ops/ops.py``)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import flax.linen as nn
import jax.numpy as jnp

from sgp.models.blocks import get_activation, maybe_cat_exog
from sgp.models.flax_blocks import MLP, MLPDecoder
from sgp.models.graph_layers import ConditionalBlock, GraphConv
from sgp.models.tcn import TemporalConv, TemporalConvNet
from sgp.ops.spmm import Operator


# -- recurrent graph cells -------------------------------------------------

class GraphConvGRUCell(nn.Module):
    """GRU with GraphConv gates (``gcgru.py``)."""
    hidden_size: int
    root_weight: bool = True

    @nn.compact
    def __call__(self, x, h, op: Operator):
        xh = jnp.concatenate([x, h], -1)
        r = nn.sigmoid(GraphConv(self.hidden_size,
                                 self.root_weight)(xh, op))
        u = nn.sigmoid(GraphConv(self.hidden_size,
                                 self.root_weight)(xh, op))
        c = jnp.tanh(GraphConv(self.hidden_size, self.root_weight)(
            jnp.concatenate([x, r * h], -1), op))
        return u * h + (1.0 - u) * c


class GraphConvLSTMCell(nn.Module):
    """LSTM with GraphConv gates (``gclstm.py``)."""
    hidden_size: int

    @nn.compact
    def __call__(self, x, state, op: Operator):
        h, c = state
        xh = jnp.concatenate([x, h], -1)
        i = nn.sigmoid(GraphConv(self.hidden_size)(xh, op))
        f = nn.sigmoid(GraphConv(self.hidden_size)(xh, op))
        g = jnp.tanh(GraphConv(self.hidden_size)(xh, op))
        o = nn.sigmoid(GraphConv(self.hidden_size)(xh, op))
        c_new = f * c + i * g
        return o * jnp.tanh(c_new), (o * jnp.tanh(c_new), c_new)


class GraphConvRNN(nn.Module):
    """Stacked GraphConv-gated recurrence over ``[b s n c]``; returns
    the last hidden state of the top layer."""
    hidden_size: int
    n_layers: int = 1
    cell: str = "gru"

    @nn.compact
    def __call__(self, x, op: Operator):
        b, s, n, _ = x.shape
        cells = [(GraphConvGRUCell(self.hidden_size)
                  if self.cell == "gru"
                  else GraphConvLSTMCell(self.hidden_size))
                 for _ in range(self.n_layers)]
        if self.cell == "gru":
            state = [jnp.zeros((b, n, self.hidden_size), x.dtype)
                     for _ in range(self.n_layers)]
        else:
            state = [(jnp.zeros((b, n, self.hidden_size), x.dtype),) * 2
                     for _ in range(self.n_layers)]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(cells):
                if self.cell == "gru":
                    state[i] = cell(inp, state[i], op)
                    inp = state[i]
                else:
                    inp, state[i] = cell(inp, state[i], op)
        return inp


class DenseDCRNNCell(nn.Module):
    """GRU with dense order-K diffusion gates on a learned/dense
    adjacency (``encoders/dense_dcrnn.py:7-80``)."""
    hidden_size: int
    k: int = 2

    @nn.compact
    def __call__(self, x, h, adj: jnp.ndarray):
        from sgp.models.gwnet import DenseSpatialConvOrderK

        def gate(inp, name):
            return DenseSpatialConvOrderK(self.hidden_size, self.k,
                                          name=name)(inp[:, None], adj
                                                     )[:, 0]
        xh = jnp.concatenate([x, h], -1)
        r = nn.sigmoid(gate(xh, "forget"))
        u = nn.sigmoid(gate(xh, "update"))
        c = jnp.tanh(gate(jnp.concatenate([x, r * h], -1), "cand"))
        return u * h + (1.0 - u) * c


# -- temporal/conditional blocks ------------------------------------------

class ConditionalTCNBlock(nn.Module):
    """ConditionalBlock with temporal convolutions
    (``encoders/conditional.py:90-164``)."""
    output_size: int
    kernel_size: int = 2
    dilation: int = 1
    gated: bool = False
    activation: str = "relu"
    dropout: float = 0.0
    skip_connection: bool = False

    @nn.compact
    def __call__(self, x, u, training: bool = False):
        act = get_activation(self.activation)
        xc = TemporalConv(self.output_size, self.kernel_size,
                          self.dilation, gated=self.gated)(x)
        uc = TemporalConv(self.output_size, self.kernel_size,
                          self.dilation, gated=self.gated)(u)
        if not self.gated:
            xc, uc = act(xc), act(uc)
        out = nn.Dense(self.output_size)(xc) \
            + nn.Dense(self.output_size, use_bias=False)(uc)
        out = act(out)
        if self.dropout > 0:
            out = nn.Dropout(self.dropout, deterministic=not training)(out)
        if self.skip_connection:
            out = out + nn.Dense(self.output_size)(x[:, -out.shape[1]:])
        return out


class InputEncoder(nn.Module):
    """Dispatcher mlp/conditional (``encoders/input_encoder.py:9-57``)."""
    output_size: int
    enc_type: str = "mlp"
    activation: str = "relu"

    @nn.compact
    def __call__(self, x, u=None, training: bool = False):
        if self.enc_type == "conditional" and u is not None:
            if u.ndim == 3:
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            return ConditionalBlock(self.output_size,
                                    activation=self.activation)(x, u)
        x = maybe_cat_exog(x, u)
        return MLP(self.output_size,
                   activation=self.activation)(x, training=training)


class STCNBlock(nn.Module):
    """Temporal conv + spatial GraphConv sandwich
    (``encoders/stcn.py:10-78``)."""
    hidden_size: int
    temporal_kernel_size: int = 2
    dilation: int = 1
    gated: bool = False
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, op: Operator, training: bool = False):
        act = get_activation(self.activation)
        h = TemporalConvNet(self.hidden_size, self.temporal_kernel_size,
                            dilation=self.dilation, gated=self.gated,
                            activation=self.activation,
                            dropout=self.dropout)(x, training=training)
        h = act(GraphConv(self.hidden_size)(h, op))
        if self.dropout > 0:
            h = nn.Dropout(self.dropout, deterministic=not training)(h)
        skip = x if x.shape[-1] == self.hidden_size \
            else nn.Dense(self.hidden_size)(x)
        return nn.LayerNorm()(h + skip)


# -- decoders --------------------------------------------------------------

class MultiHorizonMLPDecoder(nn.Module):
    """Per-step MLP decoder with known-future context
    (``decoders/multi_step_mlp_decoder.py:8``): one shared MLP applied
    per horizon step on [state, step embedding]."""
    hidden_size: int
    output_size: int
    horizon: int
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, h, training: bool = False):
        # h: [b n f] (or [b s n f] -> last step)
        if h.ndim == 4:
            h = h[:, -1]
        step_emb = self.param("step_emb", nn.initializers.normal(0.02),
                              (self.horizon, self.hidden_size))
        outs = []
        mlp = MLP(self.hidden_size, self.output_size,
                  activation=self.activation, dropout=self.dropout)
        for t in range(self.horizon):
            ctx = jnp.broadcast_to(step_emb[t], h.shape[:-1]
                                   + (self.hidden_size,))
            outs.append(mlp(jnp.concatenate([h, ctx], -1),
                            training=training))
        return jnp.stack(outs, axis=1)  # [b h n c]


class GCNDecoder(nn.Module):
    """GraphConv stack + MLP readout (``decoders/gcn_decoder.py:9``)."""
    hidden_size: int
    output_size: int
    horizon: int
    n_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, h, op: Operator, training: bool = False):
        act = get_activation(self.activation)
        if h.ndim == 4:
            h = h[:, -1]
        for _ in range(self.n_layers):
            h = act(GraphConv(self.hidden_size)(h, op))
        return MLPDecoder(self.hidden_size, self.output_size,
                          horizon=self.horizon,
                          activation=self.activation,
                          dropout=self.dropout)(h, training=training)


class AttPool(nn.Module):
    """Attention pooling over an axis (``decoders/att_pool.py:5``)."""
    axis: int = 1

    @nn.compact
    def __call__(self, x):
        scores = nn.Dense(1)(x)
        att = nn.softmax(scores, axis=self.axis)
        return (x * att).sum(self.axis)


# -- models ----------------------------------------------------------------

class TCNModel(nn.Module):
    """Pure temporal-conv forecaster (``models/tcn_model.py:15``)."""
    hidden_size: int
    ff_size: int
    output_size: int
    horizon: int
    kernel_size: int = 3
    n_layers: int = 3
    gated: bool = False
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, u=None, training: bool = False, **kwargs):
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        x = nn.Dense(self.hidden_size)(x)
        x = TemporalConvNet(self.hidden_size, self.kernel_size,
                            dilation=2, n_layers=self.n_layers,
                            exponential_dilation=True, gated=self.gated,
                            activation=self.activation,
                            dropout=self.dropout)(x, training=training)
        return MLPDecoder(self.ff_size, self.output_size,
                          horizon=self.horizon,
                          activation=self.activation,
                          dropout=self.dropout)(x[:, -1],
                                                training=training)


class STCNModel(nn.Module):
    """Stacked STCN blocks + readout (``models/stgn/stcn_model.py:13``)."""
    hidden_size: int
    ff_size: int
    output_size: int
    horizon: int
    n_layers: int = 2
    temporal_kernel_size: int = 2
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, op: Operator, u=None, training: bool = False,
                 **kwargs):
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        for i in range(self.n_layers):
            x = STCNBlock(self.hidden_size, self.temporal_kernel_size,
                          dilation=2 ** i, activation=self.activation,
                          dropout=self.dropout)(x, op, training=training)
        return MLPDecoder(self.ff_size, self.output_size,
                          horizon=self.horizon,
                          activation=self.activation)(x[:, -1],
                                                      training=training)


class RNNEncGCNDecModel(nn.Module):
    """GRU encoder per node + GCN decoder
    (``models/stgn/rnn2gcn_model.py:11``)."""
    hidden_size: int
    output_size: int
    horizon: int
    rec_layers: int = 1
    gcn_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, op: Operator, u=None, training: bool = False,
                 **kwargs):
        from sgp.models.rnn import _RNNStack
        if u is not None:
            if u.ndim == 3:  # global exog -> broadcast over nodes
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)
        b, s, n, f = x.shape
        xt = x.transpose(0, 2, 1, 3).reshape(b * n, s, f)
        h = _RNNStack(self.hidden_size, self.rec_layers)(xt)
        h = h.reshape(b, n, -1)
        return GCNDecoder(self.hidden_size, self.output_size,
                          self.horizon, n_layers=self.gcn_layers,
                          activation=self.activation,
                          dropout=self.dropout)(h, op, training=training)


class LinkPredictor(nn.Module):
    """Pairwise score matrix from node embeddings
    (``tsl/nn/layers/link_predictor.py:7-60``):
    ``S = MLP_s(E) MLP_t(E)^T``."""
    ff_size: int
    hidden_size: int
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        act = get_activation(self.activation)

        def branch(v):
            v = act(nn.Dense(self.ff_size)(v))
            if self.dropout > 0:
                v = nn.Dropout(self.dropout,
                               deterministic=not training)(v)
            return nn.Dense(self.hidden_size)(v)
        z_s, z_t = branch(x), branch(x)
        return jnp.einsum("...ik,...jk->...ij", z_s, z_t)


class DifferentiableBinarySampler(nn.Module):
    """Gumbel-max Bernoulli relaxation
    (``blocks/encoders/nri_dcrnn.py:12-29``)."""

    @nn.compact
    def __call__(self, scores, tau, rng):
        import jax
        eps = 1e-8
        unif = jax.random.uniform(rng, scores.shape)
        logit = (jnp.log(scores + eps) - jnp.log(1 - scores + eps)
                 + jnp.log(unif + eps) - jnp.log(1 - unif + eps))
        return nn.sigmoid(logit / tau)


class NRIDCRNN(nn.Module):
    """Neural-relational-inference DCRNN
    (``nri_dcrnn.py:33-69`` NeuRelInfDCRNN): dense adjacency learned by
    a LinkPredictor over static node embeddings, sampled with the
    Gumbel trick, driving DenseDCRNN cells."""
    hidden_size: int
    emb_size: int
    n_nodes: int
    n_layers: int = 1
    k: int = 2
    tau: float = 0.25

    @nn.compact
    def __call__(self, x, rng=None, training: bool = False):
        from sgp.models.flax_blocks import StaticGraphEmbedding
        from sgp.models.gwnet import DenseSpatialConvOrderK
        import jax
        emb = StaticGraphEmbedding(self.n_nodes, self.emb_size)()
        scores = nn.sigmoid(LinkPredictor(
            self.hidden_size, self.hidden_size)(emb,
                                                training=training))
        # the reference samples unconditionally (train AND eval,
        # nri_dcrnn.py forward); without an rng fall back to the mean
        # adjacency (documented divergence for deterministic eval)
        if rng is not None:
            adj_raw = DifferentiableBinarySampler()(scores, self.tau, rng)
        else:
            adj_raw = scores
        # row-normalized forward+backward supports (compute_support,
        # dense_dcrnn.py) — DenseDCRNNCell expects row-stochastic input
        adj = DenseSpatialConvOrderK.compute_support(adj_raw)
        b, s, n, _ = x.shape
        cells = [DenseDCRNNCell(self.hidden_size, self.k)
                 for _ in range(self.n_layers)]
        h = [jnp.zeros((b, n, self.hidden_size), x.dtype)
             for _ in range(self.n_layers)]
        for t in range(s):
            inp = x[:, t]
            for i, cell in enumerate(cells):
                h[i] = cell(inp, h[i], adj)
                inp = h[i]
        return h[-1]


# -- nn ops (``tsl/nn/ops/ops.py:9-39``) ----------------------------------

class Lambda(nn.Module):
    fn: Callable

    def __call__(self, x):
        return self.fn(x)


class Concatenate(nn.Module):
    axis: int = -1

    def __call__(self, tensors: Sequence[jnp.ndarray]):
        return jnp.concatenate(list(tensors), axis=self.axis)


class Select(nn.Module):
    axis: int
    index: int

    def __call__(self, x):
        return jnp.take(x, self.index, axis=self.axis)
