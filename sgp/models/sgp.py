"""SGP decoder models — the only trained part of the SGP pipeline.

Re-design of ``lib/nn/models/sgp_model.py:14-123`` (+ ``sgp_online.py``):
precomputed encoder features go through a grouped projection (one weight
block per hop/layer block of the embedding), optional learned node
embedding, an (optionally residual) MLP trunk, and a linear multi-horizon
readout. Input may be full-graph ``[b (w) n f]`` or IID-sampled
``[b f]`` per (time, node) pair — the same parameters serve both.
Plain JAX (see :mod:`sgp.models.blocks` for the module convention).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from sgp.models.blocks import (MLP, Dropout, GroupedLinear, Linear,
                               LinearReadout, Module, ResidualMLP, Scope,
                               StaticGraphEmbedding, get_activation,
                               maybe_cat_exog)


@dataclasses.dataclass(frozen=True)
class SGPModel(Module):
    """Args mirror the reference flag surface (``sgp_model.py:105-123``).

    ``order`` is the number of blocks in the precomputed embedding —
    derived in the runner as ``(1 + (2 if bidirectional else 1) *
    receptive_field + global_attr) * reservoir_layers``
    (``run_traffic_sgp.py:220-226``).
    """
    input_size: int
    order: int
    n_nodes: int
    hidden_size: int
    mlp_size: int
    output_size: int
    n_layers: int
    horizon: int
    positional_encoding: bool = True
    emb_size: int = 32
    exog_size: int = 0
    resnet: bool = False
    fully_connected: bool = False
    dropout: float = 0.0
    activation: str = "silu"

    def __call__(self, s: Scope, x, u=None, node_index=None,
                 training: bool = False, iid: bool = False):
        # x: [b w n f] / [b n f] (full graph); IID mode (``iid=True``,
        # per-(time,node) samples): [b w f] / [b f] with node_index [b]
        squeeze_nodes = False
        if iid:
            if x.ndim == 3:
                x = x[:, -1]                  # IID [b w f] -> [b f]
            x = x[:, None, :]                 # treat pairs as 1 node
            squeeze_nodes = True
        elif x.ndim == 4:
            x = x[:, -1]                      # last window step -> [b n f]
        # u from the loaders always carries a window dim: [b w f] (global)
        # or [b w n f] (node-level); take the last window step
        # (``sgp_model.py:98-100``, relying on window=1 in all SGP configs)
        if u is not None:
            if u.ndim == 4:
                u = u[:, -1]                  # [b n f]
            elif u.ndim == 3:
                u = u[:, -1]                  # [b f]
            if squeeze_nodes:
                u = u[:, None, :] if u.ndim == 2 else u

        act = get_activation(self.activation)
        if self.fully_connected:
            h = act(s.call(Linear(self.hidden_size), x))
        else:
            out_channels = self.hidden_size - self.hidden_size % self.order
            h = act(s.call(GroupedLinear(out_channels, self.order), x))
        if self.dropout > 0:
            h = s.call(Dropout(self.dropout), h, training)

        if self.positional_encoding:
            emb = s.call(StaticGraphEmbedding(self.n_nodes, self.emb_size),
                         token_index=node_index)
            lin_emb = s.call(Linear(h.shape[-1]), emb)
            if squeeze_nodes:                 # [b, e] -> [b, 1, e]
                lin_emb = lin_emb[:, None, :]
            h = h + lin_emb

        if u is not None:
            h = maybe_cat_exog(h, u)

        trunk = ResidualMLP if self.resnet else MLP
        h = s.call(trunk(hidden_size=self.mlp_size, n_layers=self.n_layers,
                         activation=self.activation, dropout=self.dropout,
                         **({"parametrized_skip": True} if self.resnet
                            else {})),
                   h, training=training)

        out = s.call(LinearReadout(self.output_size, self.horizon), h)
        # out: [b h n c]
        if squeeze_nodes:
            out = out[:, :, 0, :]             # [b h c]
        return out


@dataclasses.dataclass(frozen=True)
class SGPOnlineModel(Module):
    """Online variant (``sgp_model.py:126-194``): the K-hop spatial
    embedding is computed *inside* the forward on the raw last-step
    features, then decoded by :class:`SGPModel`. Used with precomputed
    propagation disabled; the operator list is passed at call time."""
    input_size: int
    n_nodes: int
    output_size: int
    horizon: int
    receptive_field: int = 3
    reservoir_layers: int = 1
    bidirectional: bool = True
    hidden_size: int = 128
    mlp_size: int = 64
    n_layers: int = 1
    positional_encoding: bool = True
    emb_size: int = 32
    exog_size: int = 0
    resnet: bool = False
    fully_connected: bool = False
    dropout: float = 0.0
    activation: str = "silu"

    def __call__(self, s: Scope, x, operators, u=None, node_index=None,
                 training: bool = False):
        if x.ndim == 4:
            x = x[:, -1]
        res = [x]
        cur = x
        for _ in range(self.receptive_field):
            cur = operators[0] @ cur
            res.append(cur)
        if self.bidirectional:
            cur = x
            for _ in range(self.receptive_field):
                cur = operators[1] @ cur
                res.append(cur)
        h = jnp.concatenate(res, axis=-1)
        order = 1 + (2 if self.bidirectional else 1) * self.receptive_field
        return s.call(SGPModel(
            input_size=self.input_size * order,
            order=order * self.reservoir_layers,
            n_nodes=self.n_nodes, hidden_size=self.hidden_size,
            mlp_size=self.mlp_size, output_size=self.output_size,
            n_layers=self.n_layers, horizon=self.horizon,
            positional_encoding=self.positional_encoding,
            emb_size=self.emb_size, exog_size=self.exog_size,
            resnet=self.resnet, fully_connected=self.fully_connected,
            dropout=self.dropout, activation=self.activation),
            h, u=u, node_index=node_index, training=training)
