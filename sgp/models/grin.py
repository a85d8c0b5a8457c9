"""GRIN imputation family (flax).

Counterpart of ``tsl/nn/layers/graph_convs/grin_cell.py:40-235`` (GRIL +
SpatialDecoder) and the GRIN imputation model
(``tsl/nn/models/imputation/grin_model.py``): a DCRNN-cell recurrence
whose per-step input is the series with missing values filled by a
two-stage imputation — first-stage readout from the hidden state, then a
spatial decoder that aggregates neighbor information. The bidirectional
model runs GRIL forward and on the time-reversed series and merges with
an MLP.
"""
from __future__ import annotations

from typing import Optional, Sequence

import flax.linen as nn
import jax.numpy as jnp

from sgp.models.flax_blocks import MLP, StaticGraphEmbedding
from sgp.models.dcrnn import DCRNNCell
from sgp.models.graph_layers import DiffConv
from sgp.ops.spmm import Operator


class SpatialDecoder(nn.Module):
    """``grin_cell.py:40-105``: [x, mask, h(, u)] -> graph conv ->
    residual readout; returns (imputation, representation)."""
    input_size: int
    hidden_size: int
    order: int = 1

    @nn.compact
    def __call__(self, x, mask, h, supports: Sequence[Operator], u=None):
        x_in = [x, mask, h] + ([u] if u is not None else [])
        x_in = nn.Dense(self.hidden_size)(jnp.concatenate(x_in, -1))
        out = DiffConv(self.hidden_size, k=self.order,
                       root_weight=False)(x_in, supports)
        out = jnp.concatenate([out, h], -1)
        # PReLU with learned slope (reference uses nn.PReLU)
        slope = self.param("prelu_slope", nn.initializers.constant(0.25),
                           ())
        z = nn.Dense(self.hidden_size)(out)
        z = jnp.where(z >= 0, z, slope * z)
        repr_s = jnp.concatenate([z, h], -1)
        return nn.Dense(self.input_size)(repr_s), repr_s


class GRIL(nn.Module):
    """``grin_cell.py:108-235``: per-step two-stage imputation + DCRNN
    state update. Returns (imputations, predictions, representations)."""
    input_size: int
    hidden_size: int
    exog_size: int = 0
    n_layers: int = 1
    n_nodes: Optional[int] = None
    kernel_size: int = 2
    decoder_order: int = 1
    layer_norm: bool = False

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator], mask=None, u=None):
        b, s, n, c = x.shape
        if mask is None:
            mask = jnp.ones_like(x)
        cells = [DCRNNCell(self.hidden_size, self.kernel_size)
                 for _ in range(self.n_layers)]
        norms = [nn.LayerNorm() if self.layer_norm else (lambda v: v)
                 for _ in range(self.n_layers)]
        first_stage = nn.Dense(self.input_size)
        decoder = SpatialDecoder(self.input_size, self.hidden_size,
                                 self.decoder_order)
        if self.n_nodes is not None:
            h = [jnp.broadcast_to(
                StaticGraphEmbedding(self.n_nodes, self.hidden_size)()[None],
                (b, n, self.hidden_size)) for _ in range(self.n_layers)]
        else:
            h = [jnp.zeros((b, n, self.hidden_size), x.dtype)
                 for _ in range(self.n_layers)]
        imputations, predictions, reprs = [], [], []
        for t in range(s):
            x_s, m_s = x[:, t], mask[:, t]
            u_s = u[:, t] if u is not None else None
            h_top = h[-1]
            xs_hat_1 = first_stage(h_top)
            x_s = jnp.where(m_s.astype(bool), x_s, xs_hat_1)
            xs_hat_2, repr_s = decoder(x_s, m_s, h_top, supports, u=u_s)
            x_s = jnp.where(m_s.astype(bool), x_s, xs_hat_2)
            inputs = [x_s, m_s] + ([u_s] if u_s is not None else [])
            rnn_in = jnp.concatenate(inputs, -1)
            for i, (cell, norm) in enumerate(zip(cells, norms)):
                h[i] = norm(cell(rnn_in, h[i], supports))
                rnn_in = h[i]
            imputations.append(xs_hat_2)
            predictions.append(xs_hat_1)
            reprs.append(repr_s)
        return (jnp.stack(imputations, 1), jnp.stack(predictions, 1),
                jnp.stack(reprs, 1))


class GRINModel(nn.Module):
    """Bidirectional GRIL + MLP merge
    (``models/imputation/grin_model.py``). Returns the merged imputation
    (plus the per-direction stage outputs for the training losses)."""
    input_size: int
    hidden_size: int
    exog_size: int = 0
    n_layers: int = 1
    n_nodes: Optional[int] = None
    kernel_size: int = 2
    decoder_order: int = 1
    ff_size: int = 64
    merge_mode: str = "mlp"

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator], mask=None, u=None,
                 training: bool = False, **kwargs):
        fwd = GRIL(self.input_size, self.hidden_size, self.exog_size,
                   self.n_layers, self.n_nodes, self.kernel_size,
                   self.decoder_order)
        bwd = GRIL(self.input_size, self.hidden_size, self.exog_size,
                   self.n_layers, self.n_nodes, self.kernel_size,
                   self.decoder_order)
        rev = lambda a: None if a is None else jnp.flip(a, axis=1)
        imp_f, pred_f, repr_f = fwd(x, supports, mask=mask, u=u)
        imp_b, pred_b, repr_b = bwd(rev(x), supports, mask=rev(mask),
                                    u=rev(u))
        imp_b, pred_b, repr_b = rev(imp_b), rev(pred_b), rev(repr_b)
        if self.merge_mode == "mlp":
            inputs = [repr_f, repr_b]
            if mask is not None:
                inputs.append(mask)
            merged = MLP(self.ff_size, self.input_size)(
                jnp.concatenate(inputs, -1), training=training)
        else:
            merged = 0.5 * (imp_f + imp_b)
        return merged, (imp_f, pred_f), (imp_b, pred_b)
