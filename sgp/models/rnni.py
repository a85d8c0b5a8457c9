"""Autoregressive RNN imputers.

Capability parity with the reference imputation zoo's RNNI family
(``tsl/nn/models/imputation/rnni_models.py:12-123``): fill missing
points with a GRU/LSTM one-step-ahead predictor whose own previous
prediction is fed back wherever the input is missing, plus the
bidirectional variant that merges a forward and a backward pass with a
linear readout over the concatenated hidden states.

Redesign: the reference iterates a Python ``for`` loop over
time with per-step cell dispatches; here the whole autoregressive
recurrence is ONE ``nn.scan`` (lifted ``lax.scan``) so XLA compiles a
single fused program regardless of window length, and the two
directions of the Bi model are two scans over the same compiled cell.

Output contract (consumed by ``train/imputer.py``): the forward returns
either the imputed series alone (``RNNImputerModel``) or a tuple whose
first element is the merged imputation and whose remaining leaves are
auxiliary one-step predictions to be trained with
``prediction_loss_weight`` (``BiRNNImputerModel`` returns
``(x_hat, (x_hat_fwd, x_hat_bwd))`` like the reference).
"""
from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp


def _broadcast_exog(u, x):
    """Give ``u`` a node axis matching ``x [b s n c]``."""
    if u is None:
        return None
    if u.ndim == 3:  # [b s e] -> [b s n e]
        u = jnp.broadcast_to(u[:, :, None, :], x.shape[:3] + (u.shape[-1],))
    return u


class RNNImputerModel(nn.Module):
    """One-step-ahead recurrent imputer
    (``rnni_models.py:12-120`` semantics).

    ``process_nodes_independently=True`` folds nodes into the batch and
    runs one cell per node with shared weights; otherwise all nodes'
    channels are flattened into a single sequence (requires
    ``n_nodes``). ``preds[t]`` is the model's prediction of step ``t``
    using observations up to ``t-1`` (``preds[0]`` is the readout of
    the initial state).
    """
    input_size: int           # channels per node
    hidden_size: int
    exog_size: int = 0
    cell: str = "gru"
    concat_mask: bool = True
    n_nodes: Optional[int] = None
    process_nodes_independently: bool = False
    detach_input: bool = False
    state_init: str = "zero"

    def setup(self):
        if not self.process_nodes_independently and self.n_nodes is None:
            raise ValueError("n_nodes is required unless "
                             "process_nodes_independently=True")
        self.flat_size = (self.input_size if self.process_nodes_independently
                          else self.input_size * self.n_nodes)
        if self.cell == "gru":
            self.rnn_cell = nn.GRUCell(self.hidden_size)
        elif self.cell == "lstm":
            self.rnn_cell = nn.OptimizedLSTMCell(self.hidden_size)
        else:
            raise NotImplementedError(f'"{self.cell}" cell not implemented.')
        self.readout = nn.Dense(self.flat_size)

    def _init_carry(self, batch, dtype):
        def one(name):
            if self.state_init == "noise":
                return jax.random.normal(
                    self.make_rng(name), (batch, self.hidden_size), dtype)
            return jnp.zeros((batch, self.hidden_size), dtype)

        if self.cell == "lstm":
            return (one("state_init_c"), one("state_init"))
        return one("state_init")

    @staticmethod
    def _visible(carry):
        """The hidden state ``h`` the readout sees (LSTM carry=(c, h))."""
        return carry[1] if isinstance(carry, tuple) else carry

    def _step(self, carry, xs):
        cell_carry, x_hat = carry
        x_t, m_t, u_t = xs
        fill = (jax.lax.stop_gradient(x_hat) if self.detach_input
                else x_hat)
        x_p = jnp.where(m_t.astype(bool), x_t, fill)
        parts = [x_p]
        if u_t is not None and u_t.shape[-1]:
            parts.append(u_t)
        if self.concat_mask:
            parts.append(m_t.astype(x_t.dtype))
        cell_carry, h = self.rnn_cell(cell_carry,
                                      jnp.concatenate(parts, -1))
        x_hat = self.readout(h)
        return (cell_carry, x_hat), (h, x_hat)

    def __call__(self, x, mask, u=None, training: bool = False,
                 return_hidden: bool = False):
        # x, mask: [b s n c]; u: [b s e] or [b s n e]
        b, s, n, c = x.shape
        u = _broadcast_exog(u, x)
        if self.process_nodes_independently:
            def flat(v):  # [b s n f] -> time-major [(s, b*n, f)]
                return v.transpose(1, 0, 2, 3).reshape(s, b * n, -1)
        else:
            def flat(v):  # [b s n f] -> time-major [(s, b, n*f)]
                return v.transpose(1, 0, 2, 3).reshape(s, b, -1)
        xf, mf = flat(x), flat(mask)
        uf = flat(u) if u is not None else jnp.zeros(
            xf.shape[:2] + (0,), x.dtype)

        carry0 = self._init_carry(xf.shape[1], x.dtype)
        x_hat0 = self.readout(self._visible(carry0))
        scan = nn.scan(lambda mdl, carry, xs: mdl._step(carry, xs),
                       variable_broadcast="params",
                       split_rngs={"params": False})
        # step t consumes x[t] and predicts x[t+1]; the last step's
        # observation is never consumed (reference loops steps-1 times)
        _, (hs, preds) = scan(self, (carry0, x_hat0),
                              (xf[:-1], mf[:-1], uf[:-1]))
        preds = jnp.concatenate([x_hat0[None], preds], 0)       # [s B F]
        hs = jnp.concatenate([self._visible(carry0)[None], hs], 0)

        x_hat = preds.reshape(s, b, n, c).transpose(1, 0, 2, 3)
        if not return_hidden:
            return x_hat
        if self.process_nodes_independently:
            h = hs.reshape(s, b, n, -1).transpose(1, 0, 2, 3)  # [b s n h]
        else:
            h = hs.transpose(1, 0, 2)                           # [b s h]
        return x_hat, h


class BiRNNImputerModel(nn.Module):
    """Bidirectional variant (``rnni_models.py:123-183``): forward and
    time-reversed one-step imputers, hidden states concatenated and
    read out jointly. Returns ``(x_hat, (x_hat_fwd, x_hat_bwd))``."""
    input_size: int
    hidden_size: int
    exog_size: int = 0
    cell: str = "gru"
    concat_mask: bool = True
    n_nodes: Optional[int] = None
    process_nodes_independently: bool = False
    detach_input: bool = False
    state_init: str = "zero"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, mask, u=None, training: bool = False):
        kw = dict(input_size=self.input_size, hidden_size=self.hidden_size,
                  exog_size=self.exog_size, cell=self.cell,
                  concat_mask=self.concat_mask, n_nodes=self.n_nodes,
                  process_nodes_independently=(
                      self.process_nodes_independently),
                  detach_input=self.detach_input,
                  state_init=self.state_init)
        u = _broadcast_exog(u, x)
        rev = lambda v: None if v is None else jnp.flip(v, axis=1)
        x_hat_fwd, h_fwd = RNNImputerModel(**kw, name="fwd_rnn")(
            x, mask, u=u, return_hidden=True)
        x_hat_bwd, h_bwd = RNNImputerModel(**kw, name="bwd_rnn")(
            rev(x), rev(mask), u=rev(u), return_hidden=True)
        x_hat_bwd, h_bwd = rev(x_hat_bwd), jnp.flip(h_bwd, axis=1)

        h = nn.Dropout(self.dropout)(
            jnp.concatenate([h_fwd, h_bwd], -1),
            deterministic=not training)
        b, s, n, c = x.shape
        if self.process_nodes_independently:
            x_hat = nn.Dense(self.input_size)(h)       # [b s n 2h] -> c
        else:
            x_hat = nn.Dense(self.input_size * self.n_nodes)(h)
            x_hat = x_hat.reshape(b, s, n, c)
        return x_hat, (x_hat_fwd, x_hat_bwd)
