"""Graph echo-state network (DynGESN encoder).

Re-design of ``lib/nn/reservoir/graph_reservoir.py:19-144`` +
``tsl/nn/blocks/encoders/gcrnn.py:40-93``: the recurrent term is
graph-propagated —

    h' = (1 - alpha) * h + alpha * act(W_ih x + b + A @ (h W_hh^T))

with A a row-normalized adjacency (self-loops added by the encoder,
``lib/nn/encoders/dyn_gesn_encoder.py:37-42``). One ``lax.scan`` over
time; each step is GEMM + SpMM (one matmul on the dense operator path).
Stacked layers' states are concatenated channel-wise
(``_cat_states_layers=True``, ``graph_reservoir.py:97``).
"""
from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from sgp.encode.reservoir import (_ACTIVATIONS, ReservoirLayerParams,
                                  _init_layer)
from sgp.ops.spmm import Operator


class GraphESN:
    """Stacked frozen GESN layers; same randomized init as
    :class:`~sgp.encode.reservoir.Reservoir`."""

    def __init__(self, input_size: int, hidden_size: int,
                 input_scaling: float = 1.0, num_layers: int = 1,
                 leaking_rate: float = 0.9, spectral_radius: float = 0.9,
                 density: float = 0.9, activation: str = "tanh",
                 bias: bool = True, alpha_decay: bool = False,
                 seed: int = 0):
        assert activation in _ACTIVATIONS
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.activation = activation
        rng = np.random.default_rng(seed)
        layers: List[ReservoirLayerParams] = []
        alpha = leaking_rate
        for i in range(num_layers):
            layers.append(_init_layer(
                rng, input_size if i == 0 else hidden_size, hidden_size,
                spectral_radius, alpha, density, input_scaling, bias, 1.0))
            if alpha_decay:
                alpha = float(np.clip(alpha - 0.1, 0.1, 1.0))
        self.layers = layers

    @classmethod
    def from_arrays(cls, weights, activation: str = "tanh") -> "GraphESN":
        obj = cls.__new__(cls)
        obj.activation = activation
        obj.layers = [ReservoirLayerParams(
            jnp.asarray(w["w_ih"], jnp.float32),
            jnp.asarray(w["w_hh"], jnp.float32),
            None if w.get("b_ih") is None
            else jnp.asarray(w["b_ih"], jnp.float32),
            float(w.get("alpha", 0.9))) for w in weights]
        obj.num_layers = len(obj.layers)
        obj.hidden_size = obj.layers[0].w_hh.shape[0]
        obj.input_size = obj.layers[0].w_ih.shape[1]
        return obj

    @property
    def output_size(self) -> int:
        return self.num_layers * self.hidden_size

    def __call__(self, x: jnp.ndarray, op: Operator,
                 return_last_state: bool = False,
                 out_dtype=None, h0=None,
                 with_state: bool = False) -> jnp.ndarray:
        """``x [T, N, F]`` + normalized operator -> ``[T, N, L*H]``.
        ``out_dtype`` casts each step inside the scan (the f32 state
        history is never materialized — required when the full-series
        encoding approaches HBM capacity). ``h0``/``with_state`` carry
        the per-layer state across calls (streaming / online serving),
        as in :class:`~sgp.encode.reservoir.Reservoir`."""
        return gesn_scan(tuple(self.layers), self.activation, op, x,
                         return_last_state, out_dtype=out_dtype, h0=h0,
                         with_state=with_state)

    def step(self, h, op: Operator, x_t: jnp.ndarray):
        """Single-step update (online serving): ``x_t [N, F]`` +
        per-layer state list -> new state list."""
        return _gesn_step(tuple(self.layers),
                          _ACTIVATIONS[self.activation], op, list(h),
                          x_t)


def _gesn_cell(p, act, op, h, x_t):
    rec = op @ (h @ p.w_hh.T)           # A (h W_hh^T): SpMM over nodes
    pre = x_t @ p.w_ih.T + rec
    if p.b_ih is not None:
        pre = pre + p.b_ih
    return (1.0 - p.alpha) * h + p.alpha * act(pre)


def _gesn_step(layers, act, op, h, x_t):
    new_h = []
    inp = x_t
    for i, p in enumerate(layers):
        hi = _gesn_cell(p, act, op, h[i], inp)
        new_h.append(hi)
        inp = hi
    return new_h


@functools.partial(jax.jit,
                   static_argnames=("activation", "return_last_state",
                                    "out_dtype", "with_state"))
def gesn_scan(layers, activation: str, op: Operator, x,
              return_last_state: bool = False, out_dtype=None,
              h0=None, with_state: bool = False):
    act = _ACTIVATIONS[activation]
    n = x.shape[-2]

    def step(h, x_t):
        new_h = _gesn_step(layers, act, op, h, x_t)
        out_t = jnp.concatenate(new_h, axis=-1)
        if out_dtype is not None:
            out_t = out_t.astype(out_dtype)
        return new_h, out_t

    if h0 is None:
        h0 = [jnp.zeros((n, p.w_hh.shape[0]), x.dtype) for p in layers]
    last_h, out = jax.lax.scan(step, list(h0), x)
    if return_last_state:
        return jnp.concatenate(last_h, -1)
    if with_state:
        return out, last_h
    return out
