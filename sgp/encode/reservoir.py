"""Randomized echo-state reservoir over time.

Re-design of the reference ESN (``lib/nn/reservoir/
reservoir.py:18-186``): the per-step update

    h' = (1 - alpha) * h + alpha * act(W_ih x + b_ih + W_hh h)

runs as a single ``jax.lax.scan`` over time, jitted once — the torch
version's Python loop over 34k steps (``reservoir.py:170-180``) becomes
one XLA while-loop with fused GEMM+GEMM+act per step. Layers are stacked
(layer i feeds layer i+1's input); per-step states of all layers are
concatenated channel-wise, matching the reference output ``[t, n, L*H]``.

The recurrence's matmuls run in full float32 (``precision="highest"``),
as the reference's do. At JAX's default precision a GPU may round them
to TF32 (10 mantissa bits), and a reservoir near spectral radius 1
carries that rounding forward: on an H100 the PV-US encoder (8 layers x
16 units, 5,016 nodes) drifted 7.5e-2 (max abs, features of order 1)
from float32 within 512 steps. The matmuls are tiny (16 x <= 19), so
full precision is not where the scan's time goes.

Initialization reproduces the reference's *construction* (not its torch
RNG bit-stream): U(-1,1) scaled input/bias weights, recurrent U(-1,1)
with a random density mask, exact spectral-radius rescale on host
(``reservoir.py:54-75``). ``Reservoir.from_arrays`` imports externally
generated (e.g. torch) weights for activation-allclose parity testing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sgp.ops.linalg import spectral_radius_exact


def self_normalizing_activation(x: jnp.ndarray, r: float = 1.0):
    """``r * x / ||x||_2`` along the channel axis (``lib/utils.py:50-51``)."""
    norm = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return r * x / jnp.maximum(norm, 1e-12)


_F32 = jax.lax.Precision.HIGHEST

_ACTIVATIONS = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "identity": lambda x: x,
    "self_norm": self_normalizing_activation,
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ReservoirLayerParams:
    w_ih: jnp.ndarray            # [H, F_in]
    w_hh: jnp.ndarray            # [H, H]
    b_ih: Optional[jnp.ndarray]  # [H] or None
    alpha: float


def _init_layer(rng: np.random.Generator, input_size: int, hidden_size: int,
                spectral_radius: float, leaking_rate: float,
                density: float, in_scaling: float, bias: bool,
                bias_scale: float) -> ReservoirLayerParams:
    w_ih = rng.uniform(-1, 1, (hidden_size, input_size)) * in_scaling
    b_ih = rng.uniform(-1, 1, hidden_size) * bias_scale if bias else None
    w_hh = rng.uniform(-1, 1, (hidden_size, hidden_size))
    if density < 1:
        n_units = hidden_size * hidden_size
        mask = np.ones(n_units)
        drop = rng.permutation(n_units)[:int(n_units * (1 - density))]
        mask[drop] = 0.0
        w_hh = w_hh * mask.reshape(hidden_size, hidden_size)
    w_hh = w_hh * (spectral_radius / spectral_radius_exact(w_hh))
    return ReservoirLayerParams(
        jnp.asarray(w_ih, jnp.float32), jnp.asarray(w_hh, jnp.float32),
        None if b_ih is None else jnp.asarray(b_ih, jnp.float32),
        float(leaking_rate))


class Reservoir:
    """Stacked frozen echo-state layers with optional alpha decay
    (``reservoir.py:84-125``: alpha decremented by 0.1 per layer,
    clipped to [0.1, 1])."""

    def __init__(self, input_size: int, hidden_size: int,
                 input_scaling: float = 1.0, num_layers: int = 1,
                 leaking_rate: float = 0.9, spectral_radius: float = 0.9,
                 density: float = 0.9, activation: str = "tanh",
                 bias: bool = True, alpha_decay: bool = False,
                 seed: int = 0):
        assert activation in _ACTIVATIONS, activation
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
                spectral_radius, alpha, density, input_scaling,
                bias, 1.0))
            if alpha_decay:
                alpha = float(np.clip(alpha - 0.1, 0.1, 1.0))
        self.layers = layers

    @classmethod
    def from_arrays(cls, weights: Sequence[dict], activation: str = "tanh"
                    ) -> "Reservoir":
        """Import external (e.g. torch-exported) weights: a sequence of
        dicts with keys ``w_ih [H, F]``, ``w_hh [H, H]``, optional
        ``b_ih [H]`` and ``alpha``."""
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

    def __call__(self, x: jnp.ndarray, h0=None,
                 return_last_state: bool = False,
                 out_dtype=None, with_state: bool = False) -> jnp.ndarray:
        """Run the scan. ``x [T, N, F]`` (or ``[T, B, F]`` — any flat
        batch axis) -> ``[T, N, L*H]``; ``return_last_state`` gives only
        the final step ``[N, L*H]``. ``out_dtype`` (e.g. bf16) casts each
        step's output INSIDE the scan, so the f32 state history is never
        materialized (halves the output HBM footprint). ``with_state``
        returns ``(out, last_h)`` where ``last_h`` is the per-layer state
        list — feed it back as ``h0`` to continue the scan chunk by chunk
        (streaming encode)."""
        return reservoir_scan(tuple(self.layers), self.activation, x, h0,
                              return_last_state, out_dtype=out_dtype,
                              with_state=with_state)

    def step(self, h: Sequence[jnp.ndarray], x_t: jnp.ndarray):
        """Single-step update (streaming / incremental encoding)."""
        return _reservoir_step(tuple(self.layers),
                               _ACTIVATIONS[self.activation], list(h), x_t)


def _reservoir_step(layers, act, h, x_t):
    new_h = []
    inp = x_t
    for i, p in enumerate(layers):
        pre = (jnp.dot(inp, p.w_ih.T, precision=_F32)
               + jnp.dot(h[i], p.w_hh.T, precision=_F32))
        if p.b_ih is not None:
            pre = pre + p.b_ih
        hi = (1.0 - p.alpha) * h[i] + p.alpha * act(pre)
        new_h.append(hi)
        inp = hi
    return new_h


# the schedule ``mode="auto"`` runs: chip_smoke.py times both at PV-US
# year scale (T=8868, L=8, H=16, N=5016); on an H100 (700 W) wavefront
# took 0.205 s and sequential 0.534 s — the sequential scan issues L
# small dependent matmul pairs per step, the wavefront one batched pair
AUTO_MODE = "wavefront"


@functools.partial(jax.jit,
                   static_argnames=("activation", "return_last_state",
                                    "out_dtype", "with_state", "mode"))
def reservoir_scan(layers, activation: str, x, h0=None,
                   return_last_state: bool = False, out_dtype=None,
                   with_state: bool = False, mode: str = "auto"):
    """``mode='wavefront'`` runs the layer-PIPELINED scan: layer ``i``
    processes time ``t`` at scan iteration ``t + i``, so all L layer
    updates of one iteration are independent and fuse into ONE batched
    GEMM pair (exactly the same recurrence — states stay ALIGNED at
    every call boundary via warm-up masking and L-1 flush iterations
    per chunk).

    ``auto`` picks ``sequential`` (see :data:`AUTO_MODE`)."""
    act = _ACTIVATIONS[activation]
    batch_shape = x.shape[1:-1]
    x2 = x.reshape(x.shape[0], -1, x.shape[-1])  # [T, B, F]
    if h0 is None:
        h0 = [jnp.zeros((x2.shape[1], p.w_hh.shape[0]), x.dtype)
              for p in layers]
    if mode == "auto":
        mode = AUTO_MODE

    if mode == "wavefront":
        out, last_h = _wavefront_scan(layers, act, x2, list(h0),
                                      out_dtype)
    else:
        def step(h, x_t):
            new_h = _reservoir_step(layers, act, h, x_t)
            out_t = jnp.concatenate(new_h, axis=-1)
            if out_dtype is not None:
                out_t = out_t.astype(out_dtype)
            return new_h, out_t

        last_h, out = jax.lax.scan(step, list(h0), x2)
    if return_last_state:
        return jnp.concatenate(last_h, -1).reshape(batch_shape + (-1,))
    out = out.reshape((x.shape[0],) + batch_shape + (out.shape[-1],))
    if with_state:
        return out, last_h
    return out


def _wavefront_scan(layers, act, x2, h0, out_dtype,
                    time_chunk: int = 256):
    """Layer-pipelined reservoir scan (see :func:`reservoir_scan`).

    Per scan iteration ``s`` (inside a time chunk starting at global
    time ``t0``): layer ``i`` computes its state for time
    ``t_i = t0 + s - i`` from its own carried state and the carry of
    layer ``i-1`` (which holds ``h_{i-1}(t_i)`` — updated last
    iteration). Updates are masked to ``t0 <= t_i < t0+TC`` so the
    carry is exactly the ALIGNED states ``h_i(chunk_end - 1)`` after
    each chunk's ``L-1`` flush iterations, and warm-up re-fills the
    pipeline from that aligned carry at the next chunk. Chunking keeps
    the skewed emission buffer ``O(TC * L * B * H)`` instead of
    ``O(T * ...)`` (a second full-output copy would double peak HBM at
    beyond-HBM scales)."""
    t_total, b, f = x2.shape
    l_n = len(layers)
    h = layers[0].w_hh.shape[0]
    p_dim = max(f, h)
    w_in = jnp.stack([
        jnp.pad(p.w_ih.T, ((0, p_dim - p.w_ih.shape[1]), (0, 0)))
        for p in layers])                         # [L, P, H]
    w_hh = jnp.stack([p.w_hh.T for p in layers])  # [L, H, H]
    bias = jnp.stack([p.b_ih if p.b_ih is not None
                      else jnp.zeros((h,), jnp.float32)
                      for p in layers])           # [L, H]
    alpha = jnp.asarray([p.alpha for p in layers],
                        jnp.float32)[:, None, None]
    i_idx = jnp.arange(l_n)

    # prefer a chunk length that DIVIDES t_total: then the chunked
    # output reshapes back to [T, ...] for free. A ragged tail would
    # force a [:t_total] slice of the padded result — a full COPY of
    # the (k+1)xH-wide output, which doubles peak HBM (measured
    # 12 GiB temp vs <2 at PV-US year scale) exactly where the
    # wavefront is meant to run.
    tc = _pick_time_chunk(t_total, time_chunk)
    n_ch = -(-t_total // tc)
    t_pad = n_ch * tc
    # pad TIME only here (major-dim reshape is free); the feature-lane
    # pad to p_dim happens per chunk inside the scan body — padding the
    # whole series up front materializes a (p_dim/F)x input copy
    # (measured 2.9 GB at PV-US year scale, enough to OOM the chip
    # next to the 10.6 GB output)
    xp = (x2 if t_pad == t_total else
          jnp.pad(x2, ((0, t_pad - t_total), (0, 0), (0, 0))))
    xc = xp.reshape(n_ch, tc, b, f)
    hc0 = jnp.stack(h0)                           # [L, B, H] aligned

    def chunk_body(carry, x_chunk):
        hc, t0 = carry
        x_chunk = jnp.pad(x_chunk, ((0, 0), (0, 0), (0, p_dim - f)))
        x_ext = jnp.concatenate(
            [x_chunk, jnp.zeros((l_n - 1, b, p_dim), x_chunk.dtype)], 0)

        def iter_body(inner, x_s):
            hcur, s = inner
            h_pad = jnp.pad(hcur[:-1], ((0, 0), (0, 0),
                                        (0, p_dim - h)))
            inp = jnp.concatenate([x_s[None], h_pad], 0)  # [L, B, P]
            pre = (jnp.einsum("lbp,lph->lbh", inp, w_in, precision=_F32)
                   + jnp.einsum("lbh,lhg->lbg", hcur, w_hh, precision=_F32)
                   + bias[:, None, :])
            upd = (1.0 - alpha) * hcur + alpha * act(pre)
            t_i = t0 + s - i_idx
            # the t_total bound keeps the PADDED tail of a ragged final
            # chunk from touching the carry (outputs past t_total are
            # sliced off, but the carried state must end at t_total-1)
            keep = ((t_i >= t0) & (t_i < t0 + tc)
                    & (t_i < t_total))[:, None, None]
            hn = jnp.where(keep, upd, hcur)
            emit = hn.astype(out_dtype) if out_dtype is not None else hn
            return (hn, s + 1), emit

        (hc, _), emitted = jax.lax.scan(iter_body, (hc, 0), x_ext)
        # emitted[j, i] holds h_i(t0 + j - i): chunk time r = t0 + r
        # for layer i sits at j = r + i — L static slices realign it
        aligned = jnp.concatenate(
            [emitted[i:i + tc, i] for i in range(l_n)], -1)
        return (hc, t0 + tc), aligned

    (hc, _), out = jax.lax.scan(chunk_body, (hc0, 0), xc)
    out = out.reshape(t_pad, b, l_n * h)
    if t_pad != t_total:
        out = out[:t_total]
    return out, [hc[i] for i in range(l_n)]


def _pick_time_chunk(t_total: int, target: int) -> int:
    """Largest-preference divisor of ``t_total`` near ``target`` (see
    :func:`_wavefront_scan`: an exact divisor avoids a full-output
    copy). Searches [target, target/4] then (target, 4*target]; falls
    back to ``min(target, t_total)`` (padded tail) when t_total has no
    divisor in range."""
    if t_total <= target:
        return t_total
    for d in range(target, max(target // 4, 1) - 1, -1):
        if t_total % d == 0:
            return d
    for d in range(target + 1, min(4 * target, t_total) + 1):
        if t_total % d == 0:
            return d
    return target
