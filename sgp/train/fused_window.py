"""Fused full-graph windowed training.

The windowed (traffic) counterpart of ``sgp/train/iid.py``: window
sampling, window/horizon gather from device-resident arrays, optional
support propagation, forward, masked loss, backward and Adam run as ONE
jitted program, with a multi-step ``lax.scan`` variant — removing the
per-batch host dispatch that bounds the loader-based path on a
high-latency device link.

Sampling semantics: items are drawn uniformly with replacement from the
training items (the reference shuffles without replacement; with
``batches_epoch``-limited epochs the two are statistically equivalent —
documented divergence).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data.scalers import ScalerParams
from sgp.train.iid import take_time_rows
from sgp.train.metrics import MaskedMetrics, _METRIC_FNS, _masked_reduce


def gather_steps(arr: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    """``arr[steps]`` for a 2-D step-index matrix ``[B, W]`` as
    slice-form time gathers (see ``train.iid.take_time_rows``).
    Returns ``[B, W, *arr.shape[1:]]``."""
    b, w = steps.shape
    rows = take_time_rows(arr, steps.reshape(-1))
    return rows.reshape((b, w) + arr.shape[1:])


def make_offset_gather(offsets):
    """Build ``g(arr, items) -> [B, W, ...]`` for a STATIC offset
    vector. Contiguous offsets (``arange``-like — every reference
    window/horizon with lag 1) gather all W rows in ONE dynamic slice
    per item instead of W separate row slices; anything else falls back
    to :func:`gather_steps`."""
    off = np.asarray(offsets)
    w = len(off)
    if w > 1 and np.all(np.diff(off) == 1):
        base = int(off[0])

        def g(arr, items):
            return jax.vmap(lambda i: jax.lax.dynamic_slice_in_dim(
                arr, i + base, w, axis=0))(items)
        return g
    off_j = jnp.asarray(off)

    def g(arr, items):
        return gather_steps(arr, items[:, None] + off_j[None, :])
    return g


def make_fused_window_step(model, optimizer,
                           x_full: jnp.ndarray,       # [T, N, Cin]
                           target: jnp.ndarray,       # [T, N, C]
                           mask: jnp.ndarray,         # [T, N, C]
                           item_starts: jnp.ndarray,  # [S]
                           window_offsets: jnp.ndarray,   # [W]
                           horizon_offsets: jnp.ndarray,  # [H]
                           scaler: ScalerParams,
                           u: Optional[jnp.ndarray] = None,  # [T, F]
                           support_ops: Optional[List] = None,
                           batch_size: int = 64,
                           loss: str = "mae",
                           scale_target: bool = False,
                           steps_per_call: int = 1) -> Callable:
    """Build ``step(params, opt_state, rng)``; with ``steps_per_call>1``
    the returned callable scans that many optimizer steps per dispatch."""
    loss_pt = _METRIC_FNS[loss]
    # the window/horizon offsets live only in the gw/gh closures (they
    # are static specialization inputs, not runtime data)
    data = (x_full, target, mask, item_starts) \
        + ((u,) if u is not None else ())
    has_u = u is not None
    gw = make_offset_gather(window_offsets)   # contiguous: 1 slice/item
    gh = make_offset_gather(horizon_offsets)

    def sample_and_loss(params, rng, data):
        xf, tgt, msk, starts = data[:4]
        rng_i, rng_d = jax.random.split(rng)
        items = jax.random.choice(rng_i, starts, (batch_size,))
        x = gw(xf, items)                    # [B, W, N, Cin]
        if support_ops is not None:
            parts = [x]
            for op in support_ops:
                parts.append(op @ x)
            x = jnp.concatenate(parts, -1)
        y = gh(tgt, items)
        m = gh(msk, items)
        kwargs = {}
        if has_u:
            kwargs["u"] = gw(data[4], items)  # [B, W, F]
        y_hat = model.apply(params, x, training=True,
                            rngs={"dropout": rng_d}, **kwargs)
        if scale_target:
            y_ref = scaler.transform(y)
        else:
            y_hat = scaler.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        return v / jnp.maximum(cnt, 1.0)

    @jax.jit
    def _single(params, opt_state, rng, data):
        loss_val, grads = jax.value_and_grad(sample_and_loss)(
            params, rng, data)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss_val

    if steps_per_call <= 1:
        def step(params, opt_state, rng):
            return _single(params, opt_state, rng, data)
        return step

    @jax.jit
    def _multi(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            loss_val, grads = jax.value_and_grad(sample_and_loss)(
                p, key, data)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s), loss_val
        keys = jax.random.split(rng, steps_per_call)
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    def step(params, opt_state, rng):
        return _multi(params, opt_state, rng, data)

    return step


def pad_eval_items(item_starts, batch_size: int):
    """Pad eval window starts to a multiple of ``batch_size`` and
    return ``(starts [n_batches, B], valid [n_batches, B])``; padded
    slots carry ``valid=False`` and drop out of every metric's mask.
    Shared by the single-device and node-sharded fused evals."""
    item_starts = np.asarray(item_starts)
    s = len(item_starts)
    n_batches = -(-s // batch_size)
    pad = n_batches * batch_size - s
    starts = np.concatenate(
        [item_starts, np.full(pad, item_starts[0] if s else 0,
                              item_starts.dtype)])
    valid = np.concatenate([np.ones(s, bool), np.zeros(pad, bool)])
    return (jnp.asarray(starts).reshape(n_batches, batch_size),
            jnp.asarray(valid).reshape(n_batches, batch_size))


def make_fused_eval(model, x_full, target, mask,
                    item_starts, window_offsets, horizon_offsets,
                    scaler: ScalerParams, metrics: MaskedMetrics,
                    u=None, support_ops=None, batch_size: int = 64,
                    apply_fn=None, x_slice: int = None):
    """Fused full-pass evaluation: window gather, forward,
    inverse-transform and masked metric accumulation over ALL eval items
    run as ONE jitted ``lax.scan`` over batches — one device dispatch
    per eval pass instead of one per batch (the reference's eval loop,
    ``tsl/predictors/base_predictor.py:267-303``, re-built so the
    host dispatches once).

    Items are padded to a multiple of ``batch_size``; padded slots carry
    ``valid=False`` and drop out of every metric's mask. Returns
    ``eval_fn(params) -> {metric: float}``.

    ``apply_fn(params, x, u) -> y_hat`` overrides the default
    ``model.apply(params, x, u=u, training=False)`` for models that need
    extra operands (graph operators etc.).
    """
    starts, valid = pad_eval_items(item_starts, batch_size)
    has_u = u is not None
    gw = make_offset_gather(window_offsets)
    gh = make_offset_gather(horizon_offsets)
    data = (x_full, target, mask, starts, valid) \
        + ((tuple(support_ops),) if support_ops is not None else ()) \
        + ((u,) if has_u else ())

    if apply_fn is None:
        def apply_fn(params, x, u):
            kwargs = {} if u is None else {"u": u}
            return model.apply(params, x, training=False, **kwargs)

    @jax.jit
    def _eval(params, data):
        xf, tgt, msk, starts, valid = data[:5]
        rest = data[5:]
        ops = rest[0] if support_ops is not None else None
        u_arr = rest[-1] if has_u else None

        def body(state, inp):
            items, ok = inp                       # [B], [B] bool
            x = gw(xf, items)                     # [B, W, N, C]
            if x_slice is not None:
                # x_full is a PACKED row layout (features first, then
                # target/mask lanes — train/iid.py::pack_iid_data):
                # evaluation reads only the feature lanes, so callers
                # can keep ONLY the packed array in HBM
                x = x[..., :x_slice]
            if ops is not None:
                parts = [x]
                for op in ops:
                    parts.append(op @ x)
                x = jnp.concatenate(parts, -1)
            y = gh(tgt, items)
            m = gh(msk, items) & ok[:, None, None, None]
            uu = None if u_arr is None else gw(u_arr, items)
            y_hat = apply_fn(params, x, uu)
            y_hat = scaler.inverse_transform(y_hat)
            return metrics.update(state, y_hat, y, m), None

        state, _ = jax.lax.scan(body, metrics.init(), (starts, valid))
        return state

    def eval_fn(params):
        state = jax.block_until_ready(_eval(params, data))
        return metrics.compute(state)

    eval_fn.core = _eval
    eval_fn.data = data
    eval_fn.metrics = metrics   # for stacked multi-trial evaluation
    return eval_fn
