"""Online low-latency serving for SGP forecasters.

Production counterpart of the reference's online model
(``lib/nn/models/sgp_model.py:126-194`` SGPOnlineModel, which computes
the spatial embedding inside the forward): a STATEFUL forecaster that
carries the echo-state reservoir across time, so serving a new
observation is ONE jitted dispatch — reservoir state update + K-hop
propagation + decoder forecast fused into a single XLA program.

The online feature assembly is bit-identical to the offline
``SGPEncoder`` precompute (asserted in ``tests/test_serve.py``), so a
decoder trained offline serves online without any re-training or
feature drift.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sgp.data.scalers import ScalerParams
from sgp.encode.encoders import SGPEncoder, build_streaming_ops
from sgp.graph import Graph


class OnlineForecaster:
    """Stateful one-dispatch-per-step forecaster.

    Args:
        encoder: the (training-free) :class:`SGPEncoder` used offline.
        graph: the sensor graph (operators prebuilt once, on device).
        model: the trained decoder (e.g. :class:`SGPModel`); applied in
            full-graph mode on the assembled ``[1, N, D]`` features.
        params: trained decoder params.
        scaler: the dataset scaler — raw observations are transformed
            on device and forecasts inverse-transformed, so callers
            feed/receive RAW values.
        precision: matmul precision for the K-hop propagation; use the
            value the offline encode ran with.
        store_dtype: dtype the offline encoding was STORED in (e.g.
            ``"bfloat16"``, the runners' default) — online features are
            cast to it before the decoder, so a decoder trained on bf16
            features sees the same rounding online. ``None`` keeps f32.
        n_streams: serve ``S`` independent streams (tenants/replicas)
            in the SAME dispatch: states stack on a leading stream axis
            and ``step`` takes/returns ``[S, N, C]`` / ``[S, H, N, C]``.
            The graph/decoder weights are shared; throughput scales
            with ``S`` while latency stays one dispatch.
    """

    def __init__(self, encoder: SGPEncoder, graph: Graph, model, params,
                 scaler: ScalerParams, precision: str = "highest",
                 store_dtype=None, n_streams: int = None):
        self.encoder = encoder
        self.model = model
        self.params = params
        self.scaler = scaler
        self._res = encoder.reservoir
        self._ops = build_streaming_ops(encoder, graph,
                                        precision=precision)
        self._k = encoder.spatial.receptive_field
        self._global_attr = encoder.spatial.global_attr
        n = graph.num_nodes
        self.n_streams = n_streams
        lead = () if n_streams is None else (n_streams,)
        self.state = [jnp.zeros(lead + (n, p.w_hh.shape[0]), jnp.float32)
                      for p in self._res.layers]

        res, k, gattr = self._res, self._k, self._global_attr

        @jax.jit
        def _step(params, h, x_raw, ops, u_t):
            # scaler params carry [1, 1, C]-style broadcast dims; keep
            # the single observation's [N, C] rank
            x_t = scaler.transform(x_raw).reshape(x_raw.shape)
            h_new = res.step(h, x_t)
            hc = jnp.concatenate(h_new, -1)        # [N, L*H]
            parts = [hc]
            for op in ops:       # same assembly/order as the offline
                cur = hc         # SGPEncoder / _streaming_encode
                for _ in range(k):
                    cur = op @ cur
                    parts.append(cur)
            if gattr:
                parts.append(jnp.broadcast_to(
                    hc.mean(-2, keepdims=True), hc.shape))
            feat = jnp.concatenate(parts, -1)      # [N, D]
            if store_dtype is not None:  # match the offline stored
                feat = feat.astype(store_dtype)    # feature rounding
            # single stream: [N, D] -> batch of 1; multi-stream:
            # [S, N, D] IS the full-graph batch layout [b n f]
            x_in = feat[None] if feat.ndim == 2 else feat
            kwargs = {} if u_t is None else {
                "u": u_t[None, None] if feat.ndim == 2
                else u_t[:, None]}                 # [S, 1, F]
            y = model.apply(params, x_in, training=False,
                            **kwargs)              # [b, H, N, C]
            y = scaler.inverse_transform(y)
            return h_new, (y[0] if feat.ndim == 2 else y)

        self._step = _step

    def step(self, x_raw, u_t: Optional[jnp.ndarray] = None):
        """Ingest one RAW observation ``[N, C]`` (``[S, N, C]`` with
        ``n_streams``) plus optional global exogenous ``[F]``
        (``[S, F]``); returns the forecast ``[H, N, C]``
        (``[S, H, N, C]``) in raw units. One device dispatch."""
        self.state, y = self._step(self.params, self.state,
                                   jnp.asarray(x_raw), self._ops, u_t)
        return y

    def reset(self):
        """Zero the reservoir state (new stream / washout restart)."""
        self.state = jax.tree.map(jnp.zeros_like, self.state)

    def warm_up(self, x_history):
        """Replay a RAW history ``[T, N, C]`` (``[T, S, N, C]`` with
        ``n_streams``) through the full scan (one dispatch, not T) to
        condition the RESERVOIR STATE before live serving (exogenous
        inputs only affect the decoder, not the state, so none are
        needed here)."""
        x_history = jnp.asarray(x_history)
        x = self.scaler.transform(x_history).reshape(x_history.shape)
        # the reservoir scan flattens all batch axes: states go through
        # as [S*N, H] and come back reshaped
        h0 = [h.reshape(-1, h.shape[-1]) for h in self.state]
        _, h = self._res(x, h0=h0, with_state=True)
        self.state = [hn.reshape(hs.shape)
                      for hn, hs in zip(h, self.state)]


def export_forecaster(fc: "OnlineForecaster", path: str,
                      example_u=None) -> int:
    """Serialize the forecaster's fused step as a deployable artifact.

    Uses ``jax.export`` (StableHLO): the decoder params, propagation
    operators and scaler are EMBEDDED as constants, so the artifact is
    fully self-contained — serving needs no Python model/encoder code,
    only :func:`load_forecaster`. Signature: ``(state, x_raw) ->
    (state', forecast)`` — or ``(state, x_raw, u_t) -> ...`` when
    ``example_u`` is given — with the reservoir state managed by the
    caller/wrapper. Works for multi-stream (``n_streams``) forecasters
    (the exported input keeps the ``[S, N, C]`` layout) and for
    :class:`OnlineGESNForecaster` (the DynGESN closed-form path).
    Returns the artifact size in bytes.

    Args:
        example_u: an exogenous input of the shape live ``step`` calls
            will pass (``[F]``, or ``[S, F]`` with ``n_streams``) —
            REQUIRED when the decoder was trained with exogenous
            features (its values are ignored; only the shape is traced).

    Note: ``jax.export`` artifacts are platform-scoped — export on the
    platform you will serve on (a CUDA artifact for GPU serving).
    """
    import os
    import pickle

    from jax import export

    if isinstance(fc, OnlineGESNForecaster):
        if example_u is not None:
            raise ValueError("the DynGESN serving path takes no "
                             "exogenous input")
        op, w, b = fc._op, fc._w, fc._b
        step = jax.jit(lambda h, x: fc._step_fn(h, x, op, w, b))
        f_in = fc._gesn.layers[0].w_ih.shape[1]
        u_shape = None
    else:
        params, ops = fc.params, fc._ops
        f_in = fc._res.layers[0].w_ih.shape[1]
        if getattr(fc.model, "exog_size", 0) and example_u is None:
            raise ValueError(
                "the decoder was built with exog_size="
                f"{fc.model.exog_size} — pass example_u (shape of the "
                "live u_t) so the artifact's signature includes it")
        if example_u is None:
            step = jax.jit(
                lambda h, x: fc._step(params, h, x, ops, None))
            u_shape = None
        else:
            u_shape = tuple(jnp.asarray(example_u).shape)
            step = jax.jit(
                lambda h, x, u: fc._step(params, h, x, ops, u))

    # state is [N, H] per layer (or [S, N, H] multi-stream); the raw
    # observation has the same leading axes with C = f_in channels
    x_shape = tuple(fc.state[0].shape[:-1]) + (f_in,)
    args = (fc.state, jnp.zeros(x_shape, jnp.float32)) + (
        () if u_shape is None else (jnp.zeros(u_shape, jnp.float32),))
    exported = export.export(step)(*args)
    blob = {
        "artifact": exported.serialize(),
        "state_shapes": [tuple(h.shape) for h in fc.state],
        "input_shape": x_shape,
        "u_shape": u_shape,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        pickle.dump(blob, fp)
    os.replace(tmp, path)
    return len(blob["artifact"])


class ExportedForecaster:
    """Runtime wrapper around a :func:`export_forecaster` artifact:
    same ``step``/``reset`` surface as :class:`OnlineForecaster`, no
    model/encoder code needed."""

    def __init__(self, exported, state_shapes, input_shape,
                 u_shape=None):
        self._exported = exported
        self._state_shapes = state_shapes
        self.input_shape = input_shape
        self.u_shape = u_shape
        self.reset()

    def step(self, x_raw, u_t=None):
        if (u_t is None) != (self.u_shape is None):
            raise ValueError(
                "artifact exported "
                + ("WITH" if self.u_shape is not None else "WITHOUT")
                + f" exogenous input (u_shape={self.u_shape}); step() "
                + "must match")
        args = (self.state, jnp.asarray(x_raw))
        if u_t is not None:
            args += (jnp.asarray(u_t),)
        self.state, y = self._exported.call(*args)
        return y

    def reset(self):
        self.state = [jnp.zeros(s, jnp.float32)
                      for s in self._state_shapes]


def load_forecaster(path: str) -> ExportedForecaster:
    """Load an artifact written by :func:`export_forecaster`."""
    import pickle

    from jax import export

    with open(path, "rb") as fp:
        blob = pickle.load(fp)
    return ExportedForecaster(export.deserialize(blob["artifact"]),
                              blob["state_shapes"], blob["input_shape"],
                              blob.get("u_shape"))


class OnlineGESNForecaster:
    """Online DynGESN serving: graph echo-state update + per-lag
    closed-form ridge readouts, one dispatch per observation.

    Counterpart of the reference's closed-form path
    (``experiments/run_closed_form.py:158-196``) served online: the
    GESN state ``h'`` = (1-a) h + a act(W_ih x + A (h W_hh^T)) carries
    across time; every new RAW observation yields all horizon-lag
    forecasts via ONE stacked einsum over the fitted readouts.

    ``readouts``: sequence of per-lag ``(W [D, C], b [C])`` as returned
    by ``train.ridge.closed_form_readout`` (one entry per horizon lag).
    ``n_streams``: as in :class:`OnlineForecaster` — serve ``S``
    independent streams per dispatch (``step`` takes/returns
    ``[S, N, C]`` / ``[S, L, N, C]``).
    """

    def __init__(self, encoder, graph: Graph, readouts,
                 scaler: ScalerParams, n_streams: int = None):
        from sgp.graph import add_self_loops, normalize_adj
        from sgp.ops import build_operator

        self.scaler = scaler
        self._gesn = encoder.gesn
        g = normalize_adj(add_self_loops(graph), "row")
        self._op = build_operator(g, encoder.operator_mode)
        w = jnp.stack([jnp.asarray(wl) for wl, _ in readouts])  # [L,D,C]
        b = jnp.stack([jnp.asarray(bl) for _, bl in readouts])  # [L,C]
        gesn = self._gesn
        n = graph.num_nodes
        self.n_streams = n_streams
        lead = () if n_streams is None else (n_streams,)
        self.state = [jnp.zeros(lead + (n, p.w_hh.shape[0]), jnp.float32)
                      for p in gesn.layers]

        @jax.jit
        def _step(h, x_raw, op, w, b):
            x_t = scaler.transform(x_raw).reshape(x_raw.shape)
            h_new = gesn.step(h, op, x_t)    # cell broadcasts [S, N, H]
            hc = jnp.concatenate(h_new, -1)          # [(S,) N, D]
            # lag readouts; b [L, C] -> [L, 1, C] broadcasts over nodes
            y = jnp.einsum("...nd,ldc->...lnc", hc, w) + b[:, None]
            return h_new, scaler.inverse_transform(y)

        self._step_fn = _step
        self._w, self._b = w, b

    def step(self, x_raw):
        """One RAW observation ``[N, C]`` (``[S, N, C]`` with
        ``n_streams``) -> all-lag forecasts ``[L, N, C]``
        (``[S, L, N, C]``) in raw units. One device dispatch."""
        self.state, y = self._step_fn(self.state, jnp.asarray(x_raw),
                                      self._op, self._w, self._b)
        return y

    def reset(self):
        self.state = jax.tree.map(jnp.zeros_like, self.state)

    def warm_up(self, x_history):
        """Condition the GESN state on a RAW history in one dispatch."""
        x = self.scaler.transform(jnp.asarray(x_history))
        _, h = self._gesn(x, self._op, h0=self.state, with_state=True)
        self.state = h
