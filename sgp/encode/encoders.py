"""Training-free encoder pipelines.

Counterparts of ``lib/nn/encoders/*`` with a uniform functional
interface: ``encoder(x [T, N, F], graph) -> [T, N, D]``.

- :class:`SGPEncoder` — reservoir over time, then K-hop propagation over
  space, optional global-mean channel (``sgp_encoder.py:45-51`` +
  ``sgp_spatial_encoder.py:22-35``).
- :class:`SGPTemporalEncoder` — reservoir only (ablation ``time``).
- :class:`SGPSpatialEncoder` — propagation only (ablation ``space``).
- :class:`GESNEncoder` — graph echo-state network
  (``dyn_gesn_encoder.py:34-44``: self-loops + row normalization).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sgp.encode.graph_reservoir import GraphESN
from sgp.encode.reservoir import Reservoir, reservoir_scan
from sgp.encode.spatial import (prepare_propagation_graphs,
                                sgp_spatial_embedding)
from sgp.graph.sparse import Graph, add_self_loops, normalize_adj
from sgp.ops.spmm import build_operator


class SGPSpatialEncoder:
    def __init__(self, receptive_field: int = 1, bidirectional: bool = False,
                 undirected: bool = False, global_attr: bool = False,
                 add_self_loops: bool = False,
                 operator_mode: str = "auto"):
        self.receptive_field = receptive_field
        self.bidirectional = bidirectional
        self.undirected = undirected
        self.global_attr = global_attr
        self.add_self_loops = add_self_loops
        self.operator_mode = operator_mode

    def output_size(self, input_size: int) -> int:
        order = 1 + (2 if self.bidirectional else 1) * self.receptive_field
        order += 1 if self.global_attr else 0
        return order * input_size

    def __call__(self, x: jnp.ndarray, graph: Graph) -> jnp.ndarray:
        out: List[jnp.ndarray] = sgp_spatial_embedding(
            x, graph, k=self.receptive_field,
            undirected=self.undirected,
            add_loops=self.add_self_loops,
            bidirectional=self.bidirectional,
            operator_mode=self.operator_mode)
        if self.global_attr:
            g = jnp.broadcast_to(x.mean(-2, keepdims=True), x.shape)
            out.append(g)
        return jnp.concatenate(out, axis=-1)


class SGPTemporalEncoder:
    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.7,
                 input_scaling: float = 1.0, alpha_decay: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0):
        self.reservoir = Reservoir(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed)

    @property
    def output_size(self) -> int:
        return self.reservoir.output_size

    def __call__(self, x: jnp.ndarray,
                 graph: Optional[Graph] = None) -> jnp.ndarray:
        return self.reservoir(x)


class SGPEncoder:
    """Reservoir -> K-hop spatial propagation (the full SGP encoder)."""

    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.7,
                 input_scaling: float = 1.0, receptive_field: int = 1,
                 bidirectional: bool = False, alpha_decay: bool = False,
                 global_attr: bool = False, add_self_loops: bool = False,
                 undirected: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0,
                 operator_mode: str = "auto"):
        self.reservoir = Reservoir(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed)
        self.spatial = SGPSpatialEncoder(
            receptive_field=receptive_field, bidirectional=bidirectional,
            undirected=undirected, global_attr=global_attr,
            add_self_loops=add_self_loops, operator_mode=operator_mode)

    @property
    def output_size(self) -> int:
        return self.spatial.output_size(self.reservoir.output_size)

    def __call__(self, x: jnp.ndarray, graph: Graph,
                 time_chunk: Optional[int] = None,
                 out_dtype=None,
                 to_host: bool = False) -> jnp.ndarray:
        """Encode ``x [T, N, F]``. ``time_chunk`` streams the spatial
        stage in chunks of steps so only one chunk's full-width (k+1)x
        expansion is live at a time; each chunk is cast to ``out_dtype``
        (e.g. bf16 to halve HBM) before concatenation. ``to_host`` moves
        chunks to host memory (for encodings larger than HBM — slow on
        a remote device link)."""
        h = self.reservoir(x)  # [T, N, L*H]
        cast = (lambda a: a) if out_dtype is None \
            else (lambda a: a.astype(out_dtype))
        if time_chunk is None:
            return cast(self.spatial(h, graph))
        outs = []
        for s in range(0, h.shape[0], time_chunk):
            chunk = cast(self.spatial(h[s:s + time_chunk], graph))
            outs.append(np.asarray(chunk) if to_host else chunk)
        if to_host:
            return np.concatenate(outs, axis=0)
        return jnp.concatenate(outs, axis=0)


@functools.partial(jax.jit, static_argnames=("activation", "k",
                                              "global_attr", "chunk",
                                              "out_dtype"))
def _streaming_encode(layers, ops, x, extra_lanes, *, activation: str,
                      k: int, global_attr: bool, chunk: int, out_dtype):
    """One XLA program: reservoir + K-hop propagation + optional lane
    concat, streamed over time chunks with the reservoir state carried
    between them — the full ``[T, N, L*H]`` f32 hidden history NEVER
    materializes. Each chunk is written in place into the preallocated
    ``[T, N, D]`` output (the loop carries it), and a ragged tail chunk
    is encoded after the loop, so peak memory is the output plus one
    chunk's expansion: no padded copy of the output is ever sliced
    (at the PV-US year, T=8868 has no divisor near 64, and that slice
    was a second 44.6 GiB buffer)."""
    t, n = x.shape[0], x.shape[1]
    chunk = min(chunk, t)
    n_full, tail = divmod(t, chunk)
    width = sum(p.w_hh.shape[0] for p in layers)
    d_out = width * (1 + len(ops) * k + int(global_attr)) \
        + (0 if extra_lanes is None else extra_lanes.shape[-1])
    h0 = [jnp.zeros((n, p.w_hh.shape[0]), x.dtype) for p in layers]

    def encode_chunk(h, xcb, lcb):
        hc, h_new = reservoir_scan(layers, activation, xcb, h,
                                   with_state=True)
        parts = [hc]
        for op in ops:          # fwd (+ bwd if bidirectional), each
            cur = hc            # propagating the ORIGINAL features
            for _ in range(k):  # (matches sgp_spatial_embedding order)
                cur = op @ cur
                parts.append(cur)
        if global_attr:
            parts.append(jnp.broadcast_to(
                hc.mean(-2, keepdims=True), hc.shape))
        feat = jnp.concatenate(parts, -1).astype(out_dtype)
        if lcb is not None:
            feat = jnp.concatenate([feat, lcb.astype(out_dtype)], -1)
        return h_new, feat

    def rows(arr, start, size):
        return None if arr is None else \
            jax.lax.dynamic_slice_in_dim(arr, start, size, axis=0)

    def body(i, carry):
        h, out = carry
        s = i * chunk
        h, feat = encode_chunk(h, rows(x, s, chunk),
                               rows(extra_lanes, s, chunk))
        return h, jax.lax.dynamic_update_slice_in_dim(out, feat, s, 0)

    h, out = jax.lax.fori_loop(
        0, n_full, body, (h0, jnp.zeros((t, n, d_out), out_dtype)))
    if tail:
        s = n_full * chunk
        _, feat = encode_chunk(h, x[s:], None if extra_lanes is None
                               else extra_lanes[s:])
        out = jax.lax.dynamic_update_slice_in_dim(out, feat, s, 0)
    return out


def build_streaming_ops(encoder: "SGPEncoder", graph: Graph,
                        precision: str = "highest") -> tuple:
    """Host-side operator prep for :func:`streaming_encode`, exposed so
    repeat callers build (and upload) the propagation operators ONCE —
    rebuilding a dense [N, N] operator per call costs ~100 MB of host
    work plus its device upload."""
    sp = encoder.spatial
    graphs = prepare_propagation_graphs(
        graph, undirected=sp.undirected, add_loops=sp.add_self_loops,
        bidirectional=sp.bidirectional)
    return tuple(build_operator(g, sp.operator_mode, precision=precision)
                 for g in graphs)


def streaming_encode(encoder: "SGPEncoder", x: jnp.ndarray, graph: Graph,
                     time_chunk: int = 64, out_dtype=jnp.bfloat16,
                     extra_lanes: Optional[jnp.ndarray] = None,
                     precision: str = "highest",
                     ops: Optional[tuple] = None) -> jnp.ndarray:
    """Memory-lean whole-series SGP encode as ONE fused XLA program.

    Equivalent to ``encoder(x, graph)`` (then a cast to ``out_dtype``)
    but streams time chunks through reservoir+propagation with the
    reservoir state carried between chunks, so peak device memory is
    the bf16 output plus a single chunk's (k+1)x f32 expansion. ``extra_lanes
    [T, N, E]`` are concatenated to each chunk (e.g. the packed IID
    target/mask lanes from :func:`sgp.train.iid.pack_iid_data` —
    the encode then emits the packed training layout directly and the
    unpacked encoding never exists). Reference capability:
    ``lib/utils.py:10-47`` whole-series precompute; this is the
    memory-lean variant."""
    sp = encoder.spatial
    if ops is None:
        ops = build_streaming_ops(encoder, graph, precision=precision)
    else:
        for op in ops:   # catch prebuilds that disagree with the call
            if op.num_nodes != graph.num_nodes:
                raise ValueError(
                    f"prebuilt operator is for {op.num_nodes} nodes, "
                    f"graph has {graph.num_nodes}")
            op_prec = getattr(op, "precision", None)
            if op_prec is not None and op_prec != precision:
                raise ValueError(
                    f"prebuilt operator precision {op_prec!r} != "
                    f"requested {precision!r}; rebuild with "
                    f"build_streaming_ops(..., precision={precision!r})")
    return _streaming_encode(
        tuple(encoder.reservoir.layers), ops, x, extra_lanes,
        activation=encoder.reservoir.activation, k=sp.receptive_field,
        global_attr=sp.global_attr, chunk=int(time_chunk),
        out_dtype=np.dtype(out_dtype))


class GESNEncoder:
    """DynGESN: self-loops + row-normalized operator + GraphESN scan."""

    def __init__(self, input_size: int, reservoir_size: int = 32,
                 reservoir_layers: int = 1, leaking_rate: float = 0.9,
                 spectral_radius: float = 0.9, density: float = 0.9,
                 input_scaling: float = 1.0, alpha_decay: bool = False,
                 reservoir_activation: str = "tanh", seed: int = 0,
                 operator_mode: str = "auto"):
        self.gesn = GraphESN(
            input_size=input_size, hidden_size=reservoir_size,
            input_scaling=input_scaling, num_layers=reservoir_layers,
            leaking_rate=leaking_rate, spectral_radius=spectral_radius,
            density=density, activation=reservoir_activation,
            alpha_decay=alpha_decay, seed=seed)
        self.operator_mode = operator_mode

    @property
    def output_size(self) -> int:
        return self.gesn.output_size

    def __call__(self, x: jnp.ndarray, graph: Graph,
                 out_dtype=None) -> jnp.ndarray:
        g = normalize_adj(add_self_loops(graph), "row")
        op = build_operator(g, self.operator_mode)
        return self.gesn(x, op, out_dtype=out_dtype)


def get_encoder_class(name: str):
    """Encoder registry (``run_traffic_sgp.py:63-74``)."""
    return {"sgp": SGPEncoder, "time": SGPTemporalEncoder,
            "space": SGPSpatialEncoder, "gesn": GESNEncoder}[name]
