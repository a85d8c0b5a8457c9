"""Node-sharded whole-series encoding + closed-form readout.

The multi-chip counterpart of ``sgp.encode`` (SURVEY.md §2.7,
§5.7 — the new capability the reference lacks): the series ``[T, N, F]``
is sharded over the NODE dimension, the reservoir scan runs on each
device's node block independently (it is node-local — XLA keeps the
sharding through the ``lax.scan``), and the K-hop spatial propagation
exchanges only boundary rows per hop (:mod:`sgp.parallel.halo`).
The encoding never exists in full on any one chip — an ``n_devices``×
larger DynGESN/SGP encoding fits than one device's memory allows.

The closed-form (DynGESN) readout shards the same way: per-device
Gram/moment sums over its node block's rows, one ``psum``, replicated
Cholesky (``experiments/run_closed_form.py:191-228`` semantics,
sklearn-style intercept).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from sgp.encode.spatial import prepare_propagation_graphs
from sgp.graph.sparse import Graph
from sgp.parallel.halo import build_halo_spec, halo_khop, shard_nodes


def encode_series_sharded(reservoir, x_series, graph: Graph, mesh: Mesh,
                          k: int = 2, axis: str = "data",
                          undirected: bool = False,
                          add_loops: bool = False,
                          bidirectional: bool = False,
                          global_attr: bool = False,
                          out_dtype=None,
                          halo_payload: str = "float32",
                          chips_per_host: int = None,
                          halo_depth: int = 1) -> jnp.ndarray:
    """SGP-encode ``x_series [T, N, F]`` with every stage node-sharded.

    Returns the embedding ``[T, N', D]`` (``N'`` = N padded to a
    multiple of the axis size; padded rows are zero), node-sharded over
    ``axis``, with the reference layout
    ``[h, Ah, ..., A^k h (, A'h, ..., A'^k h)(, mean(h))]``
    (``lib/sgp_preprocessing.py:163-218`` + global_attr support).
    Build decoder models with ``n_nodes = N'`` and mask padded nodes.

    ``halo_payload`` ('bfloat16'/'int8') compresses the boundary-row
    wire format; ``chips_per_host`` additionally builds the two-level
    (host, chip) exchange plan for meshes whose ``axis`` is the
    ``('host', 'chip')`` tuple; ``halo_depth`` exchanges a depth-d
    boundary once per d hops (one collective per direction when
    ``halo_depth=k`` — right for low-degree road graphs whose exchange
    is inter-host-latency-bound; see ``parallel/halo.py``).
    """
    if isinstance(axis, (tuple, list)):
        n_shards = int(np.prod([mesh.shape[a] for a in axis]))
    else:
        n_shards = mesh.shape[axis]
    n_true = graph.num_nodes
    xs = shard_nodes(jnp.asarray(x_series), mesh, axis, node_axis=1)
    h = reservoir(xs, out_dtype=out_dtype)        # [T, N', LH] sharded
    if h.shape[1] != n_true:
        # zero padded node rows (reservoir bias makes them nonzero,
        # which would pollute the global-mean support)
        node_ok = (jnp.arange(h.shape[1]) < n_true)[None, :, None]
        h = jnp.where(node_ok, h, jnp.zeros((), h.dtype))
    graphs = prepare_propagation_graphs(
        graph, undirected=undirected, add_loops=add_loops,
        bidirectional=bidirectional)
    spec_fwd = build_halo_spec(graphs[0], n_shards,
                               payload_dtype=halo_payload,
                               chips_per_host=chips_per_host,
                               depth=halo_depth)
    parts = [halo_khop(spec_fwd, h, mesh, k=k, axis=axis, concat=True)]
    if bidirectional:
        spec_bwd = build_halo_spec(graphs[1], n_shards,
                                   payload_dtype=halo_payload,
                                   chips_per_host=chips_per_host,
                                   depth=halo_depth)
        bwd = halo_khop(spec_bwd, h, mesh, k=k, axis=axis, concat=True)
        parts.append(bwd[..., h.shape[-1]:])      # drop the repeated h
    if global_attr:
        @jax.jit
        def gmean(hh):
            # padded rows are zero; divide by the TRUE node count
            m = hh.sum(-2, keepdims=True) / n_true
            return jnp.broadcast_to(m, hh.shape)
        parts.append(gmean(h))
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, -1)
    if out_dtype is not None:
        out = out.astype(out_dtype)
    # keep the result node-sharded in HBM
    ax = tuple(axis) if isinstance(axis, (tuple, list)) else axis
    return jax.lax.with_sharding_constraint(
        out, jax.sharding.NamedSharding(mesh, P(None, ax, None)))


def sharded_ridge_nodes(x, y, alpha: float, mesh: Mesh,
                        mask=None, axis: str = "data",
                        fit_intercept: bool = True):
    """Closed-form ridge over ALL (t, node) rows of node-sharded
    ``x [T, N, D]`` / ``y [T, N, C]``: per-device masked Gram/moment
    and mean sums, ``psum`` over ``axis``, replicated solve. Returns
    ``(W [D, C], b [C])`` matching
    :func:`sgp.train.ridge.ridge_regression` on the flattened rows.
    """
    from jax import shard_map

    from sgp.train.ridge import solve_ridge_normal

    x = jnp.asarray(x, jnp.float32)
    if mask is None:
        # padded node rows must not count: build an explicit row mask
        # BEFORE padding (shard_nodes pads it with False)
        mask = jnp.ones(x.shape[:2] + (1,), bool)
    x = shard_nodes(x, mesh, axis, node_axis=1)
    y = shard_nodes(jnp.asarray(y, jnp.float32), mesh, axis, node_axis=1)
    mask = shard_nodes(jnp.asarray(mask), mesh, axis, node_axis=1)
    node_spec = P(None, axis, None)

    def local(x, y, m):
        d, c = x.shape[-1], y.shape[-1]
        w = jnp.any(m, axis=-1).reshape(-1, 1).astype(jnp.float32)
        xf = x.reshape(-1, d) * w
        yf = y.reshape(-1, c) * w
        cnt = jax.lax.psum(w.sum(), axis)
        sx = jax.lax.psum(xf.sum(0), axis)
        sy = jax.lax.psum(yf.sum(0), axis)
        g = jax.lax.psum(
            jnp.einsum("nd,ne->de", xf, xf, precision="highest"), axis)
        mom = jax.lax.psum(
            jnp.einsum("nd,nc->dc", xf, yf, precision="highest"), axis)
        cnt = jnp.maximum(cnt, 1.0)
        if fit_intercept:
            x_mean, y_mean = sx / cnt, sy / cnt
            g = g - cnt * jnp.outer(x_mean, x_mean)
            mom = mom - cnt * jnp.outer(x_mean, y_mean)
        else:
            x_mean = jnp.zeros(d)
            y_mean = jnp.zeros(c)
        w_sol = solve_ridge_normal(g, mom, alpha)
        b = y_mean - x_mean @ w_sol if fit_intercept else jnp.zeros(c)
        return w_sol, b

    fn = shard_map(local, mesh=mesh,
                   in_specs=(node_spec, node_spec, node_spec),
                   out_specs=(P(None, None), P(None)),
                   check_vma=False)
    return fn(x, y, mask)
