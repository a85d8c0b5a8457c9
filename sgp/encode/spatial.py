"""K-hop graph-shift-operator spatial embedding.

The spatial half of the SGP encoder (``lib/sgp_preprocessing.py:108-218``):
``res = [x, Ax, A^2 x, ..., A^k x]`` with a row- (or GCN-) normalized
propagation operator, optionally repeated on the transposed operator
(bidirectional) — each hop is one dense matmul or block-sparse SpMM over
the node axis (``sgp.ops``), applied to the whole series at once.

Host-side graph preparation (dropout, symmetrization, normalization) is
split from device-side propagation so the prepared operators can be
reused across calls and sharded across chips.
"""
from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from sgp.graph.sparse import (Graph, add_self_loops, edge_dropout,
                              normalize_adj, remove_self_loops,
                              spgemm, to_undirected, transpose)
from sgp.ops.spmm import Operator, build_operator


def _prepare_adj(g: Graph, gcn_norm: bool, set_diag: bool,
                 remove_diag: bool) -> Graph:
    """``preprocess_adj`` (``lib/sgp_preprocessing.py:67-105``): diagonal
    handling then row (D^-1 A) or sym (D^-1/2 A D^-1/2) normalization."""
    if set_diag:
        g = add_self_loops(g)
    elif remove_diag:
        g = remove_self_loops(g)
    return normalize_adj(g, "sym" if gcn_norm else "row")


def prepare_propagation_graphs(g: Graph,
                               undirected: bool = False,
                               add_loops: bool = False,
                               remove_loops: bool = False,
                               bidirectional: bool = False,
                               dropout_rate: float = 0.0,
                               rng: Optional[np.random.Generator] = None
                               ) -> List[Graph]:
    """Host-side graph prep for ``sgp_spatial_embedding``: returns the
    normalized forward operator and, if bidirectional, the normalized
    transposed operator (``sgp_preprocessing.py:163-218`` control flow:
    dropout -> to_undirected -> normalize; the backward pass re-prepares
    from the *dropped-out, untransformed* edges, transposed)."""
    if dropout_rate > 0:
        g = edge_dropout(g, dropout_rate, rng or np.random.default_rng())
    graphs = []
    if undirected:
        assert not bidirectional
        gu = to_undirected(g)
        graphs.append(_prepare_adj(gu, gcn_norm=True, set_diag=add_loops,
                                   remove_diag=remove_loops))
    else:
        graphs.append(_prepare_adj(g, gcn_norm=False, set_diag=add_loops,
                                   remove_diag=remove_loops))
    if bidirectional:
        graphs.append(_prepare_adj(transpose(g), gcn_norm=False,
                                   set_diag=add_loops,
                                   remove_diag=remove_loops))
    return graphs


def propagate_khop(op: Operator, x: jnp.ndarray, k: int,
                   include_input: bool = True) -> List[jnp.ndarray]:
    """``res = [x]; for _ in range(k): x = A @ x; res.append(x)``
    (``sgp_preprocessing.py:200-203``)."""
    res = [x] if include_input else []
    for _ in range(k):
        x = op @ x
        res.append(x)
    return res


def sgp_spatial_embedding(x: jnp.ndarray,
                          graph: Graph,
                          k: int = 2,
                          undirected: bool = False,
                          add_loops: bool = False,
                          remove_loops: bool = False,
                          bidirectional: bool = False,
                          one_hot_encoding: bool = False,
                          dropout_rate: float = 0.0,
                          rng: Optional[np.random.Generator] = None,
                          operator_mode: str = "auto",
                          precision: str = "highest") -> List[jnp.ndarray]:
    """Full spatial embedding on ``x [..., N, F]``; returns the list
    ``[x, Ax, ..., A^k x (, A'x, ..., A'^k x)]`` exactly as the reference
    (``lib/sgp_preprocessing.py:163-218``)."""
    graphs = prepare_propagation_graphs(
        graph, undirected=undirected, add_loops=add_loops,
        remove_loops=remove_loops, bidirectional=bidirectional,
        dropout_rate=dropout_rate, rng=rng)
    if one_hot_encoding:
        n = graph.num_nodes
        ids = jnp.eye(n, dtype=x.dtype)
        ids = jnp.broadcast_to(ids, x.shape[:-1] + (n,))
        x = jnp.concatenate([x, ids], axis=-1)
    fwd_op = build_operator(graphs[0], operator_mode, precision=precision)
    res = propagate_khop(fwd_op, x, k, include_input=True)
    if bidirectional:
        bwd_op = build_operator(graphs[1], operator_mode,
                                precision=precision)
        res += propagate_khop(bwd_op, res[0], k, include_input=False)
    return res


def sgp_spatial_support(g: Graph, k: int = 2,
                        undirected: bool = False,
                        add_loops: bool = False,
                        remove_loops: bool = False,
                        bidirectional: bool = False,
                        global_attr: bool = False,
                        true_powers: bool = True) -> List[Graph]:
    """Materialize the operator list ``[A, A^2, ..., A^k]`` for
    loader-side propagation (``lib/sgp_preprocessing.py:108-160``).

    The reference appends ``A @ A`` (k-1) times instead of successive
    powers (``:144-145``) — a quirk; ``true_powers=True`` (default)
    builds the mathematically-intended ``A^2, A^3, ...`` and
    ``true_powers=False`` reproduces the quirk bit-for-bit
    (SURVEY.md §7.4 divergence note).

    Documented divergence: the reference's ``bidirectional`` recursion
    passes the already-built SparseTensor, whose code path skips the
    transpose (``:117-123`` vs ``:147-154``) — so its "backward" support
    duplicates the forward direction. Here the backward support is the
    actual transpose, matching ``sgp_spatial_embedding``'s behavior (the
    path every published config exercises).
    """
    if undirected:
        g = to_undirected(g)
    if add_loops:
        g = add_self_loops(g)
    elif remove_loops:
        g = remove_self_loops(g)
    adj0 = normalize_adj(g, "sym" if undirected else "row")
    support = [adj0]
    power = adj0
    for _ in range(k - 1):
        if true_powers:
            power = spgemm(power, adj0)
            support.append(power)
        else:
            support.append(spgemm(adj0, adj0))
    if bidirectional:
        support += sgp_spatial_support(transpose(g), k=k,
                                       true_powers=true_powers)
    if global_attr:
        n = g.num_nodes
        dense = np.full((n, n), 1.0 / n, np.float32)
        support.append(Graph.from_dense(dense))
    return support
