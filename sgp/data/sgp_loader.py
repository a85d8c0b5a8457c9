"""Loader-side SGP propagation (the ``sgp_preprocessing=True`` path).

Counterpart of ``lib/dataloader/sgp_dataloader.py:10-71`` (SGPLoader,
collate-time propagation with materialized support operators) and the
support-attached ``IIDDataset`` path (``lib/datasets/iid_dataset.py:
30-44, 101-118``): instead of precomputing the K-hop embedding over the
whole series, the operator list ``[A, A^2, ..., (A'^k), (1/N)]`` is
materialized once (``sgp_spatial_support``) and applied to each batch's
inputs at load time — on device, as a vectorized operator stack.

Re-design: where the reference's DataLoader workers do
row-sliced torch_sparse SpMMs per sample, here the whole batch's
propagation is one jitted multi-operator matmul; for node-sampled
batches the row-sliced gather-SpMM uses the node subset on the
destination side only (``adj[nodes, :] @ x``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sgp.data.loader import IIDLoader, WindowedLoader
from sgp.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp.encode.spatial import sgp_spatial_support
from sgp.graph.sparse import Graph
from sgp.ops.spmm import Operator, build_operator


def build_support_operators(g: Graph, k: int = 2,
                            undirected: bool = False,
                            add_loops: bool = False,
                            bidirectional: bool = False,
                            global_attr: bool = False,
                            operator_mode: str = "auto",
                            true_powers: bool = True) -> List[Operator]:
    graphs = sgp_spatial_support(
        g, k=k, undirected=undirected, add_loops=add_loops,
        bidirectional=bidirectional, global_attr=global_attr,
        true_powers=true_powers)
    return [build_operator(sg, operator_mode) for sg in graphs]


def apply_support(x: jnp.ndarray, operators: List[Operator],
                  node_index: Optional[np.ndarray] = None) -> jnp.ndarray:
    """``cat([x] + [A_i @ x])`` along channels
    (``sgp_dataloader.py:56-60``). With ``node_index`` the output rows
    are sliced to the sampled nodes after each full-width product —
    the row-sliced SpMM of ``iid_dataset.py:111-114``."""
    parts = [x if node_index is None
             else jnp.take(x, node_index, axis=-2)]
    for op in operators:
        prop = op @ x
        if node_index is not None:
            prop = jnp.take(prop, node_index, axis=-2)
        parts.append(prop)
    return jnp.concatenate(parts, axis=-1)


class SGPLoader(WindowedLoader):
    """Windowed loader that propagates every node-keyed input at batch
    time (``sgp_dataloader.py:43-68``)."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 operators: List[Operator], **kwargs):
        super().__init__(dataset, **kwargs)
        self.operators = operators
        # operators passed as jit ARGS, not closure captures — closed-over
        # device arrays become jaxpr constants (XLA constant folding
        # stalls on large dense supports)
        self._apply = jax.jit(apply_support)

    def __iter__(self) -> Iterator[Batch]:
        for batch in super().__iter__():
            batch["x"] = self._apply(jnp.asarray(batch["x"]),
                                     self.operators)
            yield batch


class SGPIIDLoader(IIDLoader):
    """IID (time, node) loader with fetch-time propagation: window
    inputs of the sampled pairs are ``[x[nodes], (A_i @ x)[nodes]]``
    (``iid_dataset.py:101-118``)."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 operators: List[Operator], **kwargs):
        super().__init__(dataset, **kwargs)
        self.operators = operators

    def __iter__(self) -> Iterator[Batch]:
        x_full = jnp.asarray(self.dataset.input_array())
        for _ in range(self.num_batches):
            t = self._rng.choice(self.valid_starts, self.batch_size)
            n = self._rng.integers(0, self.dataset.n_nodes,
                                   self.batch_size)
            batch = self.dataset.gather_iid_batch(t, n)
            # propagate at the sampled window steps, slice sampled nodes
            steps = jnp.asarray(
                t[:, None] + self.dataset.windowing.window_offsets())
            xw = x_full[steps]                  # [B, W, N, C]
            parts = [jnp.take_along_axis(
                xw, jnp.asarray(n)[:, None, None, None], axis=2)]
            for op in self.operators:
                prop = op @ xw
                parts.append(jnp.take_along_axis(
                    prop, jnp.asarray(n)[:, None, None, None], axis=2))
            batch["x"] = jnp.concatenate(parts, -1)[:, :, 0, :]
            yield batch
