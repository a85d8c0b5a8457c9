"""Subgraph / node-subset sampling for training GNN baselines on large
graphs (the reference's memory-capacity strategy, ``lib/dataloader/
subgraph_dataloader.py:13-198``).

- :class:`SubsetLoader` — random node subset per batch, edges dropped.
- :class:`SubgraphLoader` — sample roots, expand the k-hop in-neighborhood
  (``k_hop_subgraph`` with ``flow='target_to_source'``), optionally cap
  edges uniformly or inverse-in-degree-weighted; loss is computed on the
  roots only (``target_nodes``).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from sgp.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp.graph.sparse import Graph, k_hop_subgraph, weighted_degree


def cap_edges(g: Graph, max_edges: int, rng: np.random.Generator,
              uniform: bool = True) -> Graph:
    """Edge subsampling (``subgraph_dataloader.py:172-194``): keep at
    most ``max_edges``, uniformly or with p ∝ 1/in-degree."""
    if g.num_edges <= max_edges:
        return g
    if uniform:
        keep = rng.choice(g.num_edges, max_edges, replace=False)
    else:
        deg = weighted_degree(g.with_weight(
            np.ones(g.num_edges, np.float32)), "in")
        p = 1.0 / np.maximum(deg[g.dst], 1.0)
        p = p / p.sum()
        keep = rng.choice(g.num_edges, max_edges, replace=False, p=p)
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


class SubsetLoader:
    """Random node-subset batches (``subgraph_dataloader.py:53-119``):
    every node tensor sliced to the subset; no edges."""

    def __init__(self, dataset: SpatioTemporalDataset,
                 items: Optional[np.ndarray] = None,
                 batch_size: int = 4, num_nodes: int = 1024,
                 shuffle: bool = True, seed: int = 0,
                 limit_batches: Optional[int] = None):
        self.dataset = dataset
        self.items = (np.arange(len(dataset)) if items is None
                      else np.asarray(items))
        self.batch_size = batch_size
        self.num_nodes = min(num_nodes, dataset.n_nodes)
        self.shuffle = shuffle
        self.limit_batches = limit_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = -(-len(self.items) // self.batch_size)
        return min(n, self.limit_batches) if self.limit_batches else n

    def __iter__(self) -> Iterator[Batch]:
        order = self._rng.permutation(self.items) if self.shuffle \
            else self.items
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if not len(sel):
                return
            nodes = self._rng.permutation(
                self.dataset.n_nodes)[:self.num_nodes]
            batch = self.dataset.gather_batch(sel, node_index=nodes)
            batch["target_nodes"] = np.arange(len(nodes))
            yield batch


class SubgraphLoader:
    """K-hop-subgraph batches (``subgraph_dataloader.py:122-198``):
    sample ``num_roots`` root nodes, expand their k-hop in-neighborhood,
    slice node tensors to the subgraph, attach the relabeled subgraph
    (optionally edge-capped) and the root positions for root-only loss
    (``lib/predictors/subgraph_predictor.py:14-15``).

    Divergence by design: subgraphs are emitted with *static*
    shapes — nodes capped/padded to ``pad_nodes`` and edges to
    ``max_edges`` (zero-weight padding) — otherwise every batch would
    trigger an XLA recompile. The padded graph is shipped as flat
    ``sub_src``/``sub_dst``/``sub_weight`` arrays so the whole batch
    passes through jit; build an operator from them device-side.
    """

    def __init__(self, dataset: SpatioTemporalDataset,
                 items: Optional[np.ndarray] = None,
                 batch_size: int = 4, num_roots: int = 512, k: int = 2,
                 max_edges: Optional[int] = None,
                 cut_edges_uniformly: bool = True,
                 pad_nodes: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 limit_batches: Optional[int] = None):
        assert dataset.graph is not None
        self.dataset = dataset
        self.items = (np.arange(len(dataset)) if items is None
                      else np.asarray(items))
        self.batch_size = batch_size
        self.num_roots = min(num_roots, dataset.n_nodes)
        self.k = k
        self.max_edges = max_edges or dataset.graph.num_edges
        self.cut_edges_uniformly = cut_edges_uniformly
        self.pad_nodes = min(pad_nodes or dataset.n_nodes,
                             dataset.n_nodes)
        self.shuffle = shuffle
        self.limit_batches = limit_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = -(-len(self.items) // self.batch_size)
        return min(n, self.limit_batches) if self.limit_batches else n

    def _sample_subgraph(self):
        g = self.dataset.graph
        roots = self._rng.permutation(
            self.dataset.n_nodes)[:self.num_roots]
        nodes, sub, root_pos = k_hop_subgraph(
            g, roots, self.k, flow="target_to_source")
        if len(nodes) > self.pad_nodes:
            # keep all roots + a random subset of the expansion
            is_root = np.zeros(len(nodes), bool)
            is_root[root_pos] = True
            others = np.nonzero(~is_root)[0]
            keep_local = np.concatenate([
                root_pos,
                self._rng.permutation(others)[
                    :self.pad_nodes - len(root_pos)]])
            keep_local.sort()
            nodes = nodes[keep_local]
            relabel = np.full(sub.num_nodes, -1, np.int64)
            relabel[keep_local] = np.arange(len(keep_local))
            e_keep = (relabel[sub.src] >= 0) & (relabel[sub.dst] >= 0)
            sub = Graph(relabel[sub.src[e_keep]],
                        relabel[sub.dst[e_keep]],
                        sub.weight[e_keep], len(nodes))
            # keep_local is sorted and contains every root position
            root_pos = np.searchsorted(keep_local, np.sort(root_pos))
        if sub.num_edges > self.max_edges:
            sub = cap_edges(sub, self.max_edges, self._rng,
                            self.cut_edges_uniformly)
        return nodes, sub, root_pos

    def _pad(self, nodes, sub, root_pos):
        """Pad node list and edge arrays to static shapes."""
        n_pad, e_pad = self.pad_nodes, self.max_edges
        nodes_p = np.zeros(n_pad, np.int64)
        nodes_p[:len(nodes)] = nodes
        src = np.zeros(e_pad, np.int32)
        dst = np.zeros(e_pad, np.int32)
        w = np.zeros(e_pad, np.float32)
        src[:sub.num_edges] = sub.src
        dst[:sub.num_edges] = sub.dst
        w[:sub.num_edges] = sub.weight
        return nodes_p, src, dst, w, len(nodes)

    def __iter__(self) -> Iterator[Batch]:
        order = self._rng.permutation(self.items) if self.shuffle \
            else self.items
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            if not len(sel):
                return
            nodes, sub, root_pos = self._sample_subgraph()
            nodes_p, src, dst, w, n_real = self._pad(nodes, sub, root_pos)
            batch = self.dataset.gather_batch(sel, node_index=nodes_p)
            batch["target_nodes"] = root_pos
            batch["sub_src"] = src
            batch["sub_dst"] = dst
            batch["sub_weight"] = w
            yield batch
