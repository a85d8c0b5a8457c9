"""Host-side sparse graph representation and graph algorithms.

Replacement for the reference's torch_sparse / PyG graph plumbing
(``lib/sgp_preprocessing.py:67-160``, ``tsl/ops/connectivity.py``, PyG
``k_hop_subgraph`` / ``to_undirected`` / ``dropout_adj``). Everything here is
**host-side numpy/scipy** — graphs are preprocessed once on the host; device
compute consumes either a dense operator (one matmul) or packed block-sparse
tensors (BSR path), built by :meth:`Graph.to_dense` /
:meth:`Graph.to_bsr`.

Conventions
-----------
Edges are stored COO as ``(src, dst, weight)``. The propagation operator is
the (normalized) adjacency ``A[dst, src] = w`` so that ``x' = A @ x``
aggregates *source* features into each *target* node — matching the
reference's ``preprocess_adj`` which builds ``SparseTensor(row=target,
col=source)`` from an edge_index (``lib/sgp_preprocessing.py:78-82``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class Graph:
    """An immutable weighted directed graph on ``num_nodes`` nodes.

    Attributes:
        src: ``[E]`` int32 source node of each edge.
        dst: ``[E]`` int32 target node of each edge.
        weight: ``[E]`` float32 edge weight.
        num_nodes: number of nodes ``N``.
    """
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_nodes: int

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        w = (np.ones(len(self.src), np.float32) if self.weight is None
             else np.asarray(self.weight, np.float32))
        object.__setattr__(self, "weight", w)
        if len(self.src) != len(self.dst) or len(self.src) != len(w):
            raise ValueError("src/dst/weight length mismatch")

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_edge_index(cls, edge_index: np.ndarray,
                        edge_weight: Optional[np.ndarray] = None,
                        num_nodes: Optional[int] = None) -> "Graph":
        """Build from a PyG-style ``[2, E]`` edge_index (row0=src, row1=dst)."""
        edge_index = np.asarray(edge_index)
        if num_nodes is None:
            num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
        return cls(edge_index[0], edge_index[1], edge_weight, num_nodes)

    @classmethod
    def from_dense(cls, adj: np.ndarray) -> "Graph":
        """Build from a dense ``A[dst, src]`` matrix (zeros = no edge)."""
        dst, src = np.nonzero(adj)
        return cls(src, dst, adj[dst, src].astype(np.float32), adj.shape[0])

    # -- basic properties --------------------------------------------------
    @property
    def num_edges(self) -> int:
        return int(len(self.src))

    @property
    def edge_index(self) -> np.ndarray:
        return np.stack([self.src, self.dst]).astype(np.int64)

    def to_scipy(self) -> sp.csr_matrix:
        """CSR matrix of the operator ``A[dst, src] = w``."""
        return sp.csr_matrix(
            (self.weight, (self.dst, self.src)),
            shape=(self.num_nodes, self.num_nodes))

    @classmethod
    def from_scipy(cls, mat: sp.spmatrix) -> "Graph":
        coo = mat.tocoo()
        return cls(coo.col, coo.row, coo.data.astype(np.float32),
                   mat.shape[0])

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        """Dense operator ``A[dst, src]`` — the one-matmul propagation path."""
        return np.asarray(self.to_scipy().todense(), dtype=dtype)

    def to_bsr(self, block: int = 128):
        """Pack into block-sparse-row format for the BSR SpMM.

        Returns ``(blocks, block_cols, row_ptr)`` where ``blocks`` is
        ``[nnzb, block, block]`` dense sub-tiles of the (zero-padded)
        operator, ``block_cols[nnzb]`` the block-column index of each tile
        and ``row_ptr[N/block + 1]`` CSR-style offsets over block rows.
        """
        n_pad = ((self.num_nodes + block - 1) // block) * block
        mat = self.to_scipy()
        mat.resize((n_pad, n_pad))
        bsr = mat.tobsr(blocksize=(block, block))
        bsr.sort_indices()
        return (np.asarray(bsr.data, np.float32),
                np.asarray(bsr.indices, np.int32),
                np.asarray(bsr.indptr, np.int32))

    # -- views -------------------------------------------------------------
    def with_weight(self, weight: np.ndarray) -> "Graph":
        return Graph(self.src, self.dst, weight, self.num_nodes)


# ---------------------------------------------------------------------------
# graph algorithms (all host-side, operate on / return Graph)
# ---------------------------------------------------------------------------

def coalesce(g: Graph, reduce: str = "sum") -> Graph:
    """Sort edges by (dst, src) and merge duplicates. Uses the native
    kernel (``sgp/native``) for large edge lists when available;
    numpy fallback is behaviorally identical (tested)."""
    if reduce == "sum" and g.num_edges >= 100_000:
        from sgp import native
        if native.AVAILABLE:
            out = native.coalesce_edges(g.src, g.dst, g.weight,
                                        g.num_nodes)
            if out is not None:
                return Graph(out[0], out[1], out[2], g.num_nodes)
    key = g.dst.astype(np.int64) * g.num_nodes + g.src
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], g.src[order], g.dst[order], g.weight[order]
    uniq, first = np.unique(key, return_index=True)
    if len(uniq) == len(key):
        return Graph(src, dst, w, g.num_nodes)
    seg = np.searchsorted(uniq, key)
    if reduce == "sum":
        wm = np.zeros(len(uniq), np.float32)
        np.add.at(wm, seg, w)
    elif reduce == "max":
        wm = np.full(len(uniq), -np.inf, np.float32)
        np.maximum.at(wm, seg, w)
    else:
        raise ValueError(reduce)
    return Graph(src[first], dst[first], wm, g.num_nodes)


def transpose(g: Graph) -> Graph:
    """Reverse all edges (operator transpose)."""
    return Graph(g.dst, g.src, g.weight, g.num_nodes)


def to_undirected(g: Graph, reduce: str = "sum") -> Graph:
    """Symmetrize: ``A + A^T`` with duplicate merge.

    Matches the reference's ``adj + adj.t()`` in ``sgp_spatial_support``
    (``lib/sgp_preprocessing.py:124-125``); the ``sgp_spatial_embedding``
    path uses PyG ``to_undirected`` which *sums* duplicate weights too.
    """
    return coalesce(Graph(
        np.concatenate([g.src, g.dst]),
        np.concatenate([g.dst, g.src]),
        np.concatenate([g.weight, g.weight]),
        g.num_nodes), reduce=reduce)


def add_self_loops(g: Graph, fill_value: float = 1.0) -> Graph:
    """Set the diagonal to ``fill_value`` (torch_sparse ``set_diag``)."""
    loop = np.arange(g.num_nodes, dtype=np.int32)
    keep = g.src != g.dst
    return coalesce(Graph(
        np.concatenate([g.src[keep], loop]),
        np.concatenate([g.dst[keep], loop]),
        np.concatenate([g.weight[keep],
                        np.full(g.num_nodes, fill_value, np.float32)]),
        g.num_nodes))


def remove_self_loops(g: Graph) -> Graph:
    keep = g.src != g.dst
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


def weighted_degree(g: Graph, direction: str = "in") -> np.ndarray:
    """Weighted degree. ``in`` sums over incoming edges (by dst) — the
    row-sum of the operator — matching ``tsl/ops/connectivity.py:175-197``."""
    index = g.dst if direction == "in" else g.src
    deg = np.zeros(g.num_nodes, np.float32)
    np.add.at(deg, index, g.weight)
    return deg


def normalize_adj(g: Graph, norm: str = "row",
                  add_loops: bool = False,
                  remove_loops: bool = False) -> Graph:
    """Normalize the propagation operator.

    ``row``: ``D_in^-1 A`` (reference ``preprocess_adj``,
    ``lib/sgp_preprocessing.py:100-103``); ``sym``: ``D^-1/2 A D^-1/2``
    (``:94-98``); ``none``: pass-through. Zero-degree rows get 0 (inf→0).
    """
    if add_loops:
        g = add_self_loops(g)
    elif remove_loops:
        g = remove_self_loops(g)
    if norm == "none":
        return g
    deg = weighted_degree(g, "in")
    if norm == "row":
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-38), 0.0)
        return g.with_weight(g.weight * inv[g.dst])
    if norm == "sym":
        inv_sqrt = np.where(deg > 0, deg.astype(np.float64) ** -0.5, 0.0)
        return g.with_weight(
            (g.weight * inv_sqrt[g.dst] * inv_sqrt[g.src]).astype(np.float32))
    raise ValueError(f"unknown norm {norm!r}")


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse-Cuthill-McKee node ordering: concentrates edges near the
    diagonal so the 128x128 BSR packing (``Graph.to_bsr``) has empty
    off-band blocks for the BSR SpMM to skip. Returns the
    permutation ``perm`` (new position -> old id)."""
    mat = g.to_scipy() + g.to_scipy().T
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(mat.tocsr(),
                                         symmetric_mode=True),
        np.int64)


def permute_nodes(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel nodes so new node ``i`` is old node ``perm[i]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Graph(inv[g.src], inv[g.dst], g.weight, g.num_nodes)


def spgemm(a: Graph, b: Graph) -> Graph:
    """Sparse-sparse matmul of two operators (support materialization,
    replaces torch_sparse ``adj @ adj`` in ``lib/sgp_preprocessing.py:145``).
    """
    return Graph.from_scipy(a.to_scipy() @ b.to_scipy())


def edge_dropout(g: Graph, p: float, rng: np.random.Generator) -> Graph:
    """Drop each edge independently with prob ``p`` (PyG ``dropout_adj``
    semantics as used in ``lib/sgp_preprocessing.py:177`` — no rescaling)."""
    if p <= 0:
        return g
    keep = rng.random(g.num_edges) >= p
    return Graph(g.src[keep], g.dst[keep], g.weight[keep], g.num_nodes)


def k_hop_subgraph(g: Graph, roots: np.ndarray, k: int,
                   flow: str = "target_to_source"
                   ) -> Tuple[np.ndarray, Graph, np.ndarray]:
    """K-hop neighborhood expansion (replaces PyG ``k_hop_subgraph`` as used
    by ``lib/dataloader/subgraph_dataloader.py:159-167``).

    With ``flow='target_to_source'`` the frontier expands from targets to
    their *sources* (the nodes whose features flow into the roots).

    Returns ``(nodes, sub, root_positions)``: the sorted node set (roots
    first is NOT guaranteed — use root_positions), the induced subgraph with
    relabeled node ids, and positions of the roots inside ``nodes``.
    """
    roots = np.asarray(roots, np.int64)
    mask = None
    if flow == "target_to_source" and g.num_edges >= 100_000:
        from sgp import native
        if native.AVAILABLE:
            mask = native.khop_mask(g.src, g.dst, g.num_nodes, roots, k)
    if mask is None:
        mask = np.zeros(g.num_nodes, bool)
        mask[roots] = True
        frontier = roots
        # CSC-by-target for fast "who feeds node t" lookups
        mat = sp.csr_matrix(
            (np.ones(g.num_edges, np.int8), (g.dst, g.src)),
            shape=(g.num_nodes, g.num_nodes))
        for _ in range(k):
            if flow == "target_to_source":
                nxt = mat[frontier].indices
            else:
                nxt = mat.T.tocsr()[frontier].indices
            nxt = np.unique(nxt)
            new = nxt[~mask[nxt]]
            if len(new) == 0:
                break
            mask[new] = True
            frontier = new
    nodes = np.nonzero(mask)[0]
    relabel = np.full(g.num_nodes, -1, np.int64)
    relabel[nodes] = np.arange(len(nodes))
    e_keep = mask[g.src] & mask[g.dst]
    sub = Graph(relabel[g.src[e_keep]], relabel[g.dst[e_keep]],
                g.weight[e_keep], len(nodes))
    return nodes, sub, relabel[roots]


def padded_incoming(g: Graph, pad_to: Optional[int] = None):
    """ELL layout of the incoming edges: per destination node, the
    source indices padded to a fixed width.

    The gather-free alternative to scatter-style message aggregation:
    with a fixed neighbor width ``D``, ``sum_j m(x[dst], x[src_j])``
    becomes a contiguous reduction over axis 1 of an ``[N, D, ...]``
    array — no scatter/sort lowering at all. For k-nn graphs the
    in-degree is exactly ``k`` so the padding waste is zero.

    Returns ``(src_idx [N, D] int32, mask [N, D] bool)``; padded slots
    point at node 0 with ``mask=False``.
    """
    order = np.lexsort((g.src, g.dst))
    dst_s, src_s = g.dst[order], g.src[order]
    counts = np.bincount(dst_s, minlength=g.num_nodes)
    d = int(pad_to or (counts.max() if counts.size else 0))
    if counts.size and counts.max() > d:
        raise ValueError(f"pad_to={d} < max in-degree {counts.max()}")
    src_idx = np.zeros((g.num_nodes, d), np.int32)
    mask = np.zeros((g.num_nodes, d), bool)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(dst_s)) - starts[dst_s]
    src_idx[dst_s, slot] = src_s
    mask[dst_s, slot] = True
    return src_idx, mask

def dummy_graph(kind: str, num_nodes: int, edge_prob: float = 0.1,
                directed: bool = True, seed: int = 0):
    """Synthetic connectivity (``tsl/ops/connectivity.py:258-290``
    ``get_dummy_edge_index``): ``'identity'`` (A = I), ``'full'``
    (all pairs incl. self), ``'random'`` (Erdős–Rényi with edge
    probability ``edge_prob``; undirected = symmetrized upper
    triangle), or ``'none'`` (returns None). Host-side :class:`Graph`
    with unit weights."""
    if kind == "none":
        return None
    if kind == "identity":
        idx = np.arange(num_nodes, dtype=np.int64)
        return Graph(idx, idx, np.ones(num_nodes, np.float32),
                     num_nodes)
    if kind == "full":
        idx = np.arange(num_nodes, dtype=np.int64)
        src = np.repeat(idx, num_nodes)
        dst = np.tile(idx, num_nodes)
        return Graph(src, dst, np.ones(len(src), np.float32), num_nodes)
    if kind == "random":
        rng = np.random.default_rng(seed)
        keep = rng.random((num_nodes, num_nodes)) < edge_prob
        np.fill_diagonal(keep, False)
        if not directed:
            keep = np.triu(keep) | np.triu(keep).T
        src, dst = np.nonzero(keep)
        return Graph(src.astype(np.int64), dst.astype(np.int64),
                     np.ones(len(src), np.float32), num_nodes)
    raise ValueError(f"unknown dummy connectivity {kind!r}")


def band_graph(num_nodes: int, halfwidth: int = 4) -> Graph:
    """Banded line graph: node ``i`` connects to ``i±1..halfwidth``
    (both directions, unit weights) — the road-network shape of the
    traffic datasets (METR-LA/PEMS-BAY: low degree, 1-D locality).
    Used by the deep-halo scaling projection and its tests."""
    srcs, dsts = [], []
    for d in range(1, halfwidth + 1):
        idx = np.arange(num_nodes - d)
        srcs += [idx, idx + d]
        dsts += [idx + d, idx]
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    return Graph(src, dst, np.ones(len(src), np.float32), num_nodes)


def band_windows(dense_adj: np.ndarray, block: int,
                 width_mult: int = 128, uniform: bool = True):
    """Per-row-block column windows of a (near-)banded adjacency
    (``A[dst, src]`` boolean/weight matrix, e.g. after :func:`rcm_order`
    relabeling): for each block of ``block`` consecutive dst rows,
    the smallest column interval covering every edge, padded to a
    ``width_mult`` multiple (clamped into [0, N]).

    Returns ``(block, width, los)`` with ``los`` a tuple of static
    ints — the GatedGN dense all-pairs aggregation uses it to compute
    only ``N * width`` candidate pairs instead of ``N^2``
    (``models/graph_layers.py`` ``adj_band=``). With
    ``uniform=False``, ``width`` is instead a per-block tuple (each
    block hugs its own band instead of padding to the widest —
    measured 21-26% fewer candidate pairs on the Table-2 full graphs,
    at the cost of a few distinct block shapes in the program)."""
    a = np.asarray(dense_adj) != 0
    n = a.shape[0]
    width = 1
    bounds = []
    for i0 in range(0, n, block):
        cols = np.nonzero(a[i0:i0 + block].any(axis=0))[0]
        if len(cols):
            lo, hi = int(cols[0]), int(cols[-1])
        else:
            lo, hi = 0, 0
        bounds.append((lo, hi))
        width = max(width, hi - lo + 1)
    width = min(n, -(-width // width_mult) * width_mult)
    if uniform:
        los = tuple(min(max(lo, 0), n - width) for lo, _ in bounds)
        return block, width, los
    widths = tuple(
        min(n, -(-max(hi - lo + 1, 1) // width_mult) * width_mult)
        for lo, hi in bounds)
    los = tuple(min(max(lo, 0), n - w)
                for (lo, _), w in zip(bounds, widths))
    return block, widths, los

def auto_band(g: Graph, block: int = 256, width_mult: int = 128,
              max_nodes: int = 20000, max_frac: float = 0.6):
    """Variable-width band windows of ``g`` in its NATURAL node order,
    or ``None`` when they would not pay: the candidate-pair count of
    the windowed sweep must be under ``max_frac`` of the full ``N^2``
    (road-network labelings are usually localized enough; a shuffled
    labeling falls back to the full sweep). Used by the baseline
    runners' ``--gn-aggregation dense`` path — the bench variant
    additionally RCM-relabels first (``rcm_order``), which a dataset
    runner cannot do without permuting every array."""
    n = g.num_nodes
    if n > max_nodes:          # host [N, N] bool build guard
        return None
    a = np.zeros((n, n), bool)
    if g.weight is not None:
        keep = np.asarray(g.weight) != 0   # stored zeros ≠ edges
        a[np.asarray(g.dst)[keep], np.asarray(g.src)[keep]] = True
    else:
        a[g.dst, g.src] = True
    band = band_windows(a, block, width_mult, uniform=False)
    blk, widths, _ = band
    if sum(widths) * blk >= max_frac * n * n:
        return None
    return band


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-order (Morton) node permutation from 2-D positions: nodes
    sorted by interleaved coordinate bits, so CONTIGUOUS index blocks
    are compact spatial tiles. For geometric knn/threshold graphs a
    tile's boundary scales with its perimeter — typically a much
    smaller halo cut than :func:`rcm_order`'s 1-D bands (RCM remains
    the right choice when only connectivity is known). Returns
    ``perm`` (new position -> old id), same convention as
    :func:`rcm_order`."""
    p = np.asarray(pos, np.float64)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError("morton_order expects [N, 2] positions")
    lo, hi = p.min(0), p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12)
         * (2 ** bits - 1)).astype(np.uint64)
    code = np.zeros(len(p), np.uint64)
    for b in range(bits):
        code |= ((q[:, 0] >> np.uint64(b)) & np.uint64(1)) \
            << np.uint64(2 * b)
        code |= ((q[:, 1] >> np.uint64(b)) & np.uint64(1)) \
            << np.uint64(2 * b + 1)
    return np.argsort(code, kind="stable").astype(np.int64)
