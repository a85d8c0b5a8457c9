"""Boundary halo exchange for node-sharded K-hop propagation.

SURVEY.md §5.8: partition the node dimension 1-D over a mesh axis; per
hop, exchange ONLY the boundary rows each shard's in-edges reference on
other shards (``all_to_all`` over the device interconnect), instead of all-gathering the
full ``[N, F]`` activation. With a locality-preserving node order (RCM,
:func:`sgp.graph.sparse.rcm_order`) the exchanged bytes per hop are
``S * B_max * F`` per device with ``B_max ≪ N``.

Everything static-shape: boundary index sets are precomputed on host,
padded to the max per-peer count, and shipped as per-shard constants
(stacked ``[S, ...]`` arrays sharded over the axis so each device reads
its own slice). The device-side hop is

    out_local = A_local @ x_local + A_halo @ all_to_all(x_local[send_idx])

with the local block matmul overlapping the collective.

The per-shard operator blocks come in three representations so the plan
scales past small graphs (dense ``[Nl, Nl]`` / ``[Nl, S*B]`` blocks
are O(N²/S) per device, which dies exactly where multi-device is
needed):

- ``dense``: the diagonal block as a dense matrix; one matmul.
  Right for small shards (the reference benchmark graphs).
- ``bsr``: the diagonal block packed into 128×128 tiles at nonzero
  block positions; compute is a batched block matmul + block-row
  ``segment_sum`` (XLA-native block-sparse SpMM, tile-aligned). Plan
  memory O(stored blocks) — with RCM ordering that is O(E/S) per
  device. Halo entries are COO (they are few by construction).
- ``coo``: both blocks as gather + ``segment_sum`` — the O(E) oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sgp.graph.sparse import Graph

_BLOCK = 128


@dataclasses.dataclass
class HaloSpec:
    """Host-built halo-exchange plan for a 1-D node partition.

    Arrays are stacked per-shard (leading dim ``S``) so that sharding
    them over the mesh axis hands each device exactly its own slice.

    - ``local``: the diagonal (local->local) block of each shard's rows
      of ``A``, representation per ``mode``:
      dense ``(a_local [S, Nl, Nl],)``;
      bsr ``(blocks [S, nb, 128, 128], brows [S, nb], bcols [S, nb])``;
      coo ``(src [S, E], dst [S, E], w [S, E])`` (zero-weight padding).
    - ``halo``: the off-diagonal entries, columns remapped to the recv
      layout (peer-``j`` section ``j*B:(j+1)*B`` = the values this
      shard needs from peer ``j``): dense ``(a_halo [S, Nl, S*B],)``;
      otherwise COO ``(hsrc [S, Eh], hdst [S, Eh], hw [S, Eh])`` with
      ``hsrc`` indexing the ``S*B`` recv buffer.
    - ``send_idx [S, S, B]``: on device ``i``, slot ``j`` holds the
      LOCAL indices of the rows peer ``j`` needs from ``i`` (pad 0).
    """
    mode: str
    local: Tuple[jnp.ndarray, ...]
    halo: Tuple[jnp.ndarray, ...]
    send_idx: jnp.ndarray
    n_shards: int
    nodes_per_shard: int
    num_nodes: int            # true N (<= S * Nl; rest is padding)
    b_max: int
    boundary_counts: np.ndarray   # [S, S] true per-pair boundary sizes
    # wire format of the exchanged boundary rows: 'float32' (exact),
    # 'bfloat16' (halves interconnect bytes; halo contributions accumulate
    # in f32), or 'int8' (per-row absmax scales ride along as f32 —
    # ~4x fewer bytes + 4 bytes/row)
    payload_dtype: str = "float32"
    # node permutation the plan was built under (``perm[new] = old``,
    # e.g. RCM): a cut-minimizing order shrinks b_max — the inter-host-bound
    # term of the 32-chip projection. ``halo_khop`` applies it.
    perm: np.ndarray = None
    # two-level (host, chip) exchange plan — see ``build_halo_spec``'s
    # ``chips_per_host``: (send_intra [S, C, Bi], send_cross
    # [S, H, Bc], assemble [S, S*B], C, H, b_intra, b_cross)
    hier: tuple = None
    # deep-halo plan (``build_halo_spec(..., depth=d)``): exchange a
    # d-hop boundary ONCE, then run d in-buffer hops — the per-hop
    # collective (and its fixed inter-host collective latency, the dominant term of the
    # 32-chip projection) amortizes d-fold. ``ext`` is the COO operator
    # block that advances the halo rows themselves between exchanges:
    # (esrc [S, Ee], edst [S, Ee], ew [S, Ee]) with ``edst`` indexing
    # the ``S*B`` recv buffer and ``esrc`` the concatenated
    # ``[local (Nl) | buffer (S*B)]`` state (esrc < Nl = local row).
    depth: int = 1
    ext: tuple = ()
    # depth-1 boundary max (== b_max when depth == 1): the naive
    # ledger baseline stays comparable across depths
    b_max_hop1: int = None

    def dcn_bytes_per_hop(self, feat: int) -> int:
        """Inter-host bytes per device per hop under the two-level exchange
        (0 when no hier plan / single host): each boundary row crosses
        between hosts once per NEEDING HOST, padded to ``b_cross``. For a deep
        (depth-d) plan the exchange fires once per d hops — the value
        is amortized accordingly."""
        if self.hier is None:
            return 0
        _, _, _, c, h, bi, bc = self.hier
        per_row = feat * self.payload_itemsize() + (
            4 if self.payload_dtype == "int8" else 0)
        return int((h - 1) * bc * per_row / max(1, self.depth))

    def payload_itemsize(self) -> float:
        return {"float32": 4, "bfloat16": 2, "int8": 1}[
            self.payload_dtype]

    def bytes_per_hop(self, feat: int, itemsize: int = None) -> int:
        """Bytes exchanged per device per hop (send-buffer size,
        amortized over the plan's ``depth`` — a deep plan exchanges its
        widened boundary once per d hops). ``itemsize`` defaults to the
        plan's payload dtype; int8 adds the per-row f32 scale."""
        if itemsize is None:
            itemsize = self.payload_itemsize()
        per_row = feat * itemsize + (4 if self.payload_dtype == "int8"
                                     and itemsize == 1 else 0)
        return int(self.n_shards * self.b_max * per_row
                   / max(1, self.depth))

    def dense_gather_bytes(self, feat: int, itemsize: int = 4) -> int:
        """What the full-all-gather alternative would move per hop."""
        return self.n_shards * self.nodes_per_shard * feat * itemsize

    def plan_bytes_per_device(self) -> int:
        """Device-resident plan memory per shard (operator blocks +
        send plan) — the thing the sparse modes keep at O(E/S)."""
        leaves = (list(self.local) + list(self.halo) + [self.send_idx]
                  + list(self.ext))
        return sum(l.size * l.dtype.itemsize for l in leaves
                   ) // self.n_shards

    def ext_edges_max(self) -> int:
        """Max true (non-padding) ext-block edges on any shard — the
        extra per-hop compute a deep-halo in-buffer hop performs."""
        if not self.ext:
            return 0
        return int(np.count_nonzero(np.asarray(self.ext[2]),
                                    axis=1).max())


def build_halo_spec(g: Graph, n_shards: int, dtype=jnp.float32,
                    mode: str = "auto", order: str = "natural",
                    payload_dtype: str = "float32",
                    chips_per_host: int = None,
                    depth: int = 1,
                    host_only: bool = False) -> HaloSpec:
    """Partition ``g``'s nodes into ``n_shards`` contiguous blocks and
    precompute the boundary-exchange plan.

    ``order='rcm'`` reorders the nodes with reverse-Cuthill-McKee
    BEFORE partitioning (an explicit permutation array also works):
    contiguous blocks of a bandwidth-minimizing order have far smaller
    boundary sets, directly shrinking ``b_max`` and the bytes-per-hop
    ledger. ``halo_khop`` applies/undoes the stored permutation, so
    callers keep natural node order at the boundary.

    ``payload_dtype``: wire format of the exchanged rows —
    ``'bfloat16'`` halves the comm bytes (f32 accumulation unchanged),
    ``'int8'`` quantizes each boundary row with a per-row absmax scale
    (sent alongside as f32).

    ``chips_per_host`` (C, with ``n_shards = H * C`` spanning H > 1
    hosts): additionally build the TWO-LEVEL exchange plan that keeps
    collectives within the host and dedups inter-host traffic — boundary rows exchange
    intra-host with an ``all_to_all`` over the ``chip`` mesh axis,
    while each shard ships each remote HOST the union of rows any of
    its chips needs (ONE host crossing per needing host instead of one
    per needing chip, and padded to the cross-host max instead of the
    global ``b_max``); the received per-host buffers redistribute over
    within the host (``all_gather``) and a precomputed index map reassembles the
    flat recv layout. Use with ``halo_khop(..., axes=('host',
    'chip'))`` on a 2-D mesh whose device raveling matches
    ``shard = host * C + chip``.

    ``depth`` (deep halo): exchange the DEPTH-hop in-neighborhood of
    each shard's rows once, then run ``depth`` hops locally before the
    next collective — ``halo_khop`` advances the halo rows between
    exchanges with the ``ext`` COO block. Boundary sets (and so
    ``b_max`` / the bytes per exchange) grow with the depth-d
    reachability, but the per-hop collective count — and with it the
    fixed fixed inter-host collective latency that dominates the 32-chip single-pass
    projection — drops d-fold. Local outputs are EXACT for any
    ``k``: a halo row at graph distance ``δ`` holds the true ``A^t x``
    value whenever ``δ <= depth - t`` hops since the last exchange,
    and rows farther out are never read by a still-exact row."""
    n = g.num_nodes
    s = n_shards
    perm = None
    if isinstance(order, np.ndarray):
        perm = order
    elif order == "rcm":
        from sgp.graph.sparse import rcm_order
        perm = rcm_order(g)
    elif order != "natural":
        raise ValueError(f"unknown node order {order!r}")
    if perm is not None:
        from sgp.graph.sparse import permute_nodes
        g = permute_nodes(g, perm)
    nl = -(-n // s)                 # ceil
    if mode == "auto":
        # dense diagonal blocks are the fastest up to a few k nodes
        # per shard; past that the O(Nl^2) plan memory dominates
        mode = "dense" if nl <= 4096 else "bsr"
    if mode == "bsr":
        nl = -(-nl // _BLOCK) * _BLOCK
    # CSR block slicing, never the full dense [N_pad, N_pad] (O(N^2)
    # host memory would cap the graph size this plan can be built for)
    csr = g.to_scipy().tocsr()

    # pass 1: per-shard row blocks + boundary sets (what i needs from j)
    need = [[None] * s for _ in range(s)]
    counts = np.zeros((s, s), np.int64)
    row_blocks = []
    for i in range(s):
        rows = csr[i * nl:min((i + 1) * nl, n)].tocsc()
        row_blocks.append(rows)
        for j in range(s):
            if j == i:
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            # explicitly-stored zeros are not real dependencies: they'd
            # inflate b_max / the send buffers / the bytes-per-hop ledger
            nz = np.unique(block.col[block.data != 0])
            need[i][j] = nz
            counts[i, j] = len(nz)
    b_max_hop1 = max(1, int(counts.max()))
    if depth > 1:
        # widen the boundary sets to the depth-hop in-neighborhood:
        # frontier closure over csr (rows = dst, cols = src), explicit
        # zeros excluded like pass 1. Sets stay sorted LOCAL indices
        # per owner shard (the convention every later pass relies on).
        for i in range(s):
            lo, hi = i * nl, min((i + 1) * nl, n)
            working = set(range(lo, hi))
            frontier = np.arange(lo, hi)
            for _ in range(depth):
                sub = csr[frontier].tocoo()
                deps = np.unique(sub.col[sub.data != 0])
                new = np.asarray(
                    [q for q in deps.tolist() if q not in working],
                    np.int64)
                if not len(new):
                    break
                working.update(new.tolist())
                frontier = new
            halo_nodes = np.asarray(
                sorted(working - set(range(lo, hi))), np.int64)
            owners = halo_nodes // nl
            for j in range(s):
                if j == i:
                    continue
                nz = halo_nodes[owners == j] - j * nl
                need[i][j] = nz
                counts[i, j] = len(nz)
    b_max = max(1, int(counts.max()))

    # pass 2: send plan + halo entries in recv-layout columns
    send_idx = np.zeros((s, s, b_max), np.int32)
    halo_coo = [[] for _ in range(s)]    # per shard: (dst, recv_col, w)
    for i in range(s):
        rows = row_blocks[i]
        for j in range(s):
            if j == i:
                continue
            nz = need[i][j]
            send_idx[j, i, :len(nz)] = nz   # j SENDS these rows to i
            if not len(nz):
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            keep = block.data != 0
            dst, col, w = (block.row[keep], block.col[keep],
                           block.data[keep])
            recv_col = j * b_max + np.searchsorted(nz, col)
            halo_coo[i].append((dst, recv_col, w))

    local, halo = _pack_blocks(mode, row_blocks, halo_coo, s, nl, n,
                               b_max)
    # host_only: keep every plan array in host numpy — for ledger
    # math that never executes the plan (no device upload needed)
    conv = (lambda a, d=None: a) if host_only else jnp.asarray
    local = tuple(conv(a, dtype if a.dtype == np.float32 else None)
                  for a in local)
    halo = tuple(conv(a, dtype if a.dtype == np.float32 else None)
                 for a in halo)
    ext = ()
    if depth > 1:
        ext = _build_ext(csr, need, s, nl, n, b_max, conv)
    hier = None
    if chips_per_host is not None and s >= chips_per_host:
        # s == chips_per_host (single host) still builds a valid plan
        # (H=1: the cross-host stage degenerates to identity) so a
        # tuple-axis mesh with one host runs unchanged
        if s % chips_per_host:
            raise ValueError(
                f"n_shards ({s}) must be a multiple of chips_per_host "
                f"({chips_per_host}) for the two-level exchange")
        hier = _build_hier(need, s, b_max, chips_per_host, conv)
    return HaloSpec(mode, local, halo, conv(send_idx), s, nl, n,
                    b_max, counts, payload_dtype, perm, hier, depth,
                    ext, b_max_hop1)


def _build_ext(csr, need, s, nl, n, b_max, conv=None):
    """Halo-row advance block for the deep-halo plan: for every recv
    buffer slot (a node some shard needs), its row of ``A`` with
    columns remapped into the shard's ``[local | buffer]`` state.
    Columns outside the working set are DROPPED — they only feed rows
    past the still-exact horizon (see ``build_halo_spec``'s depth
    note), never a row that is read while exact."""
    per = []
    for i in range(s):
        lo = i * nl
        rows_e, cols_e, w_e = [], [], []
        for j in range(s):
            nzj = need[i][j]
            if j == i or nzj is None or not len(nzj):
                continue
            sub = csr[j * nl + nzj].tocoo()
            keep = sub.data != 0
            rr, cc, ww = sub.row[keep], sub.col[keep], sub.data[keep]
            owners = cc // nl
            esrc = np.full(len(cc), -1, np.int64)
            is_local = owners == i
            esrc[is_local] = cc[is_local] - lo
            for jj in np.unique(owners[~is_local]):
                m = (owners == jj) & ~is_local
                nzjj = need[i][jj]
                if nzjj is None or not len(nzjj):
                    continue
                loc = cc[m] - jj * nl
                pos = np.searchsorted(nzjj, loc)
                pos_c = np.minimum(pos, len(nzjj) - 1)
                inset = nzjj[pos_c] == loc
                e = np.full(len(loc), -1, np.int64)
                e[inset] = nl + jj * b_max + pos_c[inset]
                esrc[m] = e
            keep2 = esrc >= 0
            rows_e.append(j * b_max + rr[keep2])
            cols_e.append(esrc[keep2])
            w_e.append(ww[keep2])
        if rows_e:
            per.append((np.concatenate(cols_e),
                        np.concatenate(rows_e),
                        np.concatenate(w_e).astype(np.float32)))
        else:
            per.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.float32)))
    ne = max(1, max(len(p[0]) for p in per))
    esrc = np.zeros((s, ne), np.int32)
    edst = np.zeros((s, ne), np.int32)
    ew = np.zeros((s, ne), np.float32)
    for i, (c, r, v) in enumerate(per):
        esrc[i, :len(c)], edst[i, :len(c)], ew[i, :len(c)] = c, r, v
    conv = conv or jnp.asarray
    return (conv(esrc), conv(edst), conv(ew))


def _build_hier(need, s, b_max, chips_per_host, conv=None):
    """Two-level exchange plan from the per-pair boundary sets.

    Layout contract (see ``_hier_exchange``): the device-local recv
    buffer is ``concat([recv_intra [C, Bi], allcross [C, H, Bc]])``
    flattened along rows; ``assemble[i]`` maps every slot of the flat
    ``[S * b_max]`` recv layout (what ``_apply_halo``'s COO columns
    index) to its row in that buffer. Padding slots map to row 0 —
    harmless, the halo entries never reference them."""
    c_per = chips_per_host
    h_num = s // c_per
    # intra-host max per-pair boundary; cross: union per (src, host)
    b_intra = 1
    union = {}
    for i in range(s):
        hi = i // c_per
        for j in range(s):
            if j == i or need[i][j] is None:
                continue
            nz = need[i][j]
            if j // c_per == hi:
                b_intra = max(b_intra, len(nz))
            else:
                key = (j, hi)
                union[key] = np.union1d(union[key], nz) \
                    if key in union else np.asarray(nz)
    b_cross = max([1] + [len(v) for v in union.values()])
    send_intra = np.zeros((s, c_per, b_intra), np.int32)
    send_cross = np.zeros((s, h_num, b_cross), np.int32)
    assemble = np.zeros((s, s * b_max), np.int32)
    for (j, h), u in union.items():
        send_cross[j, h, :len(u)] = u
    for i in range(s):
        hi, ci = divmod(i, c_per)
        for j in range(s):
            if j == i or need[i][j] is None:
                continue
            nz = need[i][j]
            hj, cj = divmod(j, c_per)
            if hj == hi:
                # shard j ships chip ci of its host these rows directly
                send_intra[j, ci, :len(nz)] = nz
                pos = cj * b_intra + np.arange(len(nz))
            else:
                u = union[(j, hi)]
                pos = c_per * b_intra + (cj * h_num + hj) * b_cross \
                    + np.searchsorted(u, nz)
            assemble[i, j * b_max:j * b_max + len(nz)] = pos
    conv = conv or jnp.asarray
    return (conv(send_intra), conv(send_cross),
            conv(assemble), c_per, h_num, b_intra, b_cross)


def _pack_blocks(mode, row_blocks, halo_coo, s, nl, n, b_max):
    """Stack the per-shard local/halo operator blocks for one mode."""
    import scipy.sparse as sp

    def local_block(i):
        lb = row_blocks[i][:, i * nl:min((i + 1) * nl, n)].copy()
        lb.resize((nl, nl))
        return lb

    if mode == "dense":
        a_local = np.stack([local_block(i).toarray().astype(np.float32)
                            for i in range(s)])
    elif mode == "bsr":
        per = []
        for i in range(s):
            bsr = sp.csr_matrix(local_block(i)).tobsr(
                blocksize=(_BLOCK, _BLOCK))
            bsr.sort_indices()
            brows = np.repeat(np.arange(len(bsr.indptr) - 1, dtype=np.int32),
                              np.diff(bsr.indptr))
            per.append((np.asarray(bsr.data, np.float32),
                        brows, np.asarray(bsr.indices, np.int32)))
        nb = max(1, max(len(p[2]) for p in per))
        blocks = np.zeros((s, nb, _BLOCK, _BLOCK), np.float32)
        brows = np.zeros((s, nb), np.int32)
        bcols = np.zeros((s, nb), np.int32)
        for i, (d, r, c) in enumerate(per):
            blocks[i, :len(c)], brows[i, :len(c)], bcols[i, :len(c)] = \
                d, r, c
        a_local = (blocks, brows, bcols)
    elif mode == "coo":
        per = []
        for i in range(s):
            lb = local_block(i).tocoo()
            keep = lb.data != 0
            per.append((lb.col[keep], lb.row[keep],
                        lb.data[keep].astype(np.float32)))
        ne = max(1, max(len(p[0]) for p in per))
        src = np.zeros((s, ne), np.int32)
        dst = np.zeros((s, ne), np.int32)
        w = np.zeros((s, ne), np.float32)
        for i, (c, r, d) in enumerate(per):
            src[i, :len(c)], dst[i, :len(c)], w[i, :len(c)] = c, r, d
        a_local = (src, dst, w)
    else:
        raise ValueError(f"unknown halo mode {mode!r}")

    # halo side: dense [Nl, S*B] matrix for 'dense', COO otherwise
    if mode == "dense":
        a_halo = np.zeros((s, nl, s * b_max), np.float32)
        for i, coos in enumerate(halo_coo):
            for d, c, v in coos:
                a_halo[i, d, c] = v
        return (a_local,), (a_halo,)
    per = []
    for coos in halo_coo:
        if coos:
            d = np.concatenate([e[0] for e in coos])
            c = np.concatenate([e[1] for e in coos])
            v = np.concatenate([e[2] for e in coos]).astype(np.float32)
        else:
            d = c = np.zeros(0, np.int64)
            v = np.zeros(0, np.float32)
        per.append((c, d, v))
    ne = max(1, max(len(p[0]) for p in per))
    hsrc = np.zeros((s, ne), np.int32)
    hdst = np.zeros((s, ne), np.int32)
    hw = np.zeros((s, ne), np.float32)
    for i, (c, d, v) in enumerate(per):
        hsrc[i, :len(c)], hdst[i, :len(c)], hw[i, :len(c)] = c, d, v
    local_t = a_local if isinstance(a_local, tuple) else (a_local,)
    return local_t, (hsrc, hdst, hw)


def _apply_local(mode: str, local, x):
    """``A_local @ x`` for one shard; ``x [..., Nl, F]``."""
    if mode == "dense":
        (a,) = local
        return jnp.einsum("ij,...jf->...if", a, x,
                          preferred_element_type=jnp.float32
                          ).astype(x.dtype)
    x2 = jnp.moveaxis(x, -2, 0)          # [Nl, ..., F]
    if mode == "bsr":
        blocks, brows, bcols = local
        bs = blocks.shape[-1]
        n_br = x.shape[-2] // bs
        idx = bcols[:, None] * bs + jnp.arange(bs)[None, :]
        xg = x2[idx]                     # [nb, bs, ..., F]
        yb = jnp.einsum("nij,nj...->ni...", blocks, xg,
                        preferred_element_type=jnp.float32)
        y = jax.ops.segment_sum(yb, brows, num_segments=n_br)
        y = y.reshape((n_br * bs,) + x2.shape[1:])
    else:                                # coo
        src, dst, w = local
        msgs = x2[src] * w.reshape((-1,) + (1,) * (x2.ndim - 1))
        y = jax.ops.segment_sum(msgs, dst, num_segments=x.shape[-2])
    return jnp.moveaxis(y, 0, -2).astype(x.dtype)


def _apply_halo(mode: str, halo, x_halo, nl: int):
    """``A_halo @ recv`` for one shard; ``x_halo [..., S*B, F]``."""
    if mode == "dense":
        (a,) = halo
        return jnp.einsum("ij,...jf->...if", a, x_halo,
                          preferred_element_type=jnp.float32
                          ).astype(x_halo.dtype)
    hsrc, hdst, hw = halo
    x2 = jnp.moveaxis(x_halo, -2, 0)
    msgs = x2[hsrc] * hw.reshape((-1,) + (1,) * (x2.ndim - 1))
    y = jax.ops.segment_sum(msgs, hdst, num_segments=nl)
    return jnp.moveaxis(y, 0, -2).astype(x_halo.dtype)


def _exchange(send, axis, payload: str):
    """``all_to_all`` of ``[..., S, B, F]`` boundary rows in the wire
    dtype. bf16 halves the bytes on the link (the halo matmul still
    accumulates f32); int8 sends per-row absmax-quantized rows plus a
    small f32 scale sidecar (~4x fewer bytes for F≫4). Dequantized
    values come back in the compute dtype."""
    sa = send.ndim - 3
    if payload == "bfloat16":
        recv = jax.lax.all_to_all(send.astype(jnp.bfloat16), axis,
                                  split_axis=sa, concat_axis=sa)
        return recv.astype(send.dtype)
    if payload == "int8":
        scale = jnp.max(jnp.abs(send), axis=-1, keepdims=True)
        scale = jnp.maximum(scale, 1e-30)   # subnormals flush to 0
        q = jnp.round(send / scale * 127.0).astype(jnp.int8)
        rq = jax.lax.all_to_all(q, axis, split_axis=sa, concat_axis=sa)
        rs = jax.lax.all_to_all(scale.astype(jnp.float32), axis,
                                split_axis=sa, concat_axis=sa)
        return (rq.astype(jnp.float32) * (rs / 127.0)).astype(send.dtype)
    return jax.lax.all_to_all(send, axis, split_axis=sa, concat_axis=sa)


def _flat_exchange(x_local, send_idx, axis, payload: str):
    """Flat ``all_to_all`` of the boundary rows; returns the recv
    buffer ``[..., S*B, F]``."""
    s, b = send_idx.shape
    # gather the rows each peer needs: [..., S, B, F]
    send = jnp.take(x_local, send_idx.reshape(-1), axis=-2)
    send = send.reshape(x_local.shape[:-2] + (s, b, x_local.shape[-1]))
    recv = _exchange(send, axis, payload)
    return recv.reshape(x_local.shape[:-2] + (s * b,
                                              x_local.shape[-1]))


def _update_halo(ext, x_local, x_halo):
    """Advance the recv-buffer rows one hop IN-BUFFER (deep-halo plan):
    ``ext`` is the COO block over the concatenated
    ``[local (Nl) | buffer (S*B)]`` state. Rows past the still-exact
    horizon accumulate garbage (their dropped out-of-working-set
    in-edges) — by construction they are never read while exact."""
    esrc, edst, ew = ext
    z = jnp.concatenate([x_local, x_halo], axis=-2)
    z2 = jnp.moveaxis(z, -2, 0)
    msgs = z2[esrc] * ew.reshape((-1,) + (1,) * (z2.ndim - 1))
    y = jax.ops.segment_sum(msgs, edst,
                            num_segments=x_halo.shape[-2])
    return jnp.moveaxis(y, 0, -2).astype(x_halo.dtype)


def _hier_exchange(x_local, hier_arrays, meta, axes, payload: str):
    """TWO-LEVEL exchange (``axes = (host, chip)``) of the boundary
    rows; returns the flat recv buffer ``[..., S*B, F]``:
    intra-host boundary rows ride an intra-host ``all_to_all``; cross-host
    rows ship ONCE per needing host between hosts (union-deduplicated,
    ``b_cross``-padded), then redistribute over an intra-host ``all_gather``;
    a precomputed index map rebuilds the flat recv layout for the
    unchanged ``_apply_halo``."""
    send_intra_idx, send_cross_idx, assemble_idx = hier_arrays
    c_per, h_num, b_intra, b_cross = meta
    host_ax, chip_ax = axes
    lead = x_local.shape[:-2]
    f = x_local.shape[-1]
    si = jnp.take(x_local, send_intra_idx.reshape(-1), axis=-2)
    si = si.reshape(lead + (c_per, b_intra, f))
    recv_i = _exchange(si, chip_ax, payload)         # [.., C, Bi, F]
    sc = jnp.take(x_local, send_cross_idx.reshape(-1), axis=-2)
    sc = sc.reshape(lead + (h_num, b_cross, f))
    # keep the COMPRESSED wire format through BOTH cross-host legs
    # (the inter-host all_to_all and the intra-host all_gather redistribution) —
    # dequantizing in between would ship f32 on the all_gather and
    # break the bytes-per-hop ledger's accounting
    ga = len(lead)
    sa = sc.ndim - 3
    if payload == "bfloat16":
        rq = jax.lax.all_to_all(sc.astype(jnp.bfloat16), host_ax,
                                split_axis=sa, concat_axis=sa)
        allc = jax.lax.all_gather(rq, chip_ax, axis=ga,
                                  tiled=False).astype(sc.dtype)
    elif payload == "int8":
        scale = jnp.maximum(jnp.max(jnp.abs(sc), axis=-1,
                                    keepdims=True), 1e-30)
        q = jnp.round(sc / scale * 127.0).astype(jnp.int8)
        rq = jax.lax.all_to_all(q, host_ax, split_axis=sa,
                                concat_axis=sa)
        rs = jax.lax.all_to_all(scale.astype(jnp.float32), host_ax,
                                split_axis=sa, concat_axis=sa)
        aq = jax.lax.all_gather(rq, chip_ax, axis=ga, tiled=False)
        asn = jax.lax.all_gather(rs, chip_ax, axis=ga, tiled=False)
        allc = (aq.astype(jnp.float32) * (asn / 127.0)).astype(sc.dtype)
    else:
        rq = jax.lax.all_to_all(sc, host_ax, split_axis=sa,
                                concat_axis=sa)
        allc = jax.lax.all_gather(rq, chip_ax, axis=ga, tiled=False)
    # allc: [.., C, H, Bc, F]
    buf = jnp.concatenate(
        [recv_i.reshape(lead + (c_per * b_intra, f)),
         allc.reshape(lead + (c_per * h_num * b_cross, f))], axis=-2)
    return jnp.take(buf, assemble_idx, axis=-2)      # [.., S*B, F]


def halo_khop(spec: HaloSpec, x: jnp.ndarray, mesh: Mesh, k: int = 1,
              axis="model", concat: bool = False) -> jnp.ndarray:
    """K-hop propagation of node-sharded ``x [..., N, F]`` using
    boundary-only exchange. Returns the k-th hop (or the
    ``[x, Ax, ..., A^k x]`` concat when ``concat=True``), node-sharded.

    Pads the node dim to ``S * Nl`` if needed (pad rows of ``A`` are
    zero, so padded outputs are zero and sliced off)."""
    n = spec.num_nodes
    n_pad_total = spec.n_shards * spec.nodes_per_shard
    permute_here = spec.perm is not None
    if permute_here:
        # the plan was built under a reordering (e.g. RCM): permute in,
        # un-permute out — one [N, F] gather each way per CALL (not per
        # hop), amortized over the k hops. A pre-padded input (e.g.
        # from shard_nodes) is NATURAL-ordered with zero pad rows, so
        # the permutation extends with identity on the padding —
        # silently skipping it would run the plan's reordered blocks
        # on natural-ordered data (wrong results).
        perm = spec.perm
        if x.shape[-2] != n:
            if x.shape[-2] != n_pad_total:
                raise ValueError(
                    f"halo_khop: input node dim {x.shape[-2]} matches "
                    f"neither N={n} nor the plan's padded "
                    f"{n_pad_total} (reordered plan — cannot infer "
                    "the node order of this input)")
            perm = np.concatenate(
                [perm, np.arange(n, x.shape[-2], dtype=perm.dtype)])
        x = jnp.take(x, jnp.asarray(perm), axis=-2)
    n_pad = n_pad_total
    padded_here = x.shape[-2] == n and n_pad != n
    if padded_here:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, n_pad - n), (0, 0)]
        x = jnp.pad(x, pad)
    hierarchical = isinstance(axis, (tuple, list)) and len(axis) == 2
    if hierarchical:
        axis = tuple(axis)
    node_spec = P(*([None] * (x.ndim - 2)), axis, None)
    mode = spec.mode
    payload = spec.payload_dtype
    if hierarchical and spec.hier is None:
        raise ValueError(
            "axes=(host, chip) needs a plan built with chips_per_host "
            "(build_halo_spec(..., chips_per_host=C))")
    hier_arrays = spec.hier[:3] if hierarchical else ()
    hier_meta = spec.hier[3:] if hierarchical else None
    depth = max(1, spec.depth)

    def local_fn(local, halo, send_idx, hier_arr, ext, x_local):
        local = tuple(a[0] for a in local)
        halo = tuple(a[0] for a in halo)
        send_idx = send_idx[0]
        hier_arr = tuple(a[0] for a in hier_arr)
        ext = tuple(a[0] for a in ext)
        outs = [x_local]
        x_halo = None
        for t in range(k):
            if t % depth == 0:
                # collective: fill the buffer with exact level-t rows
                x_halo = (_hier_exchange(outs[-1], hier_arr, hier_meta,
                                         tuple(axis), payload)
                          if hierarchical else
                          _flat_exchange(outs[-1], send_idx, axis,
                                         payload))
            else:
                # deep halo: advance the buffer in place of a
                # collective (level t-1 state -> level t halo rows)
                x_halo = _update_halo(ext, outs[-2], x_halo)
            # local block matmul (overlaps the collective under XLA
            # scheduling)
            out = _apply_local(mode, local, outs[-1])
            outs.append(out + _apply_halo(mode, halo, x_halo,
                                          outs[-1].shape[-2]))
        if concat:
            return jnp.concatenate(outs, -1)
        return outs[-1]

    shard_p = P(tuple(axis)) if hierarchical else P(axis)
    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(tuple(shard_p for _ in spec.local),
                  tuple(shard_p for _ in spec.halo),
                  shard_p, tuple(shard_p for _ in hier_arrays),
                  tuple(shard_p for _ in spec.ext),
                  node_spec),
        out_specs=node_spec, check_vma=False)
    out = fn(spec.local, spec.halo, spec.send_idx, hier_arrays,
             spec.ext, x)
    if padded_here:
        out = out[..., :n, :]
    if permute_here:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        out = jnp.take(out, jnp.asarray(inv), axis=-2)
    return out


def shard_nodes(x: jnp.ndarray, mesh: Mesh, axis="data",
                node_axis: int = -2) -> jnp.ndarray:
    """Place ``x`` on the mesh sharded along its node axis (pads the
    node dim to a multiple of the axis size if needed). ``axis`` may
    be a tuple of mesh axes (e.g. ``('host', 'chip')`` for the
    two-level halo exchange)."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        size = int(np.prod([mesh.shape[a] for a in axis]))
    else:
        size = mesh.shape[axis]
    nd = node_axis % x.ndim
    n = x.shape[nd]
    n_pad = -(-n // size) * size
    if n_pad != n:
        pad = [(0, 0)] * x.ndim
        pad[nd] = (0, n_pad - n)
        x = jnp.pad(x, pad)
    spec = [None] * x.ndim
    spec[nd] = axis
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))
