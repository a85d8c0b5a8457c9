"""Multi-device scaling harness.

Measures K-hop propagation throughput at 1 device vs N devices on
whatever mesh is available (the four GPUs of one host; the 8-device
virtual CPU mesh in CI), and counts the bytes the node-sharded halo
exchange moves per hop (the reference has no distributed mode to
compare against).
"""
from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from sgp.graph.sparse import Graph
from sgp.ops.spmm import build_operator
from sgp.parallel import make_mesh, shard_operator, sharded_spmm


def _time(fn, *args, iters=20) -> float:
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def host_boundary_ledger(g: Graph, n_shards: int, chips_per_host: int,
                         order: str = "natural") -> Dict[str, int]:
    """Boundary sizes of the HIERARCHICAL halo exchange (see
    ``parallel/halo.py::halo_khop`` two-level path): per contiguous
    1-D partition of ``n_shards`` shards grouped ``chips_per_host`` per
    host, returns

    - ``b_intra``: max rows any shard needs from a SAME-host peer
      (the intra-host ``all_to_all``);
    - ``b_cross``: max rows any (source shard, remote HOST) pair ships
      between hosts — the union over the host's shards, i.e. each
      boundary row crosses hosts ONCE per needing host instead of once
      per needing device (the flat ``all_to_all`` additionally pads
      every one of the S-1 peer slots to the global ``b_max``).
    """
    from sgp.graph.sparse import permute_nodes, rcm_order
    if isinstance(order, np.ndarray):
        g = permute_nodes(g, order)
    elif order == "rcm":
        g = permute_nodes(g, rcm_order(g))
    n, s = g.num_nodes, n_shards
    nl = -(-n // s)
    csr = g.to_scipy().tocsr()
    hosts = -(-s // chips_per_host)
    b_intra = 0
    # (source shard j, dest host H) -> union of boundary rows of j that
    # any shard of H needs — what j ships to H ONCE
    need_by_pair: Dict[tuple, set] = {}
    for i in range(s):
        rows = csr[i * nl:min((i + 1) * nl, n)].tocsc()
        hi = i // chips_per_host
        for j in range(s):
            if j == i:
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            nz = np.unique(block.col[block.data != 0])
            if j // chips_per_host == hi:
                b_intra = max(b_intra, len(nz))
            else:
                need_by_pair.setdefault((j, hi), set()).update(
                    nz.tolist())
    b_cross = max((len(v) for v in need_by_pair.values()), default=0)
    return {"b_intra": int(b_intra), "b_cross": int(b_cross),
            "hosts": hosts}


def comm_ledger(g: Graph, feat: int, n_shards_list=(8, 32),
                chips_per_host: int = None, itemsize: int = None,
                order: str = "rcm", payload_dtype: str = "bfloat16",
                hierarchical: bool = True,
                depth: int = 1) -> Dict[str, dict]:
    """Bytes the node-sharded K-hop halo exchange moves per device and
    hop, for each shard count, from the halo plan itself
    (``build_halo_spec``). ``order='rcm'`` + ``payload_dtype='bfloat16'``
    are the shipped plan defaults; each row carries the naive ledger
    (f32 payload, flat ``all_to_all``, depth 1) next to the effective
    one so the saving is auditable. With ``chips_per_host`` and
    ``hierarchical``, shard counts spanning several hosts use the
    two-level exchange: boundary rows cross hosts once per (source
    shard, needing host), then redistribute within the host
    (``cross_host_bytes_per_hop``). ``depth`` (deep halo) exchanges a
    depth-d boundary once per d hops; ``comm_bytes_per_hop`` is
    amortized (bytes per exchange / d)."""
    from sgp.parallel.halo import build_halo_spec

    out = {}
    for s in n_shards_list:
        use_hier = (hierarchical and chips_per_host is not None
                    and s > chips_per_host and s % chips_per_host == 0)
        spec = build_halo_spec(
            g, s, order=order, payload_dtype=payload_dtype,
            depth=depth, mode="coo", host_only=True,
            chips_per_host=(chips_per_host if use_hier else None))
        per_row = (feat * spec.payload_itemsize()
                   + (4 if payload_dtype == "int8" else 0)) \
            if itemsize is None else feat * itemsize
        d = max(1, depth)
        row = {"comm_bytes_per_hop": int(s * spec.b_max * per_row / d),
               "comm_bytes_per_hop_naive_f32_flat":
                   int(s * spec.b_max_hop1 * feat * 4),
               "boundary_b_max": spec.b_max, "depth": d}
        if use_hier:
            # read b_intra/b_cross from the spec's own two-level plan
            # (depth-consistent boundary sets)
            _, _, _, c, hosts, b_intra, b_cross = spec.hier
            cross = (hosts - 1) * b_cross * per_row
            intra = (c - 1) * b_intra * per_row \
                + (c - 1) * (hosts - 1) * b_cross * per_row
            row.update(comm_bytes_per_hop=int((cross + intra) / d),
                       cross_host_bytes_per_hop=int(cross / d),
                       b_cross_host=int(b_cross))
        out[str(s)] = row
    return out


def propagation_scaling(g: Graph, feat: int = 128, k: int = 2,
                        n_devices: int = None) -> Dict[str, float]:
    """edges/s of K-hop propagation single-device vs node-sharded over
    the mesh (boundary halo exchange), plus the communication ledger:
    bytes exchanged per hop per device (``S * B_max * F``) vs what a
    full all-gather would move (``N * F``). Efficiency on a virtual CPU mesh measures sharding
    overhead (the devices share cores), on real chips speedup."""
    from sgp.parallel.halo import build_halo_spec, halo_khop, shard_nodes

    n_devices = n_devices or len(jax.devices())
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.standard_normal((g.num_nodes, feat)).astype(np.float32))
    op = build_operator(g, "dense", precision="default")

    @jax.jit
    def khop_single(x):
        cur = x
        for _ in range(k):
            cur = op @ cur
        return cur

    t_single = _time(khop_single, x)

    mesh = make_mesh(1, n_devices)
    spec = build_halo_spec(g, n_devices)
    xs = shard_nodes(x, mesh, "model")

    import dataclasses
    import functools

    # jit with the spec's device arrays threaded as ARGUMENTS (not
    # closure constants) so the trace is cached across the timed
    # iterations and the arrays never bake into the jaxpr.
    @functools.partial(jax.jit, donate_argnums=())
    def khop_halo_fn(local, halo, send_idx, xv):
        sp = dataclasses.replace(spec, local=local, halo=halo,
                                 send_idx=send_idx)
        return halo_khop(sp, xv, mesh, k=k, axis="model")

    with mesh:
        t_halo = _time(khop_halo_fn, spec.local, spec.halo,
                       spec.send_idx, xs)

    # legacy full-all-gather sharding, for the comparison ledger
    op_s = shard_operator(op, mesh)

    @jax.jit
    def khop_allgather(x):
        cur = x
        for _ in range(k):
            cur = sharded_spmm(op_s, cur, mesh)
        return cur

    with mesh:
        t_allgather = _time(khop_allgather, x)

    edges = g.num_edges * k
    return {
        "n_devices": n_devices,
        "edges_per_s_single": edges / t_single,
        "edges_per_s_halo": edges / t_halo,
        "edges_per_s_allgather": edges / t_allgather,
        "halo_over_single": t_single / t_halo,
        "halo_bytes_per_hop_per_device": spec.bytes_per_hop(feat),
        "allgather_bytes_per_hop_per_device":
            spec.dense_gather_bytes(feat),
        "halo_comm_fraction": spec.bytes_per_hop(feat)
            / max(spec.dense_gather_bytes(feat), 1),
        "boundary_b_max": spec.b_max,
    }
