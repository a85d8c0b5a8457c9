"""Boundary halo-exchange propagation (SURVEY.md §5.8): node-sharded
K-hop == single-device dense result; exchanged bytes ≪ full all-gather
on a localized graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.ops import build_operator
from sgp.parallel import make_mesh
from sgp.parallel.halo import build_halo_spec, halo_khop, shard_nodes

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def random_graph(rng, n=40, e=300):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def ring_graph(n=64, width=2):
    """A banded (localized) graph: node i connects to i±1..width."""
    src, dst = [], []
    for i in range(n):
        for d in range(1, width + 1):
            src += [i, i]
            dst += [(i + d) % n, (i - d) % n]
    return normalize_adj(coalesce(Graph(
        np.array(src), np.array(dst),
        np.ones(len(src), np.float32), n)), "row")


@pytest.mark.parametrize("n,k,mesh_shape", [(40, 1, (1, 4)), (37, 2, (2, 4)),
                                            (64, 3, (1, 8))])
def test_halo_khop_matches_dense(rng, n, k, mesh_shape):
    g = random_graph(rng, n=n)
    mesh = make_mesh(*mesh_shape)
    axis = "model"
    spec = build_halo_spec(g, mesh.shape[axis])
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 16)).astype(np.float32))
    expect = np.asarray(x)
    for _ in range(k):
        expect = np.asarray(op @ jnp.asarray(expect))
    xs = shard_nodes(x, mesh, axis)
    with mesh:
        out = halo_khop(spec, xs, mesh, k=k, axis=axis)
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=1e-5)


def test_halo_khop_batched_and_concat(rng):
    g = random_graph(rng, n=32)
    mesh = make_mesh(1, 8)
    spec = build_halo_spec(g, 8)
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((5, 32, 8)).astype(np.float32))
    h1 = op @ x
    expect = np.concatenate([np.asarray(x), np.asarray(h1),
                             np.asarray(op @ h1)], -1)
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out = halo_khop(spec, xs, mesh, k=2, axis="model", concat=True)
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)


def test_halo_bytes_much_less_than_allgather():
    """On a banded graph each shard only needs a handful of boundary
    rows — the point of halo exchange over full all-gather."""
    g = ring_graph(n=256, width=2)
    spec = build_halo_spec(g, 8)
    feat = 128
    assert spec.bytes_per_hop(feat) < spec.dense_gather_bytes(feat) / 4
    # per-pair boundary counts: only adjacent shards talk, few rows
    assert spec.b_max <= 4
    off = spec.boundary_counts.copy()
    for i in range(8):
        off[i, i] = 0
        off[i, (i + 1) % 8] = 0
        off[i, (i - 1) % 8] = 0
    assert off.sum() == 0  # no exchange beyond adjacent shards


def test_halo_correct_output_sharding(rng):
    g = random_graph(rng, n=48)
    mesh = make_mesh(1, 8)
    spec = build_halo_spec(g, 8)
    x = jnp.asarray(rng.standard_normal((48, 8)).astype(np.float32))
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out = halo_khop(spec, xs, mesh, k=1, axis="model")
    assert len(out.addressable_shards) == 8


def test_halo_spec_fuzz_matches_dense(rng):
    """Seeded fuzz over graph sizes/densities/shard counts (incl.
    explicit zero-weight edges, ragged tails, empty cross-blocks): the
    CSR-built halo plan always reproduces dense K-hop propagation."""
    for trial in range(12):
        n = int(rng.integers(5, 49))
        e = int(rng.integers(n, 6 * n))
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        w = rng.random(e).astype(np.float32)
        w[rng.random(e) < 0.15] = 0.0          # stored zeros
        g = normalize_adj(coalesce(Graph(src, dst, w, n)), "row")
        shards = int(rng.choice([2, 4, 8]))
        k = int(rng.integers(1, 4))
        mesh = make_mesh(8 // shards, shards)
        spec = build_halo_spec(g, shards)
        x = rng.standard_normal((6, n, 3)).astype(np.float32)
        op = build_operator(g, "dense")
        expect = jnp.asarray(x)
        outs = []
        for _ in range(k):
            expect = op @ expect
            outs.append(expect)
        expect = np.asarray(jnp.concatenate(outs, -1))
        xs = shard_nodes(jnp.asarray(x), mesh, "model")
        with mesh:
            got = halo_khop(spec, xs, mesh, k=k, axis="model",
                            concat=True)
        got = np.asarray(got)[:, :n, x.shape[-1]:]   # drop input block
        np.testing.assert_allclose(got, expect, atol=3e-5,
                                   err_msg=f"trial={trial} n={n} "
                                           f"shards={shards} k={k}")


@pytest.mark.parametrize("mode", ["bsr", "coo"])
def test_halo_sparse_modes_match_dense(rng, mode):
    """The sparse per-shard representations reproduce the dense-mode
    result exactly (same plan, different block storage)."""
    g = random_graph(rng, n=100, e=900)
    mesh = make_mesh(1, 8)
    spec_d = build_halo_spec(g, 8, mode="dense")
    spec_s = build_halo_spec(g, 8, mode=mode)
    x = jnp.asarray(rng.standard_normal((100, 16)).astype(np.float32))
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out_d = halo_khop(spec_d, xs, mesh, k=2, axis="model")
        # sparse modes pad Nl up (bsr rounds to 128) -> re-shard
        xs2 = shard_nodes(
            jnp.pad(x, ((0, spec_s.n_shards * spec_s.nodes_per_shard
                         - 100), (0, 0))), mesh, "model")
        out_s = halo_khop(spec_s, xs2, mesh, k=2, axis="model")
    np.testing.assert_allclose(np.asarray(out_s)[:100],
                               np.asarray(out_d)[:100], atol=1e-5)


def test_halo_bsr_large_n():
    """The sparse halo plan
    builds and runs at N=131072 on the 8-device mesh with per-device
    plan memory O(E/S) — the dense plan would need
    O((N/S)^2)=1 GB/device; the BSR plan stays under 3x the raw edge
    bytes. Parity vs the host CSR K-hop on a banded (RCM-like) graph."""
    n, width = 131072, 96
    rng = np.random.default_rng(0)
    # banded graph: each node talks to ~8 random neighbors within the
    # band (what RCM ordering produces on real meshes)
    e = n * 8
    src = rng.integers(0, n, e)
    off = rng.integers(-width, width + 1, e)
    dst = np.clip(src + off, 0, n - 1)
    g = normalize_adj(coalesce(Graph(
        src, dst, rng.random(e).astype(np.float32), n)), "row")
    spec = build_halo_spec(g, 8, mode="bsr")
    assert spec.mode == "bsr"
    # plan memory per device: O(E/S) not O((N/S)^2)
    dense_plan = (spec.nodes_per_shard ** 2) * 4
    assert spec.plan_bytes_per_device() < dense_plan / 10
    mesh = make_mesh(1, 8)
    feat = 8
    x = rng.standard_normal((n, feat)).astype(np.float32)
    xs = shard_nodes(jnp.asarray(x), mesh, "model")
    with mesh:
        out = np.asarray(halo_khop(spec, xs, mesh, k=2, axis="model"))
    csr = g.to_scipy().tocsr()
    expect = csr @ (csr @ x)
    np.testing.assert_allclose(out[:n], expect, atol=2e-4)


@pytest.mark.parametrize("payload,atol", [("bfloat16", 2e-2),
                                          ("int8", 8e-2)])
def test_halo_payload_compression(rng, payload, atol):
    """Compressed wire formats (bf16 / per-row-absmax int8): the halo
    contribution quantizes but the local block stays exact; the ledger
    reports the smaller bytes."""
    g = random_graph(rng, n=48, e=400)
    mesh = make_mesh(1, 8)
    spec_f = build_halo_spec(g, 8)
    spec_q = build_halo_spec(g, 8, payload_dtype=payload)
    assert spec_q.bytes_per_hop(16) < spec_f.bytes_per_hop(16)
    x = jnp.asarray(rng.standard_normal((48, 16)).astype(np.float32))
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out_f = halo_khop(spec_f, xs, mesh, k=2, axis="model")
        out_q = halo_khop(spec_q, xs, mesh, k=2, axis="model")
    np.testing.assert_allclose(np.asarray(out_q)[:48],
                               np.asarray(out_f)[:48], atol=atol)


def test_halo_rcm_order_parity_and_cut(rng):
    """order='rcm' reproduces the natural-order result EXACTLY (the
    permutation is applied/undone inside halo_khop) and shrinks b_max
    on a shuffled banded graph back to the banded boundary."""
    n = 128
    g_band = ring_graph(n=n, width=2)
    shuffle = np.random.default_rng(3).permutation(n)
    from sgp.graph.sparse import permute_nodes
    g = normalize_adj(coalesce(permute_nodes(g_band, shuffle)), "row")
    mesh = make_mesh(1, 8)
    spec_nat = build_halo_spec(g, 8)
    spec_rcm = build_halo_spec(g, 8, order="rcm")
    # the shuffled graph has near-worst-case boundaries; RCM recovers
    # a banded order
    assert spec_rcm.b_max <= spec_nat.b_max // 2
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out_nat = halo_khop(spec_nat, xs, mesh, k=2, axis="model")
        out_rcm = halo_khop(spec_rcm, xs, mesh, k=2, axis="model")
    np.testing.assert_allclose(np.asarray(out_rcm)[:n],
                               np.asarray(out_nat)[:n], atol=1e-5)


def test_halo_hierarchical_two_level(rng):
    """The (host, chip) two-level exchange == flat all_to_all == dense
    oracle, on a 2x4 mesh; the DCN ledger beats the flat one on a
    banded graph."""
    from jax.sharding import Mesh
    n = 96
    g = ring_graph(n=n, width=3)
    spec = build_halo_spec(g, 8, chips_per_host=4)
    assert spec.hier is not None
    # banded graph: cross-host traffic is the tiny host-boundary only
    assert spec.dcn_bytes_per_hop(16) < spec.bytes_per_hop(16) / 4
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("host", "chip"))
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((4, n, 16)).astype(np.float32))
    expect = np.asarray(op @ (op @ x))
    xs = shard_nodes(x, mesh, ("host", "chip"))
    with mesh:
        out = halo_khop(spec, xs, mesh, k=2, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(out)[:, :n], expect,
                               atol=1e-5)


def test_halo_hierarchical_random_graph(rng):
    """Two-level exchange parity on a NON-localized random graph (every
    shard pair talks, unions genuinely dedup) + bf16 payload compose."""
    from jax.sharding import Mesh
    n = 64
    g = random_graph(rng, n=n, e=700)
    spec = build_halo_spec(g, 8, chips_per_host=4,
                           payload_dtype="bfloat16")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("host", "chip"))
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    expect = np.asarray(op @ x)
    xs = shard_nodes(x, mesh, ("host", "chip"))
    with mesh:
        out = halo_khop(spec, xs, mesh, k=1, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=2e-2)


def test_project_scaling_hierarchical_improves():
    """The shipped plan (RCM + bf16 + two-level exchange) must ship
    fewer bytes between hosts per hop than the naive ledger (f32
    payload, flat all_to_all, natural order) moves in all."""
    from sgp.obs.scaling import comm_ledger, host_boundary_ledger
    g = ring_graph(n=2048, width=16)
    old = comm_ledger(g, 128, n_shards_list=(32,), order="natural",
                      payload_dtype="float32", hierarchical=False)["32"]
    new = comm_ledger(g, 128, n_shards_list=(32,), chips_per_host=8)["32"]
    assert new["cross_host_bytes_per_hop"] < old["comm_bytes_per_hop"]
    assert new["comm_bytes_per_hop"] < \
        new["comm_bytes_per_hop_naive_f32_flat"]
    assert new["cross_host_bytes_per_hop"] > 0
    led = host_boundary_ledger(g, 32, chips_per_host=8)
    assert led["hosts"] == 4 and led["b_cross"] > 0


def test_halo_rcm_padded_input_non_divisible_n(rng):
    """Regression (r5 review): an RCM-built plan fed a shard_nodes
    PRE-PADDED input (N not divisible by the shard count) must still
    apply the permutation — it was silently skipped, running reordered
    blocks on natural-ordered data."""
    n = 50                              # pads to 56 on 8 shards
    g = random_graph(rng, n=n, e=300)
    mesh = make_mesh(1, 8)
    spec = build_halo_spec(g, 8, order="rcm")
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    expect = np.asarray(op @ x)
    xs = shard_nodes(x, mesh, "model")   # [56, 8] padded natural order
    with mesh:
        out = halo_khop(spec, xs, mesh, k=1, axis="model")
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=1e-5)


def test_halo_hierarchical_single_host(rng):
    """Regression (r5 review): chips_per_host == n_shards (one host)
    must build a degenerate-but-valid two-level plan instead of
    raising."""
    from jax.sharding import Mesh
    n = 48
    g = random_graph(rng, n=n, e=400)
    spec = build_halo_spec(g, 8, chips_per_host=8)
    assert spec.hier is not None
    assert spec.dcn_bytes_per_hop(16) == 0      # H=1: no DCN leg
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8),
                ("host", "chip"))
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    expect = np.asarray(op @ x)
    xs = shard_nodes(x, mesh, ("host", "chip"))
    with mesh:
        out = halo_khop(spec, xs, mesh, k=1, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=1e-5)


def test_halo_hier_int8_payload(rng):
    """int8 payload through the two-level path (compressed on BOTH the
    DCN all_to_all and the ICI all_gather legs)."""
    from jax.sharding import Mesh
    n = 64
    g = ring_graph(n=n, width=3)
    spec_f = build_halo_spec(g, 8, chips_per_host=4)
    spec_q = build_halo_spec(g, 8, chips_per_host=4,
                             payload_dtype="int8")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("host", "chip"))
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    xs = shard_nodes(x, mesh, ("host", "chip"))
    with mesh:
        ref = halo_khop(spec_f, xs, mesh, k=1, axis=("host", "chip"))
        got = halo_khop(spec_q, xs, mesh, k=1, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(ref)[:n],
                               atol=8e-2)


def test_dense_adj_mask_drops_stored_zeros(rng):
    """Regression (r5 review): explicitly-stored zero weights are
    structure, not edges — parity with (to_dense() != 0)."""
    from sgp.ops.spmm import dense_adj_mask
    n = 12
    w = rng.random(40).astype(np.float32)
    w[::4] = 0.0
    g = Graph(rng.integers(0, n, 40), rng.integers(0, n, 40), w, n)
    mask = np.asarray(dense_adj_mask(g), np.float32)
    expect = (np.asarray(g.to_dense()) != 0).astype(np.float32)
    np.testing.assert_array_equal(mask, expect)


@pytest.mark.parametrize("mode", ["dense", "bsr", "coo"])
def test_deep_halo_matches_dense(rng, mode):
    """depth-d plans (one collective per d hops, in-buffer halo
    advance) == the dense oracle for every k/depth phase alignment,
    in all three operator representations."""
    n = 120
    g = random_graph(rng, n=n, e=900)
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    mesh = make_mesh(1, 8)
    for k in (2, 3, 5):
        expect = np.asarray(x)
        for _ in range(k):
            expect = np.asarray(op @ jnp.asarray(expect))
        for depth in (2, 3):
            spec = build_halo_spec(g, 8, mode=mode, depth=depth)
            if spec.boundary_counts.max() > 0:   # bsr pads 120->1 shard
                assert spec.ext_edges_max() > 0
            xs = shard_nodes(x, mesh, "model")
            with mesh:
                out = halo_khop(spec, xs, mesh, k=k, axis="model")
            np.testing.assert_allclose(np.asarray(out)[:n], expect,
                                       atol=1e-4)


def test_deep_halo_concat_rcm_and_payload(rng):
    """depth composes with concat=True (the encoder layout), an RCM
    node order, and the bf16 wire payload."""
    n = 96
    g = ring_graph(n=n, width=3)
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    hops = [np.asarray(x)]
    for _ in range(4):
        hops.append(np.asarray(op @ jnp.asarray(hops[-1])))
    expect = np.concatenate(hops, -1)
    mesh = make_mesh(1, 8)
    spec = build_halo_spec(g, 8, depth=4, order="rcm",
                           payload_dtype="bfloat16")
    xs = shard_nodes(x, mesh, "model")
    with mesh:
        out = halo_khop(spec, xs, mesh, k=4, axis="model",
                        concat=True)
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=5e-2)


def test_deep_halo_hierarchical(rng):
    """depth composes with the two-level (host, chip) exchange: the
    spec's need sets (and so the hier plan) are the depth-d closure."""
    from jax.sharding import Mesh
    n = 96
    g = ring_graph(n=n, width=2)
    spec1 = build_halo_spec(g, 8, chips_per_host=4)
    spec2 = build_halo_spec(g, 8, chips_per_host=4, depth=2)
    assert spec2.b_max >= spec1.b_max     # deeper boundary
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    expect = np.asarray(op @ (op @ x))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("host", "chip"))
    xs = shard_nodes(x, mesh, ("host", "chip"))
    with mesh:
        out = halo_khop(spec2, xs, mesh, k=2, axis=("host", "chip"))
    np.testing.assert_allclose(np.asarray(out)[:n], expect, atol=1e-5)


def test_deep_halo_sharded_encode(rng):
    """encode_series_sharded(halo_depth=k) == halo_depth=1 (exact —
    local rows are exact at every hop of the deep plan)."""
    from sgp.parallel.encode import encode_series_sharded

    class _Res:
        def __call__(self, x, out_dtype=None):
            return x * 0.5 + 0.1

    n, t, f = 64, 6, 8
    g = ring_graph(n=n, width=2)
    x = rng.standard_normal((t, n, f)).astype(np.float32)
    mesh = make_mesh(1, 8)
    with mesh:
        ref = np.asarray(encode_series_sharded(
            _Res(), x, g, mesh, k=3, axis="model"))
        got = np.asarray(encode_series_sharded(
            _Res(), x, g, mesh, k=3, axis="model", halo_depth=3))
    np.testing.assert_allclose(got, ref, atol=1e-5)
