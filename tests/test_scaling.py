"""Scaling harness smoke + hyperopt + run logger."""
import json
import numpy as np
import pytest

import jax

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.obs.scaling import propagation_scaling
from sgp.exp.hyperopt import grid_trials, random_trials, run_search
from sgp.obs.run_logger import RunLogger

pytestmark = pytest.mark.slow


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_propagation_scaling_runs(rng):
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, 256, 4000), rng.integers(0, 256, 4000),
        rng.random(4000).astype(np.float32), 256)), "row")
    out = propagation_scaling(g, feat=64, k=2, n_devices=8)
    assert out["edges_per_s_single"] > 0
    assert out["edges_per_s_halo"] > 0
    assert out["edges_per_s_allgather"] > 0
    assert 0 < out["halo_comm_fraction"]
    # a random graph has a dense boundary, so just sanity-bound it
    assert out["halo_bytes_per_hop_per_device"] <= \
        8 * out["allgather_bytes_per_hop_per_device"]


def test_hyperopt_grid_and_random():
    space = {"lr": [0.1, 0.01], "h": [8, 16]}
    assert len(grid_trials(space)) == 4
    trials = random_trials(space, 5, seed=1)
    assert len(trials) == 5
    assert all(t["lr"] in space["lr"] for t in trials)


def test_run_search_picks_best(tmp_path):
    def run_fn(cfg):
        if cfg["h"] == 13:
            raise RuntimeError("boom")  # swallowed like the reference
        return {"test_mae": abs(cfg["lr"] - 0.01) + cfg["h"] * 0.001}

    out = run_search(run_fn, {"h": 8}, {"lr": [0.1, 0.01, 0.001],
                                        "h": [8, 13]},
                     mode="grid", monitor="test_mae",
                     out_path=str(tmp_path / "hp.json"))
    assert out["best_config"]["lr"] == 0.01
    assert out["best_config"]["h"] == 8
    assert any("error" in t for t in out["trials"])
    assert (tmp_path / "hp.json").exists()


def test_run_logger(tmp_path):
    rl = RunLogger(str(tmp_path), prefix="train_")
    rl.log_metrics({"mae": 1.5}, step=3)
    rl.log_metrics({"mae": 1.2}, step=4)
    rl.close()
    lines = [json.loads(l) for l in
             open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert lines[0]["train_mae"] == 1.5
    assert lines[1]["_step"] == 4


def test_project_scaling_model():
    """The halo byte ledger: every multi-shard row moves bytes, the
    shipped bf16 plan moves fewer than the naive f32 flat one, and
    crossing hosts (two-level exchange) reports its cross-host share."""
    from sgp.obs.scaling import comm_ledger
    from tests.test_halo import ring_graph

    g = ring_graph(n=4096, width=4)
    led = comm_ledger(g, feat=128, n_shards_list=(8, 32),
                      chips_per_host=8)
    for s in ("8", "32"):
        p = led[s]
        assert p["comm_bytes_per_hop"] > 0
        assert p["comm_bytes_per_hop"] <= \
            p["comm_bytes_per_hop_naive_f32_flat"]
    assert "cross_host_bytes_per_hop" not in led["8"]
    assert 0 < led["32"]["cross_host_bytes_per_hop"] \
        <= led["32"]["comm_bytes_per_hop"]


def test_morton_order_and_projection_orders():
    """morton_order yields compact tiles (smaller cross-host unions
    than natural order on a geometric graph) and comm_ledger accepts
    explicit permutations."""
    import numpy as np
    from sgp.graph import Graph, coalesce, normalize_adj
    from sgp.graph.sparse import morton_order
    from sgp.graph.similarities import top_k
    from sgp.obs.scaling import comm_ledger, host_boundary_ledger

    rng = np.random.default_rng(5)
    n = 2048                 # 64 nodes/shard at 32 shards: tiles are
    pos = rng.random((n, 2)).astype(np.float32)   # genuinely compact
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    sim = np.exp(-d2 / 0.02)
    np.fill_diagonal(sim, 0)
    g = normalize_adj(coalesce(Graph.from_dense(
        top_k(sim, 12, keep_values=True))), "row")
    perm = morton_order(pos)
    assert sorted(perm.tolist()) == list(range(n))
    led_nat = host_boundary_ledger(g, 32, chips_per_host=8)
    led_mor = host_boundary_ledger(g, 32, chips_per_host=8, order=perm)
    assert led_mor["b_cross"] < led_nat["b_cross"]
    p = comm_ledger(g, 128, n_shards_list=(32,), order=perm)
    assert p["32"]["comm_bytes_per_hop"] > 0


def test_project_scaling_depth_road_graph():
    """Deep halo in the ledger: on a low-degree banded (road network)
    graph a depth-d exchange ships a d-row-deep boundary once per d
    hops, so the amortized bytes per hop stay within the depth-1
    exchange's while the collectives drop d-fold."""
    from sgp.graph.sparse import band_graph
    from sgp.obs.scaling import comm_ledger

    g = band_graph(52000, 4)
    rows = []
    for depth in (1, 2, 4):
        p = comm_ledger(g, 128, n_shards_list=(32,), order="natural",
                        depth=depth)["32"]
        assert p["depth"] == depth
        rows.append(p)
    for p in rows[1:]:
        assert 0 < p["comm_bytes_per_hop"] <= \
            1.01 * rows[0]["comm_bytes_per_hop"]
