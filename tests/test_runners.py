"""End-to-end runner smoke tests on tiny synthetic data (CPU): the
fused traffic path (fused train + one-dispatch fused val/test eval) and
the large-scale IID path (device-resident encode + fused IID train +
fused test eval)."""
import numpy as np

from sgp.exp.common import Experiment
import pytest

pytestmark = pytest.mark.slow


def _run(run_experiment, configure_parser, argv):
    return Experiment(run_experiment, configure_parser()).run(argv)


BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
        "--synthetic-steps", "160", "--epochs", "2",
        "--batches-epoch", "2", "--reservoir-size", "4",
        "--mlp-size", "8", "--hidden-size", "16", "--batch-size", "8",
        "--seed", "0", "--patience", "5"]


def test_traffic_runner_fused_eval():
    from sgp.exp.run_traffic_sgp import (configure_parser,
                                         run_experiment)
    res = _run(run_experiment, configure_parser,
               BASE + ["--fused", "true"])
    assert np.isfinite(res["test_mae"])
    assert np.isfinite(res["test_mse"])


def test_largescale_runner_fused_eval():
    from sgp.exp.run_largescale_sgp import (configure_parser,
                                            run_experiment)
    res = _run(run_experiment, configure_parser, list(BASE))
    assert np.isfinite(res["test_mae"])


def test_largescale_runner_stratified():
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)
    res = _run(run_experiment, configure_parser,
               BASE + ["--iid-stratified", "true"])
    assert np.isfinite(res["test_mae"])


def test_largescale_runner_streaming_packed_matches_fallback():
    """The streaming-packed encode path (packed layout emitted straight
    from one fused program; unpacked encoding never stored) must engage
    by default and reproduce the encode_dataset fallback's metrics
    (same bf16 features, bit-exact packed targets)."""
    import io
    import logging

    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    logging.getLogger("sgp").addHandler(handler)
    try:
        base = BASE + ["--batches-epoch", "4"]
        r1 = _run(run_experiment, configure_parser, list(base))
        assert "Streaming packed encode" in buf.getvalue()
        # same bf16 encoding via encode_dataset, unpacked gathers —
        # isolates the streaming/packed CODE PATH (not the precision)
        r2 = _run(run_experiment, configure_parser,
                  base + ["--packed-gather", "false"])
        # and the f32-encoding fallback stays in the same ballpark
        r3 = _run(run_experiment, configure_parser,
                  base + ["--encode-dtype", "float32"])
    finally:
        logging.getLogger("sgp").removeHandler(handler)
    assert abs(r1["test_mae"] - r2["test_mae"]) < 2e-3 * r2["test_mae"]
    assert abs(r1["test_mae"] - r3["test_mae"]) < 0.05 * r3["test_mae"]


def test_largescale_runner_vmapped_search():
    """--search-lr/--search-seeds trains all trials in one vmapped
    program, selects on fused val MAE, reports the winner's test
    metrics plus the per-trial table."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    res = _run(run_experiment, configure_parser,
               BASE + ["--search-lr", "0.01,0.001",
                       "--search-seeds", "0,1"])
    assert len(res["trials"]) == 4
    assert len(res["val_mae_per_trial"]) == 4
    assert {"lr": res["best_lr"], "seed": res["best_seed"]} in res["trials"]
    assert np.isfinite(res["test_mae"])


def test_largescale_runner_checkpoint_resume(tmp_path):
    """Interrupted-then-resumed training reproduces the uninterrupted
    run exactly (same RNG stream, best-so-far restored)."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    ck = str(tmp_path / "state.ckpt")
    full = _run(run_experiment, configure_parser,
                BASE + ["--epochs", "4"])
    _run(run_experiment, configure_parser,
         BASE + ["--epochs", "2", "--checkpoint-every", "1",
                 "--checkpoint-path", ck])
    resumed = _run(run_experiment, configure_parser,
                   BASE + ["--epochs", "4", "--checkpoint-every", "1",
                           "--checkpoint-path", ck, "--resume", "true"])
    np.testing.assert_allclose(resumed["test_mae"], full["test_mae"],
                               rtol=1e-6)


def test_stratified_runner_checkpoint_resume(tmp_path):
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    ck = str(tmp_path / "state.ckpt")
    base = BASE + ["--iid-stratified", "true"]
    full = _run(run_experiment, configure_parser, base + ["--epochs", "4"])
    _run(run_experiment, configure_parser,
         base + ["--epochs", "2", "--checkpoint-every", "1",
                 "--checkpoint-path", ck])
    resumed = _run(run_experiment, configure_parser,
                   base + ["--epochs", "4", "--checkpoint-every", "1",
                           "--checkpoint-path", ck, "--resume", "true"])
    np.testing.assert_allclose(resumed["test_mae"], full["test_mae"],
                               rtol=1e-6)


def test_resume_guards(tmp_path):
    """Resuming under different training hparams, or combining the
    vmapped search with checkpointing/stratified, fails loudly."""
    import pytest

    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    ck = str(tmp_path / "s.ckpt")
    _run(run_experiment, configure_parser,
         BASE + ["--epochs", "1", "--checkpoint-every", "1",
                 "--checkpoint-path", ck])
    with pytest.raises(ValueError, match="train config mismatch"):
        _run(run_experiment, configure_parser,
             BASE + ["--epochs", "2", "--checkpoint-every", "1",
                     "--checkpoint-path", ck, "--resume", "true",
                     "--lr", "0.01"])
    with pytest.raises(ValueError, match="not supported"):
        _run(run_experiment, configure_parser,
             BASE + ["--search-lr", "0.01", "--checkpoint-every", "1"])
    with pytest.raises(ValueError, match="not supported"):
        _run(run_experiment, configure_parser,
             BASE + ["--search-lr", "0.01", "--iid-stratified", "true"])


def test_largescale_runner_data_sharding_nodes():
    """--data-sharding nodes runs the node-sharded step + eval over the
    8-device CPU mesh for BOTH encode paths (streaming-packed prebuilt
    layout and the unpacked fallback)."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    r1 = _run(run_experiment, configure_parser,
              BASE + ["--data-sharding", "nodes"])
    assert r1["data_sharding"] == "nodes"
    assert np.isfinite(r1["test_mae"])
    r2 = _run(run_experiment, configure_parser,
              BASE + ["--data-sharding", "nodes",
                      "--packed-gather", "false"])
    assert np.isfinite(r2["test_mae"])
    # same data/model family: the two paths land in the same ballpark
    assert abs(r1["test_mae"] - r2["test_mae"]) < 0.25 * r2["test_mae"]


def test_largescale_runner_vmapped_search_with_exog():
    """Vmapped search with node-level exogenous (keep_raw adds the
    scaled raw series as u): exercises the u plumbing through the
    stacked init, the shared-batch step and the stacked eval."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    res = _run(run_experiment, configure_parser,
               BASE + ["--search-lr", "0.01,0.001",
                       "--keep-raw", "true"])
    assert len(res["trials"]) == 2
    assert np.isfinite(res["test_mae"])


def test_stratified_runner_data_sharding_nodes():
    """--iid-stratified + --data-sharding nodes: the node-sharded
    beyond-HBM trainer and the support-ops sharded eval run end to end
    on the CPU mesh."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    res = _run(run_experiment, configure_parser,
               BASE + ["--iid-stratified", "true",
                       "--data-sharding", "nodes"])
    assert res["data_sharding"] == "nodes"
    assert np.isfinite(res["test_mae"])


def test_largescale_runner_data_sharding_multistep_window():
    """window>1 can't use packed-lane targets: the nodes-sharded eval
    falls back to explicit (still sharded) target/mask arrays instead
    of dying after training."""
    from sgp.exp.run_largescale_sgp import (
        configure_parser_largescale as configure_parser, run_experiment)

    res = _run(run_experiment, configure_parser,
               BASE + ["--data-sharding", "nodes", "--window", "2"])
    assert np.isfinite(res["test_mae"])


def test_traffic_runner_data_sharding_batch():
    """--data-sharding batch on the traffic path: DP fused windowed
    training over the 8-device CPU mesh runs end to end."""
    from sgp.exp.run_traffic_sgp import (configure_parser,
                                         run_experiment)

    res = _run(run_experiment, configure_parser,
               BASE + ["--fused", "true", "--data-sharding", "batch"])
    assert np.isfinite(res["test_mae"])
    assert np.isfinite(res["test_mse"])


def test_traffic_baselines_runner_dp():
    """Loader-based baseline training under the generic Predictor DP
    mesh (--data-sharding batch): full pipeline on the 8-device mesh."""
    from sgp.exp.run_traffic_baselines import (configure_parser,
                                               run_experiment)

    res = _run(run_experiment, configure_parser,
               ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
                "--synthetic-steps", "160", "--epochs", "2",
                "--batches-epoch", "2", "--hidden-size", "8",
                "--ff-size", "8", "--batch-size", "8", "--window", "4",
                "--horizon", "3", "--seed", "0", "--patience", "5",
                "--model-name", "rnn", "--data-sharding", "batch"])
    assert np.isfinite(res["test_mae"])


def test_largescale_baselines_runner_dp():
    """Subgraph-sampled GNN baseline under the Predictor DP mesh:
    shared per-batch subgraph arrays replicate, sample tensors shard."""
    from sgp.exp.run_largescale_baselines import run_experiment
    from sgp.exp.run_traffic_baselines import configure_parser

    res = _run(run_experiment, configure_parser,
               ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
                "--synthetic-steps", "160", "--epochs", "2",
                "--batches-epoch", "2", "--hidden-size", "8",
                "--ff-size", "8", "--batch-size", "8", "--window", "4",
                "--horizon", "3", "--seed", "0", "--patience", "5",
                "--model-name", "gatedgn", "--num-subgraph-nodes", "6",
                "--subgraph-k", "1", "--max-edges", "64",
                "--data-sharding", "batch"])
    assert np.isfinite(res["test_mae"])


def test_largescale_baselines_gn_aggregation_dense():
    """--gn-aggregation dense: subgraph-sampled TRAIN batches keep
    their edge lists while full-graph EVAL batches run the all-pairs
    matmul aggregation — both branches of the forward in one run."""
    from sgp.exp.run_largescale_baselines import run_experiment
    from sgp.exp.run_traffic_baselines import configure_parser

    res = _run(run_experiment, configure_parser,
               ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
                "--synthetic-steps", "160", "--epochs", "2",
                "--batches-epoch", "2", "--hidden-size", "8",
                "--ff-size", "8", "--batch-size", "8", "--window", "4",
                "--horizon", "3", "--seed", "0", "--patience", "5",
                "--model-name", "gatedgn", "--num-subgraph-nodes", "6",
                "--subgraph-k", "1", "--max-edges", "64",
                "--gn-aggregation", "dense"])
    assert np.isfinite(res["test_mae"])


def test_imputation_runner():
    """GRIN imputation end to end: synthetic missingness injected, the
    whiten-masked trainer runs, and the learned imputation of the
    hidden points beats the trivial relative-error bar (MRE < 1 means
    better than predicting zero/raw-mean scale)."""
    from sgp.exp.run_imputation import (configure_parser,
                                        run_experiment)

    res = _run(run_experiment, configure_parser,
               ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
                "--synthetic-steps", "200", "--epochs", "4",
                "--batches-epoch", "2", "--hidden-size", "8",
                "--ff-size", "8", "--batch-size", "8", "--window", "12",
                "--p-noise", "0.15", "--seed", "0", "--patience", "5"])
    for k in ("test_mae", "test_mse", "test_mre", "val_mae"):
        assert np.isfinite(res[k])
    assert res["test_mre"] < 0.9


def test_imputation_runner_rnni():
    """RNNI and BiRNNI end to end through the imputation runner: the
    autoregressive imputers train with whiten-masking and beat the
    trivial relative-error bar at the hidden points."""
    from sgp.exp.run_imputation import (configure_parser,
                                        run_experiment)

    for name in ("rnni", "birnni"):
        res = _run(run_experiment, configure_parser,
                   ["--dataset-name", "synthetic", "--synthetic-nodes",
                    "12", "--synthetic-steps", "200", "--epochs", "4",
                    "--batches-epoch", "2", "--hidden-size", "16",
                    "--batch-size", "8", "--window", "12",
                    "--p-noise", "0.15", "--seed", "0",
                    "--patience", "5", "--model-name", name])
        assert np.isfinite(res["test_mae"])
        assert res["test_mre"] < 0.95
