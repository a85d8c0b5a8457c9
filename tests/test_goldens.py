"""Committed golden end-to-end values: a
fixed-seed synthetic SGP run (encode -> fused train -> fused test eval)
asserted against stored metrics, and closed-form DynGESN asserted
against BOTH stored metrics and an independent float64 numpy
ridge oracle (sklearn-Ridge semantics: centered normal equations)."""
import numpy as np
import pytest

from sgp.exp.common import Experiment

pytestmark = pytest.mark.slow

SGP_ARGS = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
            "--synthetic-steps", "400", "--epochs", "6",
            "--batches-epoch", "8", "--reservoir-size", "8",
            "--mlp-size", "16", "--hidden-size", "32",
            "--batch-size", "16", "--seed", "7", "--fused", "true"]

# golden values captured on the 8-device CPU mesh (seed 7); a
# regression anywhere in encode -> fused train -> fused eval moves them
SGP_GOLDEN = {"test_mae": 7.677900, "test_mse": 96.791347,
              "test_mape": 0.140592}

CF_ARGS = ["--dataset-name", "synthetic", "--synthetic-nodes", "16",
           "--synthetic-steps", "400", "--reservoir-size", "8",
           "--horizon", "4", "--seed", "7"]

CF_GOLDEN = {"test_mae": 2.939038, "test_mse": 23.763903,
             "val_mae": 3.223460}


def test_golden_sgp_traffic_fused():
    from sgp.exp.run_traffic_sgp import (configure_parser,
                                         run_experiment)
    res = Experiment(run_experiment, configure_parser()).run(
        list(SGP_ARGS))
    for k, v in SGP_GOLDEN.items():
        np.testing.assert_allclose(res[k], v, rtol=1e-3), k


def test_golden_closed_form():
    from sgp.exp.run_closed_form import (configure_parser,
                                         run_experiment)
    res = Experiment(run_experiment, configure_parser()).run(
        list(CF_ARGS))
    for k, v in CF_GOLDEN.items():
        np.testing.assert_allclose(res[k], v, rtol=1e-3), k


def test_closed_form_matches_numpy_float64_oracle(rng):
    """Device ridge (streaming f32 Gram + Cholesky, sklearn intercept
    semantics) == an independent float64 numpy exact solve
    (``experiments/run_closed_form.py:191-196`` sklearn-Ridge parity)."""
    from sgp.train import ridge_regression

    n, d, c = 600, 17, 3
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal((d, c))
    y = (x @ w_true + 0.1 * rng.standard_normal((n, c))
         + 2.0).astype(np.float32)
    alpha = 0.7

    # float64 oracle: center, solve (Xc^T Xc + aI) W = Xc^T Yc, bias
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    xm, ym = x64.mean(0), y64.mean(0)
    xc, yc = x64 - xm, y64 - ym
    w_ref = np.linalg.solve(xc.T @ xc + alpha * np.eye(d), xc.T @ yc)
    b_ref = ym - xm @ w_ref

    w, b = ridge_regression(x, y, alpha=alpha, fit_intercept=True)
    np.testing.assert_allclose(np.asarray(w), w_ref, atol=2e-4)
    np.testing.assert_allclose(np.asarray(b), b_ref, atol=2e-4)

    # and the chunked streaming path is identical
    w2, b2 = ridge_regression(x, y, alpha=alpha, fit_intercept=True,
                              chunk=128)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(np.asarray(b2), np.asarray(b), atol=1e-5)
