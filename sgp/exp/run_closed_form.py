"""DynGESN + closed-form ridge readout.

Counterpart of ``experiments/run_closed_form.py`` (SURVEY.md §3.4):
GESN-encode the whole series, then one independent ridge solve per
horizon lag on the flattened (step, node) design matrix — here via
shared-Gram normal equations on the device (``sgp/train/ridge.py``),
with numpy masked metrics per lag and stacked.

Usage::

    python -m sgp.exp.run_closed_form --config traffic/gesn_la.toml
    python -m sgp.exp.run_closed_form --dataset-name synthetic
"""
from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from sgp.data import (SpatioTemporalDataset, StandardScaler, Windowing)
from sgp.encode import GESNEncoder, encode_dataset
from sgp.exp.common import (Experiment, add_common_args, filter_kwargs,
                            get_dataset, get_splitter, str2bool)
from sgp.train.metrics import (numpy_masked_mae, masked_mape,
                               masked_mse)
from sgp.train.ridge import closed_form_readout
from sgp.utils.logging import logger


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="gesn")
    parser.add_argument("--encoder-name", type=str, default="gesn")
    parser.add_argument("--preprocess-exogenous", type=str2bool,
                        default=True)
    parser.add_argument("--reservoir-size", type=int, default=32)
    parser.add_argument("--reservoir-layers", type=int, default=1)
    parser.add_argument("--leaking-rate", type=float, default=0.9)
    parser.add_argument("--spectral-radius", type=float, default=0.9)
    parser.add_argument("--density", type=float, default=0.9)
    parser.add_argument("--input-scaling", type=float, default=1.0)
    parser.add_argument("--alpha-decay", type=str2bool, default=False)
    parser.add_argument("--reservoir-activation", type=str, default="tanh")
    parser.add_argument("--device-resident", type=str2bool, default=False,
                        help="keep the encoding in HBM and solve the "
                             "ridge by streaming chunked Gram/moments "
                             "(for encodings too large to move to host)")
    return parser


def run_experiment(args):
    from sgp.exp.common import dataset_kwargs
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn,
        include_self=False)
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    enc_kwargs = filter_kwargs(GESNEncoder.__init__, {
        **vars(args), "input_size": input_size, "seed": args.seed})
    encode_dataset(ds, GESNEncoder(**enc_kwargs),
                   encode_exogenous=args.preprocess_exogenous,
                   keep_raw=False,
                   device_resident=args.device_resident,
                   store_dtype="bfloat16" if args.device_resident
                   else None)
    if args.device_resident:
        return _run_streaming(args, ds, split)

    # design matrix = [scaled data, encoded_x] flattened over (step, node)
    # (run_closed_form.py:169-185)
    horizon = args.horizon
    encoded = ds.covariates["encoded_x"].value
    scaled = ds.target_scaled
    feats = np.concatenate([scaled, encoded], -1)
    d = feats.shape[-1]

    def steps_of(items):
        return ds.indices()[items]

    # dataset.indices() already guarantees start + horizon < T, so no
    # tail trimming is needed (every window item is a valid solve row)
    train_w = steps_of(split.train)
    x_train = feats[train_w].reshape(-1, d)
    y_by_lag = [scaled[train_w + lag].reshape(-1, ds.n_channels)
                for lag in range(1, horizon + 1)]
    solutions = closed_form_readout(x_train, y_by_lag, alpha=args.l2_reg)

    scaler = ds.scalers["target"]
    results = {}
    for name, items in (("val", split.val), ("test", split.test)):
        if not len(items):
            continue
        w_steps = steps_of(items)
        x_eval = jnp.asarray(feats[w_steps].reshape(-1, d))
        y_hat_lags, y_lags, m_lags = [], [], []
        for lag, (w, b) in enumerate(solutions, start=1):
            pred = np.asarray(x_eval @ w + b).reshape(
                len(w_steps), ds.n_nodes, ds.n_channels)
            pred = scaler.inverse_transform(pred)
            y_true = ds.target[w_steps + lag]
            m = ds.mask[w_steps + lag]
            y_hat_lags.append(pred)
            y_lags.append(y_true)
            m_lags.append(m)
            mae_lag = numpy_masked_mae(pred, y_true, m)
            logger.info(f"{name}_mae_at_lag{lag}: {mae_lag:.4f}")
        y_hat = np.stack(y_hat_lags, 1)
        y = np.stack(y_lags, 1)
        m = np.stack(m_lags, 1)
        results[f"{name}_mae"] = numpy_masked_mae(y_hat, y, m)
        results[f"{name}_mse"] = float(masked_mse(y_hat, y, m))
        results[f"{name}_mape"] = float(masked_mape(y_hat, y, m))
    logger.info(f"results: {results}")
    return results


def _run_streaming(args, ds, split):
    """Device-resident closed form: feats stay in HBM; Gram/moments and
    eval predictions stream in chunks (``closed_form_readout_streaming``).
    Eval is chunk-outer with all lag readouts stacked into one einsum per
    chunk (amortizes the per-dispatch latency of the remote device link).
    """
    import jax as _jax

    from sgp.train.ridge import (closed_form_readout_streaming,
                                 gather_feat_parts)
    horizon = args.horizon
    encoded = ds.covariates["encoded_x"].value          # jax [T, N, E]
    scaled = jnp.asarray(ds.target_scaled)
    feat_parts = [scaled, encoded]  # concatenated per chunk (HBM)
    solutions = closed_form_readout_streaming(
        feat_parts, scaled, ds.indices()[split.train], horizon,
        alpha=args.l2_reg)
    w_all = jnp.stack([w for w, _ in solutions])        # [H, D, C]
    b_all = jnp.stack([b for _, b in solutions])        # [H, C]

    @_jax.jit
    def predict_all_lags(f_chunk, w_all, b_all):
        # [Tc*N, D] x [H, D, C] -> [H, Tc*N, C]
        f2 = f_chunk.reshape(-1, f_chunk.shape[-1])
        return jnp.einsum("nd,hdc->hnc", f2, w_all) + b_all[:, None, :]

    scaler = ds.scalers["target"]
    results = {}
    for name, items in (("val", split.val), ("test", split.test)):
        if not len(items):
            continue
        w_steps = ds.indices()[items]
        sums = np.zeros(4)  # [abs_err, sq_err, ape, count]
        for s in range(0, len(w_steps), 256):
            steps = w_steps[s:s + 256]
            preds = np.asarray(predict_all_lags(
                gather_feat_parts(feat_parts, steps), w_all, b_all))
            preds = preds.reshape(horizon, len(steps), ds.n_nodes,
                                  ds.n_channels)
            preds = scaler.inverse_transform(preds)
            for lag in range(1, horizon + 1):
                y = ds.target[steps + lag]
                mval = ds.mask[steps + lag]
                err = preds[lag - 1] - y
                sums += (np.abs(err)[mval].sum(),
                         (err ** 2)[mval].sum(),
                         np.abs(err / np.where(y == 0, np.inf, y)
                                )[mval].sum(),
                         mval.sum())
        cnt = max(sums[3], 1)
        results[f"{name}_mae"] = float(sums[0] / cnt)
        results[f"{name}_mse"] = float(sums[1] / cnt)
        results[f"{name}_mape"] = float(sums[2] / cnt)
    logger.info(f"results: {results}")
    return results


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser()).run()
