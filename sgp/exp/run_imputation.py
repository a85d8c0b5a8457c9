"""Imputation experiment: GRIN on a corrupted series.

Wires the imputation stack end-to-end the way the five forecasting
runners wire theirs: inject synthetic missingness
(``tsl/ops/imputation.py:70-102`` semantics, ``add_missing_values``),
train :class:`~sgp.models.grin.GRINModel` with whiten-masked batches
(``tsl/imputers/imputer.py:11-229`` semantics,
``train/imputer.py::make_imputer_train_step``), and score the
reconstruction of the hidden points in RAW units (MAE/MSE/MRE at the
eval mask — the reference imputation papers' metrics).

The reference ships no imputation entry point under ``experiments/``
(SURVEY.md §2.2 lists five forecasting runners); this runner completes
the tsl capability surface (Imputer / ImputationDataset / GRIN) as a
runnable experiment. Loader-based (one dispatch per batch): imputation
is a capability-parity path, not a throughput headline.

Usage::

    python -m sgp.exp.run_imputation --dataset-name synthetic \
        --p-fault 0.0015 --p-noise 0.05 --epochs 20
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data import StandardScaler, Windowing
from sgp.data.imputation import ImputationDataset, add_missing_values
from sgp.exp.common import (Experiment, add_common_args, dataset_kwargs,
                            get_dataset, get_splitter)
from sgp.models.graph_layers import diff_conv_support
from sgp.models.grin import GRINModel
from sgp.train.imputer import (make_imputer_train_step,
                               split_imputation_output)
from sgp.utils.logging import logger


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="grin",
                        choices=("grin", "rnni", "birnni"))
    parser.add_argument("--hidden-size", type=int, default=64)
    parser.add_argument("--ff-size", type=int, default=64)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--kernel-size", type=int, default=2)
    parser.add_argument("--decoder-order", type=int, default=1)
    parser.add_argument("--merge-mode", type=str, default="mlp")
    # RNNI family flags (rnni_models.py:107-119 flag surface)
    parser.add_argument("--cell", type=str, default="gru",
                        choices=("gru", "lstm"))
    parser.add_argument("--concat-mask", type=lambda v: v.lower() != "false",
                        default=True)
    parser.add_argument("--detach-input", action="store_true")
    parser.add_argument("--process-nodes-independently",
                        action="store_true")
    parser.add_argument("--state-init", type=str, default="zero",
                        choices=("zero", "noise"))
    parser.add_argument("--dropout", type=float, default=0.0)
    # imputer training semantics (imputer.py whiten_prob / loss weights)
    parser.add_argument("--whiten-prob", type=float, default=0.05)
    parser.add_argument("--prediction-loss-weight", type=float,
                        default=1.0)
    parser.add_argument("--warm-up-steps", type=int, default=0)
    # synthetic missingness (tsl/ops/imputation.py defaults)
    parser.add_argument("--p-fault", type=float, default=0.0015)
    parser.add_argument("--p-noise", type=float, default=0.05)
    parser.add_argument("--min-seq", type=int, default=1)
    parser.add_argument("--max-seq", type=int, default=10)
    parser.add_argument("--fault-seed", type=int, default=56789)
    return parser


def run_experiment(args):
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn,
        include_self=False)
    ds = ImputationDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph,
        windowing=Windowing(window=args.window, horizon=1))
    # the fault pattern must be independent of the training seed (the
    # reference fixes it, imputation.py:80) so runs are comparable
    add_missing_values(ds, p_fault=args.p_fault, p_noise=args.p_noise,
                       min_seq=args.min_seq, max_seq=args.max_seq,
                       seed=args.fault_seed)
    ev = ds.covariates["eval_mask"].value.astype(bool)
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)

    def scaled_batch(items):
        """``ImputationDataset.gather_batch`` (the one imputation batch
        contract) with x/y moved into scaled space."""
        b = ds.gather_batch(np.asarray(items))
        return {"x": jnp.asarray(sp.transform(jnp.asarray(b["x"]))),
                "y": jnp.asarray(sp.transform(jnp.asarray(b["y"]))),
                "mask": jnp.asarray(b["mask"]),
                "eval_mask": jnp.asarray(b["eval_mask"])}

    # scaler fit on the TRAINING mask (observed minus hidden — the
    # hidden points' values must not leak into the statistics)
    steps = ds.indices()[split.train]
    scaler = StandardScaler(axis=(0, 1))
    scaler.fit(ds.target[steps], mask=ds.mask[steps] & ~ev[steps])
    sp = scaler.params()

    if args.model_name == "grin":
        supports = diff_conv_support(graph)
        model = GRINModel(input_size=ds.n_channels,
                          hidden_size=args.hidden_size,
                          ff_size=args.ff_size, n_layers=args.n_layers,
                          n_nodes=ds.n_nodes, kernel_size=args.kernel_size,
                          decoder_order=args.decoder_order,
                          merge_mode=args.merge_mode)

        def to_call(batch, training):
            return (batch["x"], supports), {"mask": batch["mask"],
                                            "training": training}
    else:
        from sgp.models.rnni import BiRNNImputerModel, RNNImputerModel
        cls = RNNImputerModel if args.model_name == "rnni" \
            else BiRNNImputerModel
        kw = dict(input_size=ds.n_channels, hidden_size=args.hidden_size,
                  cell=args.cell, concat_mask=args.concat_mask,
                  n_nodes=ds.n_nodes,
                  process_nodes_independently=(
                      args.process_nodes_independently),
                  detach_input=args.detach_input,
                  state_init=args.state_init)
        if args.model_name == "birnni":
            kw["dropout"] = args.dropout
        model = cls(**kw)

        def to_call(batch, training):
            return (batch["x"], batch["mask"]), {"training": training}

    key = jax.random.PRNGKey(args.seed)
    b0 = scaled_batch(np.arange(min(args.batch_size, len(split.train))))
    args0, kwargs0 = to_call(b0, False)
    params = model.init({"params": key, "dropout": key,
                         "state_init": key, "state_init_c": key}, *args0,
                        **{k: v for k, v in kwargs0.items()
                           if k != "training"})

    batches_epoch = (args.batches_epoch if args.batches_epoch > 0
                     else max(1, len(split.train) // args.batch_size))
    lr = args.lr
    if args.use_lr_schedule and args.lr_milestones:
        lr = optax.piecewise_constant_schedule(
            args.lr, {m * batches_epoch: args.lr_gamma
                      for m in args.lr_milestones})
    optimizer = optax.chain(optax.clip_by_global_norm(args.grad_clip_val),
                            optax.adamw(lr, weight_decay=args.l2_reg)
                            if args.l2_reg > 0 else optax.adam(lr))
    opt_state = optimizer.init(params)
    step = make_imputer_train_step(
        model, optimizer, to_call, whiten_prob=args.whiten_prob,
        prediction_loss_weight=args.prediction_loss_weight,
        warm_up=args.warm_up_steps)

    # eval draws noise-init states (when --state-init noise) from a rng
    # FIXED across epochs, so val comparisons measure the params only
    _eval_rngs = {"state_init": jax.random.PRNGKey(args.fault_seed),
                  "state_init_c": jax.random.PRNGKey(args.fault_seed + 1)}

    @jax.jit
    def _infer(params, x_scaled, train_mask):
        x_in = jnp.where(train_mask, x_scaled, 0.0)
        iargs, ikwargs = to_call({"x": x_in, "mask": train_mask}, False)
        merged, _ = split_imputation_output(
            model.apply(params, *iargs, rngs=_eval_rngs, **ikwargs))
        return sp.inverse_transform(merged)

    def evaluate(params, items):
        """Reconstruction error at the HIDDEN (eval-mask) points, raw
        units — the imputation literature's protocol."""
        abs_s = sq_s = ref_s = cnt = 0.0
        bs = args.batch_inference or args.batch_size
        for lo in range(0, len(items), bs):
            b = ds.gather_batch(np.asarray(items[lo:lo + bs]))
            x_raw, e = b["y"], b["eval_mask"]
            y_hat = np.asarray(_infer(
                params, jnp.asarray(sp.transform(jnp.asarray(b["x"]))),
                jnp.asarray(b["mask"])))
            err = np.where(e, y_hat - x_raw, 0.0)
            abs_s += np.abs(err).sum()
            sq_s += (err ** 2).sum()
            ref_s += np.abs(np.where(e, x_raw, 0.0)).sum()
            cnt += e.sum()
        cnt = max(cnt, 1.0)
        return {"mae": abs_s / cnt, "mse": sq_s / cnt,
                "mre": abs_s / max(ref_s, 1e-8)}

    rng = np.random.default_rng(args.seed)
    best = {"val_mae": np.inf, "params": params}
    bad_epochs = 0
    for epoch in range(args.epochs):
        t_epoch = time.time()
        losses = []
        for _ in range(batches_epoch):
            items = rng.choice(split.train, args.batch_size)
            batch = scaled_batch(items)
            key, k2 = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state, batch, k2)
            losses.append(float(loss))
        val = evaluate(params, split.val)
        logger.info(f"epoch {epoch}: loss={np.mean(losses):.4f} "
                    f"val_mae={val['mae']:.4f} "
                    f"({time.time() - t_epoch:.1f}s)")
        if val["mae"] < best["val_mae"]:
            best = {"val_mae": val["mae"], "params": params}
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= args.patience:
                logger.info(f"early stop at epoch {epoch}")
                break

    test = evaluate(best["params"], split.test)
    results = {f"test_{k}": float(v) for k, v in test.items()}
    results["val_mae"] = float(best["val_mae"])
    logger.info(f"test: {results}")
    return results


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser()).run()
