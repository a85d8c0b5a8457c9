"""SGP / ESN / ablation-encoder experiments on traffic datasets.

Counterpart of ``experiments/run_traffic_sgp.py`` (see SURVEY.md §3.1):
dataset -> datetime exogenous -> connectivity -> scaler/splitter ->
training-free encode -> SGP decoder training -> test metrics.

Usage::

    python -m sgp.exp.run_traffic_sgp --config traffic/sgp_la.toml
    python -m sgp.exp.run_traffic_sgp --dataset-name synthetic \
        --epochs 5 --batches-epoch 50
"""
from __future__ import annotations

import argparse

import numpy as np

from sgp.data import (SpatioTemporalDataset, StandardScaler,
                      WindowedLoader, Windowing)
from sgp.encode import encode_dataset, get_encoder_class
from sgp.exp.common import (Experiment, add_common_args, filter_kwargs,
                            get_dataset, get_splitter, str2bool)
from sgp.models import SGPModel
from sgp.train import MaskedMetrics, Predictor
from sgp.utils.logging import logger


def configure_parser(data_sharding_choices=("none", "batch")
                     ) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--encoder-name", type=str, default="sgp")
    parser.add_argument("--model-name", type=str, default="sgp")
    # preprocessing
    parser.add_argument("--preprocess-exogenous", type=str2bool,
                        default=True)
    parser.add_argument("--keep-raw", type=str2bool, default=True)
    parser.add_argument("--iid-sampling", type=str2bool, default=False)
    parser.add_argument("--sgp-preprocessing", type=str2bool,
                        default=False)
    # reservoir / spatial flags (encoder surface, sgp_encoder.py:53-80)
    parser.add_argument("--reservoir-size", type=int, default=32)
    parser.add_argument("--reservoir-layers", type=int, default=1)
    parser.add_argument("--leaking-rate", type=float, default=0.9)
    parser.add_argument("--spectral-radius", type=float, default=0.9)
    parser.add_argument("--density", type=float, default=0.7)
    parser.add_argument("--input-scaling", type=float, default=1.0)
    parser.add_argument("--alpha-decay", type=str2bool, default=False)
    parser.add_argument("--reservoir-activation", type=str, default="tanh")
    parser.add_argument("--receptive-field", type=int, default=1)
    parser.add_argument("--bidirectional", type=str2bool, default=False)
    parser.add_argument("--undirected", type=str2bool, default=False)
    parser.add_argument("--add-self-loops", type=str2bool, default=False)
    parser.add_argument("--global-attr", type=str2bool, default=False)
    # decoder flags (sgp_model.py:105-123)
    parser.add_argument("--hidden-size", type=int, default=32)
    parser.add_argument("--mlp-size", type=int, default=32)
    parser.add_argument("--emb-size", type=int, default=32)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--fully-connected", type=str2bool, default=False)
    parser.add_argument("--positional-encoding", type=str2bool,
                        default=True)
    parser.add_argument("--resnet", type=str2bool, default=False)
    parser.add_argument("--rec-layers", type=int, default=1)  # esn
    parser.add_argument("--fused", type=str2bool, default=True,
                        help="fuse sampling+gather+train into one jitted "
                             "program (scan over batches_epoch steps)")
    parser.add_argument("--encode-dtype", type=str, default=None,
                        help="storage dtype for the encoding, e.g. "
                             "bfloat16 (halves HBM)")
    parser.add_argument("--encode-time-chunk", type=int, default=None)
    if data_sharding_choices:
        parser.add_argument(
            "--data-sharding", type=str, default="none",
            choices=data_sharding_choices,
            help="'batch': data-parallel fused windowed training over "
                 "all local devices (per-device window sampling, psum "
                 "grads); 'nodes' (large-scale runner): node-shard the "
                 "big arrays, 1/n HBM per chip")
    return parser


def build_encoded_dataset(args):
    """Dataset -> windowed STDataset -> scaler fit -> encoder precompute."""
    from sgp.exp.common import dataset_kwargs
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        threshold=args.adj_threshold, knn=args.adj_knn,
        include_self=False)
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            stride=args.stride,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    input_size = ds.n_channels + (exog.shape[-1]
                                  if args.preprocess_exogenous else 0)
    encoder_cls = get_encoder_class(args.encoder_name)
    enc_kwargs = filter_kwargs(encoder_cls.__init__, {
        **vars(args), "input_size": input_size, "seed": args.seed,
        "reservoir_activation": args.reservoir_activation})
    encoder = encoder_cls(**enc_kwargs)
    encode_dataset(ds, encoder,
                   encode_exogenous=args.preprocess_exogenous,
                   keep_raw=args.keep_raw, device_resident=True,
                   store_dtype=args.encode_dtype,
                   time_chunk=args.encode_time_chunk)
    return ds, split


def derive_order(args) -> int:
    """``run_traffic_sgp.py:220-226``."""
    order = 1
    order += (2 if args.bidirectional else 1) * args.receptive_field
    if args.global_attr:
        order += 1
    order *= args.reservoir_layers
    return order


def run_experiment(args):
    ds, split = build_encoded_dataset(args)

    support_ops = None
    if args.sgp_preprocessing:
        # loader-side propagation from materialized supports
        # (SGPDataModule's sgp_preprocessing path)
        from sgp.data.sgp_loader import build_support_operators
        support_ops = build_support_operators(
            ds.graph, k=args.receptive_field,
            undirected=args.undirected,
            add_loops=args.add_self_loops,
            bidirectional=args.bidirectional,
            global_attr=args.global_attr)

    sample = ds.gather_batch(np.array([0]))
    x_size = sample["x"].shape[-1]
    if support_ops is not None:
        x_size = x_size * (1 + len(support_ops))
    u_size = sample["u"].shape[-1] if "u" in sample else 0
    to_call = None

    if args.model_name == "online_sgp":
        from sgp.models import SGPOnlineModel
        from sgp.encode.spatial import prepare_propagation_graphs
        from sgp.ops import build_operator
        graphs = prepare_propagation_graphs(
            ds.graph, undirected=args.undirected,
            add_loops=args.add_self_loops,
            bidirectional=args.bidirectional)
        operators = [build_operator(g) for g in graphs]
        model = SGPOnlineModel(
            input_size=x_size, n_nodes=ds.n_nodes,
            output_size=ds.n_channels,
            horizon=ds.windowing.horizon_steps,
            receptive_field=args.receptive_field,
            reservoir_layers=args.reservoir_layers,
            bidirectional=args.bidirectional,
            hidden_size=args.hidden_size, mlp_size=args.mlp_size,
            n_layers=args.n_layers,
            positional_encoding=args.positional_encoding,
            emb_size=args.emb_size, exog_size=u_size,
            resnet=args.resnet, fully_connected=args.fully_connected,
            dropout=args.dropout)

        def to_call(batch, training):
            kwargs = {"u": batch.get("u"), "training": training}
            if "node_index" in batch:
                kwargs["node_index"] = batch["node_index"]
            return (batch["x"], operators), kwargs
    elif args.model_name == "sgp":
        model = SGPModel(
            input_size=x_size, order=derive_order(args),
            n_nodes=ds.n_nodes, hidden_size=args.hidden_size,
            mlp_size=args.mlp_size, output_size=ds.n_channels,
            n_layers=args.n_layers, horizon=ds.windowing.horizon_steps,
            positional_encoding=args.positional_encoding,
            emb_size=args.emb_size, exog_size=u_size,
            resnet=args.resnet, fully_connected=args.fully_connected,
            dropout=args.dropout)
    elif args.model_name == "esn":
        from sgp.models.esn import ESNModel   # flax baseline
        model = ESNModel.build(
            input_size=x_size, hidden_size=args.hidden_size,
            output_size=ds.n_channels, exog_size=u_size,
            rec_layers=args.rec_layers,
            horizon=ds.windowing.horizon_steps, seed=args.seed)
    else:
        raise ValueError(args.model_name)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else None
    metrics = MaskedMetrics.forecasting(
        {"15": 2, "30": 5, "60": 11} if args.horizon == 12 else {})
    predictor = Predictor(
        model, loss="mae", lr=args.lr, weight_decay=args.l2_reg,
        grad_clip=args.grad_clip_val,
        lr_milestones=args.lr_milestones if args.use_lr_schedule else None,
        lr_gamma=args.lr_gamma,
        steps_per_epoch=batches_epoch or max(
            1, len(split.train) // args.batch_size),
        scale_target=args.scale_target, metrics=metrics,
        batch_to_call=to_call, seed=args.seed)

    infer_bs = args.batch_inference or args.batch_size
    if support_ops is not None:
        from sgp.data.sgp_loader import SGPIIDLoader, SGPLoader
        if args.iid_sampling:
            train_loader = SGPIIDLoader(
                ds, support_ops, batch_size=args.batch_size,
                num_batches=batches_epoch or 1000, seed=args.seed,
                step_index=ds.indices()[split.train])
        else:
            train_loader = SGPLoader(ds, support_ops, items=split.train,
                                     batch_size=args.batch_size,
                                     shuffle=True,
                                     limit_batches=batches_epoch,
                                     seed=args.seed)
        val_loader = SGPLoader(ds, support_ops, items=split.val,
                               batch_size=infer_bs)
        test_loader = SGPLoader(ds, support_ops, items=split.test,
                                batch_size=infer_bs)
    elif args.iid_sampling:
        from sgp.data import IIDLoader
        train_loader = IIDLoader(ds, batch_size=args.batch_size,
                                 num_batches=batches_epoch or 1000,
                                 seed=args.seed,
                                 step_index=ds.indices()[split.train])
        val_loader = WindowedLoader(ds, split.val, batch_size=infer_bs)
        test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)
    else:
        train_loader = WindowedLoader(ds, split.train,
                                      batch_size=args.batch_size,
                                      shuffle=True,
                                      limit_batches=batches_epoch,
                                      seed=args.seed)
        val_loader = WindowedLoader(ds, split.val, batch_size=infer_bs)
        test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)

    fused = (args.fused and args.model_name == "sgp"
             and not args.iid_sampling)
    if getattr(args, "data_sharding", "none") == "batch" and not fused:
        # fail loudly instead of silently training single-device (the
        # DP windowed trainer only backs the fused SGP path here; the
        # loader-based models take --data-sharding batch on the
        # baseline runners via Predictor(mesh=...))
        raise ValueError(
            "--data-sharding batch on run_traffic_sgp requires the "
            "fused SGP path (--fused true, --model-name sgp, "
            "--iid-sampling false); for loader-based baselines use "
            "run_traffic_baselines --data-sharding batch")
    if fused:
        dev = _device_arrays(ds)   # upload the full series ONCE: train
        #                            step and both fused evals share it
        #                            (host->device is ~MB/s; HBM freed
        #                            by del never returns in-process)
        _fit_fused(args, ds, split, model, predictor,
                   support_ops, batches_epoch, infer_bs, dev)
    else:
        predictor.fit(train_loader, val_loader, epochs=args.epochs,
                      patience=args.patience, scaler=ds.scaler_params(),
                      logdir=args.logdir)
    predictor.save(f"{args.logdir}/best.npz")
    if fused:
        test_eval = _fused_eval_for(ds, model, predictor, split.test,
                                    support_ops, infer_bs, dev)
        results = {f"test_{k}": v
                   for k, v in test_eval(predictor.params).items()}
    else:
        results = predictor.evaluate(test_loader, prefix="test_")
    logger.info(f"test: {results}")
    return results


def _device_arrays(ds):
    """The full-series device arrays shared by the fused train step and
    both fused evals — built (and uploaded) exactly once per run."""
    import jax.numpy as jnp

    u_arr = ds.exog_array()
    return {"x": jnp.asarray(ds.input_array()),
            "y": jnp.asarray(ds.target), "m": jnp.asarray(ds.mask),
            "u": None if u_arr is None else jnp.asarray(u_arr)}


def _fused_eval_for(ds, model, predictor, items, support_ops, batch_size,
                    dev):
    """One-dispatch eval over a split."""
    import jax.numpy as jnp

    from sgp.train.fused_window import make_fused_eval

    return make_fused_eval(
        model, dev["x"], dev["y"], dev["m"], ds.indices()[items],
        jnp.asarray(ds.windowing.window_offsets()),
        jnp.asarray(ds.windowing.horizon_offsets()),
        ds.scaler_params(), predictor.metrics, u=dev["u"],
        support_ops=support_ops, batch_size=batch_size)


def _fit_fused(args, ds, split, model, predictor,
               support_ops, batches_epoch, infer_bs, dev):
    """Scan-fused windowed training: one device dispatch per epoch
    (``sgp/train/fused_window.py``) + ONE-dispatch fused val eval;
    early stopping + best-checkpoint per epoch as in Predictor.fit."""
    import time

    import jax
    import jax.numpy as jnp
    import optax

    from sgp.train.fused_window import make_fused_window_step

    common = dict(u=dev["u"], support_ops=support_ops,
                  batch_size=args.batch_size,
                  scale_target=args.scale_target,
                  steps_per_call=batches_epoch or 300)
    fixed = (model, predictor.optimizer, dev["x"], dev["y"], dev["m"],
             jnp.asarray(ds.indices()[split.train]),
             jnp.asarray(ds.windowing.window_offsets()),
             jnp.asarray(ds.windowing.horizon_offsets()),
             ds.scaler_params())
    if getattr(args, "data_sharding", "none") == "batch":
        # multi-chip traffic training as a config change: per-device
        # window sampling + psum loss/grads over all local devices
        from sgp.parallel import make_mesh, make_sharded_window_step
        n_dev = len(jax.devices())
        if args.batch_size % n_dev:
            raise ValueError(
                f"--data-sharding batch needs batch_size "
                f"({args.batch_size}) divisible by the device count "
                f"({n_dev})")
        logger.info(f"data-sharding=batch over {n_dev} devices")
        step = make_sharded_window_step(*fixed, mesh=make_mesh(n_dev, 1),
                                        **common)
    else:
        step = make_fused_window_step(*fixed, **common)
    # initialize params/steps through the standard path (propagate the
    # sample batch if the model expects support-expanded channels)
    first = ds.gather_batch(np.array([0, 1]))
    if support_ops is not None:
        from sgp.data.sgp_loader import apply_support
        first["x"] = apply_support(jnp.asarray(first["x"]), support_ops)
    predictor.init(first, ds.scaler_params())
    val_eval = _fused_eval_for(ds, model, predictor, split.val,
                               support_ops, infer_bs, dev) \
        if len(split.val) else None
    key = jax.random.PRNGKey(args.seed)
    best, best_params, bad = np.inf, predictor.params, 0
    for epoch in range(args.epochs):
        t0 = time.time()
        key, k = jax.random.split(key)
        predictor.params, predictor.opt_state, loss = step(
            predictor.params, predictor.opt_state, k)
        logs = {"train_loss": float(loss)}
        if val_eval is not None:
            logs.update({f"val_{k2}": v
                         for k2, v in val_eval(predictor.params).items()})
            current = logs["val_mae"]
        else:
            current = logs["train_loss"]
        if current < best:
            best, best_params, bad = current, predictor.params, 0
        else:
            bad += 1
        logger.info(f"epoch {epoch}: " + " ".join(
            f"{k2}={v:.4f}" for k2, v in logs.items())
            + f" ({time.time() - t0:.1f}s)")
        if args.patience is not None and bad > args.patience:
            logger.info(f"early stop at epoch {epoch}")
            break
    predictor.params = best_params


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser()).run()
