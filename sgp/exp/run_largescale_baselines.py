"""Baselines on large-scale datasets with subgraph-sampled training.

Counterpart of ``experiments/run_largescale_baselines.py`` (SURVEY.md
§3.3): RobustScaler, k-nn graph, SubgraphLoader/SubsetLoader training
with root-only loss, full-graph evaluation.

Usage::

    python -m sgp.exp.run_largescale_baselines --model-name dcrnn \
        --config largescale_100nn/dcrnn_pv.toml
"""
from __future__ import annotations

import numpy as np

from sgp.data import (RobustScaler, SpatioTemporalDataset,
                      WindowedLoader, Windowing)
from sgp.data.subgraph import SubgraphLoader, SubsetLoader
from sgp.exp.common import Experiment, get_dataset, get_splitter
from sgp.exp.run_traffic_baselines import (build_model_and_forward,
                                           configure_parser)
from sgp.models.graph_layers import diff_conv_support_from_arrays
from sgp.train import MaskedMetrics, Predictor
from sgp.utils.logging import logger


def build_subgraph_forward(args, ds, u_size):
    """Forward adapters that rebuild graph operators from the padded
    per-batch subgraph arrays, device-side. Returns ``(model, to_call,
    static_batch)`` — full-graph state rides in ``static_batch`` (see
    ``build_model_and_forward``) so the [N, N] arrays trace as step
    arguments, never HLO constants."""
    name = args.model_name
    if name in ("dcrnn", "gwnet"):
        base_model, _, _ = build_model_and_forward(args, ds, u_size)
        from sgp.models.graph_layers import diff_conv_support
        static = {"supports": diff_conv_support(ds.graph)}

        def to_call(batch, training):
            if "sub_src" in batch:
                supports = diff_conv_support_from_arrays(
                    batch["sub_src"], batch["sub_dst"],
                    batch["sub_weight"], batch["x"].shape[-2])
            else:
                supports = batch["supports"]
            kwargs = {"u": batch.get("u"), "training": training}
            if name == "gwnet":
                kwargs["node_index"] = batch.get("node_index")
            return (batch["x"], supports), kwargs
        return base_model, to_call, static
    if name in ("gatedgn", "gatedgn_conv"):
        base_model, _, _ = build_model_and_forward(args, ds, u_size)
        import jax.numpy as jnp
        # full-graph (non-subsampled) batches honor --gn-aggregation;
        # subgraph batches always carry their own edge list
        agg = getattr(args, "gn_aggregation", "edges")
        static = {}
        gn_band = None
        if agg == "ell":
            from sgp.graph.sparse import padded_incoming
            si, nm = padded_incoming(ds.graph)
            static["gn_neigh"] = (jnp.asarray(si), jnp.asarray(nm))
        elif agg == "dense":
            # scattered ON DEVICE from the edge list instead of
            # uploading a host-densified [N, N] (~165 MB at Table-2
            # scale)
            from sgp.graph.sparse import auto_band
            from sgp.ops.spmm import dense_adj_mask
            static["gn_adj"] = dense_adj_mask(ds.graph)
            # band-limited sweep when the natural node labeling is
            # localized (variable-width windows measured +45-51% on
            # the Table-2 full rows); None = full N^2 sweep
            gn_band = auto_band(ds.graph)
            if gn_band is not None:
                logger.info("gn dense aggregation: band-limited sweep"
                            f" (max window {max(gn_band[1])})")
        else:
            static["gn_src"] = jnp.asarray(ds.graph.src.astype(np.int32))
            static["gn_dst"] = jnp.asarray(ds.graph.dst.astype(np.int32))

        def to_call(batch, training):
            if "sub_src" in batch:
                return (batch["x"],), {
                    "src": batch["sub_src"], "dst": batch["sub_dst"],
                    "u": batch.get("u"),
                    "node_index": batch.get("node_index"),
                    "edge_mask": (batch["sub_weight"] != 0),
                    "training": training}
            gn = {}
            if "gn_adj" in batch:
                gn["adj"] = batch["gn_adj"]
                if gn_band is not None:   # trace-time window table
                    gn["adj_band"] = gn_band
            elif "gn_neigh" in batch:
                gn["neigh"] = batch["gn_neigh"]
            elif "gn_src" in batch:
                gn["src"], gn["dst"] = batch["gn_src"], batch["gn_dst"]
            return (batch["x"],), {
                "u": batch.get("u"),
                "node_index": batch.get("node_index"),
                "edge_mask": None, "training": training, **gn}
        return base_model, to_call, static
    # rnn / fc_rnn need no graph
    return build_model_and_forward(args, ds, u_size)


def run_experiment(args):
    from sgp.exp.common import dataset_kwargs
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(knn=args.adj_knn, threshold=None,
                                     include_self=False)
    logger.info(f"graph: {graph.num_nodes} nodes {graph.num_edges} edges")
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(RobustScaler(axis=(0, 1), quantile_range=(10., 90.)),
                  step_index=ds.indices()[split.train])

    sample = ds.gather_batch(np.array([0]))
    u_size = sample["u"].shape[-1] if "u" in sample else 0
    model, to_call, static = build_subgraph_forward(args, ds, u_size)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    num_sub = args.num_subgraph_nodes or max(ds.n_nodes // 8, 256)
    if args.subgraph_k > 0 and args.model_name not in ("rnn", "fc_rnn"):
        train_loader = SubgraphLoader(
            ds, split.train, batch_size=args.batch_size,
            num_roots=num_sub, k=args.subgraph_k,
            max_edges=args.max_edges,
            cut_edges_uniformly=args.cut_edges_uniformly,
            pad_nodes=min(4 * num_sub, ds.n_nodes),
            limit_batches=batches_epoch, seed=args.seed)
    else:
        train_loader = SubsetLoader(
            ds, split.train, batch_size=args.batch_size,
            num_nodes=num_sub, limit_batches=batches_epoch,
            seed=args.seed)

    from sgp.exp.common import dp_mesh
    metrics = MaskedMetrics.forecasting()
    predictor = Predictor(
        model, loss="mae", lr=args.lr, weight_decay=args.l2_reg,
        grad_clip=args.grad_clip_val,
        lr_milestones=args.lr_milestones if args.use_lr_schedule else None,
        lr_gamma=args.lr_gamma, steps_per_epoch=batches_epoch,
        scale_target=args.scale_target, metrics=metrics,
        batch_to_call=to_call, seed=args.seed, mesh=dp_mesh(args),
        static_batch=static)

    infer_bs = args.batch_inference or args.batch_size
    test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)
    # monitor train loss (no val loader during fit,
    # run_largescale_*.py:289-304 pattern)
    predictor.fit(train_loader, None, epochs=args.epochs,
                  patience=args.patience, scaler=ds.scaler_params(),
                  logdir=args.logdir)
    predictor.save(f"{args.logdir}/best.npz")
    results = predictor.evaluate(test_loader, prefix="test_")
    logger.info(f"test: {results}")
    return results


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser()).run()
