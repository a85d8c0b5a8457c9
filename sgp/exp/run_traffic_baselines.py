"""Trained baselines (RNN / FC-RNN / DCRNN / GWNet / GatedGN) on traffic
datasets. Counterpart of ``experiments/run_traffic_baselines.py``
(SURVEY.md §2.2): standard windowed loaders, full-graph training.

Usage::

    python -m sgp.exp.run_traffic_baselines --model-name dcrnn \
        --config traffic/dcrnn.toml
"""
from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from sgp.data import (SpatioTemporalDataset, StandardScaler,
                      WindowedLoader, Windowing)
from sgp.exp.common import (Experiment, add_common_args, get_dataset,
                            get_splitter, str2bool)
from sgp.models.rnn import FCRNNModel, RNNModel
from sgp.models.dcrnn import DCRNNModel
from sgp.models.gated_gn import (GatedGraphNetworkConvModel,
                                 GatedGraphNetworkMLPModel)
from sgp.models.graph_layers import diff_conv_support
from sgp.models.gwnet import GraphWaveNetModel
from sgp.train import MaskedMetrics, Predictor
from sgp.utils.logging import logger


def configure_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model-name", type=str, default="rnn")
    parser.add_argument("--hidden-size", type=int, default=64)
    parser.add_argument("--ff-size", type=int, default=128)
    parser.add_argument("--n-layers", type=int, default=1)
    parser.add_argument("--rec-layers", type=int, default=1)
    parser.add_argument("--ff-layers", type=int, default=1)
    parser.add_argument("--kernel-size", type=int, default=2)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--rec-dropout", type=float, default=0.0)
    parser.add_argument("--ff-dropout", type=float, default=0.0)
    parser.add_argument("--cell-type", type=str, default="gru")
    parser.add_argument("--temporal-kernel-size", type=int, default=2)
    parser.add_argument("--spatial-kernel-size", type=int, default=2)
    parser.add_argument("--dilation", type=int, default=2)
    parser.add_argument("--dilation-mod", type=int, default=2)
    parser.add_argument("--norm", type=str, default="batch")
    parser.add_argument("--learned-adjacency", type=str2bool, default=True)
    parser.add_argument("--emb-size", type=int, default=10)
    parser.add_argument("--enc-layers", type=int, default=2)
    parser.add_argument("--gnn-layers", type=int, default=2)
    parser.add_argument("--full-graph", type=str2bool, default=False)
    parser.add_argument("--positional-encoding", type=str2bool,
                        default=True)
    parser.add_argument("--activation", type=str, default="silu")
    parser.add_argument("--compute-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="'bfloat16': run the GatedGN message "
                             "layers in bf16 (f32 params and neighbor "
                             "accumulation) — the fast config; "
                             "float32 matches the reference exactly")
    parser.add_argument("--gn-aggregation", type=str, default="edges",
                        choices=("edges", "ell", "dense"),
                        help="GatedGN message aggregation for "
                             "full-graph batches: 'edges' = "
                             "gather/segment-sum over the edge list; "
                             "'ell' = scatter-free padded-incoming "
                             "layout (best for k-nn graphs); 'dense' "
                             "= all-pairs matmul messages masked by the "
                             "dense adjacency (best for dense-ish "
                             "graphs / small batch). Subgraph-sampled "
                             "batches always use the edge list.")
    parser.add_argument("--max-edges", type=int, default=None)
    parser.add_argument("--cut-edges-uniformly", type=str2bool,
                        default=True)
    parser.add_argument("--num-subgraph-nodes", type=int, default=None)
    parser.add_argument("--subgraph-k", type=int, default=2)
    parser.add_argument("--data-sharding", type=str, default="none",
                        choices=("none", "batch"),
                        help="'batch': data-parallel Predictor over all "
                             "local devices (batches shard along the "
                             "sample dim, grads psum via XLA SPMD)")
    return parser


def build_model_and_forward(args, ds, u_size):
    """Model + its forward adapter + static graph state.

    Returns ``(model, to_call, static_batch)``: graph operators /
    adjacency masks / edge lists ride in ``static_batch`` (merged into
    every batch by the Predictor) so they trace as jitted-step
    ARGUMENTS — closure capture in ``to_call`` would embed them as HLO
    constants (minutes of XLA constant folding at Table-2 scale)."""
    g = ds.graph
    name = args.model_name
    if name == "rnn":
        model = RNNModel(output_size=ds.n_channels,
                         horizon=ds.windowing.horizon_steps,
                         hidden_size=args.hidden_size,
                         ff_size=args.ff_size,
                         rec_layers=args.rec_layers,
                         ff_layers=args.ff_layers,
                         cell_type=args.cell_type,
                         dropout=args.ff_dropout)
        return model, None, None
    if name == "fc_rnn":
        model = FCRNNModel(n_nodes=ds.n_nodes, output_size=ds.n_channels,
                           horizon=ds.windowing.horizon_steps,
                           hidden_size=args.hidden_size,
                           ff_size=args.ff_size,
                           rec_layers=args.rec_layers,
                           ff_layers=args.ff_layers,
                           cell_type=args.cell_type,
                           dropout=args.ff_dropout)
        return model, None, None
    if name == "dcrnn":
        supports = diff_conv_support(g)
        model = DCRNNModel(hidden_size=args.hidden_size,
                           ff_size=args.ff_size,
                           output_size=ds.n_channels,
                           horizon=ds.windowing.horizon_steps,
                           n_layers=args.n_layers, exog_size=u_size,
                           kernel_size=args.kernel_size,
                           dropout=args.dropout)

        def to_call(batch, training):
            return (batch["x"], batch["supports"]), {
                "u": batch.get("u"), "training": training}
        return model, to_call, {"supports": supports}
    if name == "gwnet":
        supports = diff_conv_support(g)
        model = GraphWaveNetModel(
            hidden_size=args.hidden_size, ff_size=args.ff_size,
            output_size=ds.n_channels,
            horizon=ds.windowing.horizon_steps, n_layers=args.n_layers,
            exog_size=u_size,
            temporal_kernel_size=args.temporal_kernel_size,
            spatial_kernel_size=args.spatial_kernel_size,
            learned_adjacency=args.learned_adjacency,
            n_nodes=ds.n_nodes, emb_size=args.emb_size,
            dilation=args.dilation, dilation_mod=args.dilation_mod,
            norm=args.norm, dropout=args.dropout)

        def to_call(batch, training):
            return (batch["x"], batch["supports"]), {
                "u": batch.get("u"),
                "node_index": batch.get("node_index"),
                "training": training}
        return model, to_call, {"supports": supports}
    if name in ("tcn", "transformer"):
        from sgp.models import get_model_class
        cls = get_model_class(name)
        common = dict(hidden_size=args.hidden_size,
                      ff_size=args.ff_size, output_size=ds.n_channels,
                      horizon=ds.windowing.horizon_steps,
                      n_layers=args.n_layers, dropout=args.dropout)
        model = cls(**common)
        return model, None, None
    if name in ("stcn", "rnn2gcn"):
        from sgp.graph import normalize_adj
        from sgp.models import get_model_class
        from sgp.ops import build_operator
        op = build_operator(normalize_adj(g, "row"))
        cls = get_model_class(name)
        if name == "stcn":
            model = cls(hidden_size=args.hidden_size,
                        ff_size=args.ff_size,
                        output_size=ds.n_channels,
                        horizon=ds.windowing.horizon_steps,
                        n_layers=args.n_layers, dropout=args.dropout)
        else:
            model = cls(hidden_size=args.hidden_size,
                        output_size=ds.n_channels,
                        horizon=ds.windowing.horizon_steps,
                        rec_layers=args.rec_layers,
                        gcn_layers=args.n_layers,
                        dropout=args.dropout)

        def to_call(batch, training):
            return (batch["x"], batch["op"]), {"u": batch.get("u"),
                                               "training": training}
        return model, to_call, {"op": op}
    if name in ("gatedgn", "gatedgn_conv"):
        cls = (GatedGraphNetworkMLPModel if name == "gatedgn"
               else GatedGraphNetworkConvModel)
        model = cls(input_window_size=args.window,
                    hidden_size=args.hidden_size,
                    output_size=ds.n_channels,
                    horizon=ds.windowing.horizon_steps,
                    n_nodes=ds.n_nodes, enc_layers=args.enc_layers,
                    gnn_layers=args.gnn_layers,
                    positional_encoding=args.positional_encoding,
                    activation=args.activation,
                    compute_dtype=getattr(args, "compute_dtype", None))
        agg = getattr(args, "gn_aggregation", "edges")
        static = {}
        gn_band = None
        if args.full_graph:
            if agg == "ell":
                import warnings
                warnings.warn(
                    "--full-graph honors only --gn-aggregation dense; "
                    "'ell' falls back to the generated all-pairs edge "
                    "list", stacklevel=2)
            if agg == "dense":    # FC-GatedGN as all-pairs matmul blocks
                static["gn_adj"] = jnp.ones(
                    (ds.n_nodes, ds.n_nodes), jnp.bfloat16)
        elif agg == "ell":
            from sgp.graph.sparse import padded_incoming
            si, nm = padded_incoming(g)
            static["gn_neigh"] = (jnp.asarray(si), jnp.asarray(nm))
        elif agg == "dense":
            from sgp.graph.sparse import auto_band
            from sgp.ops.spmm import dense_adj_mask
            static["gn_adj"] = dense_adj_mask(g)   # device scatter
            # band-limited sweep when the natural node labeling is
            # localized (road networks usually are); None = full N^2
            gn_band = auto_band(g)
        else:
            static["gn_src"] = jnp.asarray(g.src.astype(np.int32))
            static["gn_dst"] = jnp.asarray(g.dst.astype(np.int32))

        def to_call(batch, training):
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
                "training": training, **gn}
        return model, to_call, static
    raise ValueError(f"Model {name} not available.")


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
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])

    sample = ds.gather_batch(np.array([0]))
    u_size = sample["u"].shape[-1] if "u" in sample else 0
    model, to_call, static = build_model_and_forward(args, ds, u_size)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else None
    metrics = MaskedMetrics.forecasting(
        {"15": 2, "30": 5, "60": 11} if args.horizon == 12 else {})
    from sgp.exp.common import dp_mesh
    predictor = Predictor(
        model, loss="mae", lr=args.lr, weight_decay=args.l2_reg,
        grad_clip=args.grad_clip_val,
        lr_milestones=args.lr_milestones if args.use_lr_schedule else None,
        lr_gamma=args.lr_gamma,
        steps_per_epoch=batches_epoch or max(
            1, len(split.train) // args.batch_size),
        scale_target=args.scale_target, metrics=metrics,
        batch_to_call=to_call, seed=args.seed, mesh=dp_mesh(args),
        static_batch=static)

    train_loader = WindowedLoader(ds, split.train,
                                  batch_size=args.batch_size,
                                  shuffle=True,
                                  limit_batches=batches_epoch,
                                  seed=args.seed)
    infer_bs = args.batch_inference or args.batch_size
    val_loader = WindowedLoader(ds, split.val, batch_size=infer_bs)
    test_loader = WindowedLoader(ds, split.test, batch_size=infer_bs)
    predictor.fit(train_loader, val_loader, epochs=args.epochs,
                  patience=args.patience, scaler=ds.scaler_params(),
                  logdir=args.logdir)
    predictor.save(f"{args.logdir}/best.npz")
    results = predictor.evaluate(test_loader, prefix="test_")
    logger.info(f"test: {results}")
    return results


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser()).run()
