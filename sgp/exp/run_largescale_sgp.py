"""SGP on large-scale datasets with fused IID (time, node) sampling.

Counterpart of ``experiments/run_largescale_sgp.py`` (SURVEY.md §3.2):
k-nn connectivity, RobustScaler(10, 90), horizon-lag eval steps, IID
decoder training — here as the fully on-device fused step
(``sgp/train/iid.py``), with `epochs x batches_epoch` steps and
train-loss monitoring (no val loader during fit, ``:289-304``).

Usage::

    python -m sgp.exp.run_largescale_sgp \
        --config largescale_100nn/sgp_pv.toml
    python -m sgp.exp.run_largescale_sgp --dataset-name synthetic_large
"""
from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data import (RobustScaler, SpatioTemporalDataset,
                      WindowedLoader, Windowing)
from sgp.exp.common import (Experiment, filter_kwargs, get_dataset,
                            get_splitter)
from sgp.exp.run_traffic_sgp import configure_parser, derive_order
from sgp.encode import encode_dataset, get_encoder_class
from sgp.models import SGPModel
from sgp.train import MaskedMetrics, Predictor
from sgp.train.iid import fused_iid_inputs, make_fused_iid_multi_step
from sgp.utils.logging import logger


def prepare_dataset(args):
    """Dataset -> k-nn graph, datetime exogenous, windowing, split and
    RobustScaler(10, 90) fitted on the train steps. Returns
    ``(ds, split)``."""
    from sgp.exp.common import dataset_kwargs
    dataset = get_dataset(args.dataset_name, **dataset_kwargs(args))
    exog = dataset.datetime_encoded("day")
    graph = dataset.get_connectivity(
        knn=args.adj_knn, threshold=None, include_self=False)
    logger.info(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges")
    ds = SpatioTemporalDataset(
        dataset.target, index=dataset.index, mask=dataset.mask,
        graph=graph, covariates={"u": exog},
        windowing=Windowing(window=args.window, horizon=args.horizon,
                            horizon_lag=args.horizon_lag))
    split = get_splitter(args.dataset_name, args.val_len,
                         args.test_len).split(ds)
    ds.fit_scaler(RobustScaler(axis=(0, 1), quantile_range=(10., 90.)),
                  step_index=ds.indices()[split.train])
    return ds, split


def encoder_input_size(args, ds) -> int:
    return ds.n_channels + (ds.covariates["u"].value.shape[-1]
                            if args.preprocess_exogenous else 0)


def build_encoder(args, ds):
    encoder_cls = get_encoder_class(args.encoder_name)
    return encoder_cls(**filter_kwargs(encoder_cls.__init__, {
        **vars(args), "input_size": encoder_input_size(args, ds),
        "seed": args.seed}))


def encode_packed(args, ds, encoder):
    """Encode the whole series straight into the packed IID training
    layout (``[enc | y_hi | y_lo | mask]`` bf16 rows) in ONE fused XLA
    program, so the unpacked encoding never occupies device memory and
    the fused step gathers one wide row per sample. Rewires the
    dataset's decoder exogenous as the precompute path does. Returns
    ``(packed, target, mask, horizon_offsets, u)``."""
    from sgp.encode import streaming_encode
    from sgp.encode.encode_dataset import (encoder_input_array,
                                           rewire_exog_keys)
    from sgp.train.iid import pack_iid_data
    x_series = encoder_input_array(ds, args.preprocess_exogenous)
    tgt = jnp.asarray(ds.target, jnp.float32)
    mask = jnp.asarray(ds.mask)
    h_off = jnp.asarray(ds.windowing.horizon_offsets())
    lanes = jax.jit(lambda t, m: pack_iid_data(
        jnp.zeros(t.shape[:2] + (0,), jnp.bfloat16), t, m, h_off))(
            tgt, mask)
    t_enc = time.time()
    # precision="highest" matches the encode_dataset fallback (K-hop
    # A@h in f32); "default" is an explicit opt-in
    packed = jax.block_until_ready(streaming_encode(
        encoder, x_series, ds.graph,
        time_chunk=args.encode_time_chunk or 64, extra_lanes=lanes,
        precision=getattr(args, "encode_precision", "highest")))
    logger.info(f"Streaming packed encode in {time.time() - t_enc:.1f}s "
                f"-> {packed.shape} {packed.dtype}")
    rewire_exog_keys(ds, args.preprocess_exogenous, args.keep_raw)
    u_arr = ds.exog_array()
    u = None if u_arr is None else jnp.asarray(u_arr, jnp.float32)
    return packed, tgt, mask, h_off, u


def build_model(args, ds, input_size: int, u_size: int) -> SGPModel:
    return SGPModel(
        input_size=input_size, order=derive_order(args),
        n_nodes=ds.n_nodes, hidden_size=args.hidden_size,
        mlp_size=args.mlp_size, output_size=ds.n_channels,
        n_layers=args.n_layers, horizon=ds.windowing.horizon_steps,
        positional_encoding=args.positional_encoding,
        emb_size=args.emb_size, exog_size=u_size, resnet=args.resnet,
        fully_connected=args.fully_connected, dropout=args.dropout)


def run_experiment(args):
    if getattr(args, "iid_stratified", False):
        return run_experiment_stratified(args)
    ds, split = prepare_dataset(args)
    # memory estimate log (run_largescale_sgp.py:206-212)
    order = derive_order(args)
    est_gb = (ds.n_steps * ds.n_nodes * order * args.reservoir_size
              * 4 / 2 ** 30)
    logger.info(f"encoding memory estimate: {est_gb:.2f} GB (f32)")

    encoder = build_encoder(args, ds)

    # Streaming-packed fast path (encode_packed). Falls back to
    # encode_dataset for non-SGP encoders or explicit non-bf16 storage
    # (packing would change the precision).
    streaming_packed = (
        getattr(args, "packed_gather", True)
        and args.encoder_name == "sgp"
        and (args.encode_dtype or "bfloat16") == "bfloat16")
    if streaming_packed:
        packed, tgt, mask, h_off, u = encode_packed(args, ds, encoder)
        enc = None
        x_size = encoder.output_size
        u_size = 0 if u is None else int(u.shape[-1])
    else:
        encode_dataset(ds, encoder,
                       encode_exogenous=args.preprocess_exogenous,
                       keep_raw=args.keep_raw, device_resident=True,
                       store_dtype=args.encode_dtype or "bfloat16",
                       time_chunk=args.encode_time_chunk or 128)
        enc, tgt, mask, _valid_all, h_off, u = fused_iid_inputs(ds)
        sample = ds.gather_iid_batch(np.array([0]), np.array([0]))
        x_size = sample["x"].shape[-1]
        u_size = sample["u"].shape[-1] if "u" in sample else 0
        packed = getattr(args, "packed_gather", True)

    # train on the train slice only (IIDDataset restricted via reduce,
    # sgp_datamodule.py:42-44)
    train_steps = ds.indices()[split.train]
    valid = jnp.asarray(train_steps)
    model = build_model(args, ds, x_size, u_size)

    if getattr(args, "search_lr", None) or getattr(args, "search_seeds",
                                                   None):
        if getattr(args, "checkpoint_every", 0) or getattr(args, "resume",
                                                           False):
            raise ValueError(
                "--checkpoint-every/--resume are not supported with the "
                "vmapped --search-lr/--search-seeds path")
        if getattr(args, "data_sharding", "none") != "none":
            raise ValueError("--data-sharding is not supported with the "
                             "vmapped --search-lr/--search-seeds path")
        return _run_multi_trial(args, ds, split, model, enc, tgt, mask,
                                valid, h_off, u, packed,
                                streaming_packed, x_size, u_size)

    key = jax.random.PRNGKey(args.seed)
    params = model.init(
        {"params": key, "dropout": key}, jnp.zeros((4, x_size)),
        node_index=jnp.zeros(4, jnp.int32), iid=True,
        **({"u": jnp.zeros((4, u_size))} if u_size else {}))
    optimizer = optax.chain(
        optax.clip_by_global_norm(args.grad_clip_val),
        optax.adam(args.lr))
    opt_state = optimizer.init(params)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    data_sharding = getattr(args, "data_sharding", "none")
    metrics = MaskedMetrics.forecasting()
    infer_bs = args.batch_inference or 16
    w_off = jnp.asarray(ds.windowing.window_offsets())
    if data_sharding == "nodes":
        # multi-chip as a config change: node-sharded memory for the
        # big arrays (1/n per device), per-shard sampling + psum grads,
        # node-sharded fused eval — see sgp/parallel/sharding.py
        from sgp.parallel import (make_mesh, make_sharded_iid_eval,
                                  make_sharded_iid_step)
        n_dev = len(jax.devices())
        mesh = make_mesh(n_dev, 1)
        logger.info(f"data-sharding=nodes over {n_dev} devices")
        step = make_sharded_iid_step(
            model, optimizer, enc, tgt, mask, valid, h_off,
            ds.scaler_params(), mesh, u=u, batch_size=args.batch_size,
            scale_target=args.scale_target, steps_per_call=batches_epoch,
            packed=packed)
        # eval REUSES the step's node-sharded arrays (device_put with an
        # identical sharding is a no-op) — re-sharding the originals
        # would double every big allocation on a cumulative-HBM backend
        u_sh = step.data[-1] if u is not None else None
        if step.packed and len(np.asarray(
                ds.windowing.window_offsets())) == 1:
            # packed rows: features AND shifted targets/masks come from
            # the single sharded array; no target/mask copies at all
            def test_eval_fn(p):
                ev = make_sharded_iid_eval(
                    model, step.data[0], None, None,
                    ds.indices()[split.test], w_off, h_off,
                    ds.scaler_params(), metrics, mesh, u=u_sh,
                    batch_size=infer_bs, x_slice=x_size,
                    unpack_targets=True, n_nodes=ds.n_nodes)
                return ev(p)
        elif step.packed:
            # multi-step windows can't use the packed lanes: shard the
            # explicit target/mask (still 1/n per device) and slice the
            # feature lanes out of the packed rows
            def test_eval_fn(p):
                ev = make_sharded_iid_eval(
                    model, step.data[0], tgt, mask,
                    ds.indices()[split.test], w_off, h_off,
                    ds.scaler_params(), metrics, mesh, u=u_sh,
                    batch_size=infer_bs, x_slice=x_size,
                    n_nodes=ds.n_nodes)
                return ev(p)
        else:
            def test_eval_fn(p):
                ev = make_sharded_iid_eval(
                    model, step.data[0], step.data[1], step.data[2],
                    ds.indices()[split.test], w_off, h_off,
                    ds.scaler_params(), metrics, mesh, u=u_sh,
                    batch_size=infer_bs, n_nodes=ds.n_nodes)
                return ev(p)
    else:
        step = make_fused_iid_multi_step(
            model, optimizer, enc, tgt, mask, valid, h_off,
            ds.scaler_params(), u=u, batch_size=args.batch_size,
            scale_target=args.scale_target, steps_per_call=batches_epoch,
            # one wide row gather per sample instead of separate scalar
            # target/mask gathers. In the streaming path ``packed`` IS
            # the prebuilt packed array.
            packed=packed,
            gather_block=getattr(args, "gather_block", 1))

        def test_eval_fn(p):
            # full-graph evaluation on the test split — ONE fused
            # dispatch (device-resident encodings never round-trip)
            from sgp.train.fused_window import make_fused_eval
            ev = make_fused_eval(
                model, packed if streaming_packed else enc, tgt, mask,
                ds.indices()[split.test], w_off, h_off,
                ds.scaler_params(), metrics, u=u, batch_size=infer_bs,
                # packed rows carry the features first: eval slices
                # them out, so ONLY the packed array lives in HBM
                x_slice=x_size if streaming_packed else None)
            return ev(p)

    params, key, fit_state = _run_restartable_fit(
        args, model, step, params, opt_state, key, batches_epoch)

    results = {f"test_{k}": v for k, v in test_eval_fn(params).items()}
    results.update(fit_state, path="packed" if packed is not False
                   else "unpacked")
    if data_sharding != "none":
        results["data_sharding"] = data_sharding
    logger.info(f"test: {results}")
    return results


def _train_config(args, batches_epoch):
    """Training hparams recorded in checkpoints and asserted on resume —
    resuming under different training settings is NOT the exact run the
    --resume contract promises, so it fails loudly."""
    return {"lr": args.lr, "batch_size": args.batch_size,
            "batches_epoch": batches_epoch,
            "grad_clip_val": args.grad_clip_val, "seed": args.seed,
            "scale_target": bool(args.scale_target)}


def _run_restartable_fit(args, model, step, params, opt_state, key,
                         batches_epoch):
    """The shared fused-runner fit loop with restartable checkpoints
    (SURVEY §5.3): every --checkpoint-every epochs, current params +
    opt state + RNG + best-so-far + progress go into ONE atomic file;
    --resume continues the EXACT run (same RNG stream as an
    uninterrupted run; model/train configs asserted). The step is
    compiled ahead of time, as set-up. Returns ``(best_params, key, fit_state)``: train time (including time before
    a resume), compile seconds, the step's ``memory_analysis()``, and
    the per-epoch losses and seconds of this process."""
    from sgp.train.checkpoint import (AsyncCheckpointer,
                                      restore_run_state)

    ckpt_every = getattr(args, "checkpoint_every", 0)
    ckpt_path = getattr(args, "checkpoint_path", "") \
        or f"{args.logdir}/train_state.ckpt"
    tc = _train_config(args, batches_epoch)
    start_epoch, best_loss, best_params, elapsed = 0, np.inf, params, 0.0
    if getattr(args, "resume", False) and os.path.exists(ckpt_path):
        (params, opt_state, key, start_epoch, best_loss, best_params,
         elapsed) = restore_run_state(ckpt_path, model, params,
                                      opt_state, train_config=tc)
        logger.info(f"resumed from {ckpt_path} at epoch {start_epoch} "
                    f"(best_loss={best_loss:.4f})")

    # fault injection for supervisor/restart testing (SURVEY §5.3):
    # SGP_FAULT="epoch:N,marker:PATH" hard-kills the process at the
    # start of epoch N unless PATH exists (created on the way out, so
    # the fault fires exactly once across restarts)
    ckpt = AsyncCheckpointer()
    fault = os.environ.get("SGP_FAULT", "")
    fault_epoch, fault_marker = -1, ""
    if fault:
        parts = dict(p.split(":", 1) for p in fault.split(","))
        fault_epoch, fault_marker = int(parts["epoch"]), parts["marker"]

    t_c = time.time()
    run_step = step.compile(params, opt_state, key)
    compile_s = time.time() - t_c
    mem = run_step.compiled.memory_analysis()
    step_memory = {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")} \
        if mem is not None else {}
    logger.info(f"train step compiled in {compile_s:.1f}s; memory "
                f"{step_memory}")
    epoch_losses, epoch_s = [], []
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        if epoch == fault_epoch and not os.path.exists(fault_marker):
            with open(fault_marker, "w") as fp:
                fp.write(str(epoch))
            logger.info(f"FAULT INJECTION: dying at epoch {epoch}")
            os._exit(13)
        key, k = jax.random.split(key)
        t_ep = time.time()
        params, opt_state, loss = jax.block_until_ready(
            run_step(params, opt_state, k))
        dt_ep = time.time() - t_ep
        loss = float(loss)
        epoch_losses.append(loss)
        epoch_s.append(dt_ep)
        if loss < best_loss:
            best_loss, best_params = loss, params
        if epoch % max(1, args.epochs // 20) == 0:
            bps = (batches_epoch * (epoch + 1 - start_epoch)
                   / max(time.time() - t0, 1e-9))
            # the trailing "(X.XXs)" is the per-epoch wall (bench.py
            # parses it) — the batch/s figure stays cumulative
            logger.info(f"epoch {epoch}: train_mae={loss:.4f} "
                        f"({bps:.1f} batch/s) ({dt_ep:.2f}s)")
        if ckpt_every and (epoch + 1) % ckpt_every == 0:
            # async: the device->host fetch rides a worker thread
            # (arrays are immutable), so the step loop never stalls
            ckpt.save(ckpt_path, model, params, opt_state, key,
                      epoch, best_loss, best_params,
                      elapsed_s=elapsed + time.time() - t0,
                      train_config=tc)
    ckpt.wait()   # the last checkpoint is durable before we report
    return best_params, key, {
        "train_time_s": elapsed + time.time() - t0,
        "best_loss": best_loss, "compile_s": compile_s,
        "train_step_memory": step_memory,
        "epoch_losses": epoch_losses, "epoch_s": epoch_s}


def _run_multi_trial(args, ds, split, model, enc, tgt, mask, valid,
                     h_off, u, packed, streaming_packed, x_size, u_size):
    """On-device hyperparameter search over lr x seed: all trials train
    in ONE vmapped program on shared sampled batches
    (``train/multi_trial.py`` — the gather-bound step amortizes across
    trials), fused val eval selects the winner, fused test eval reports
    it. The process-parallel search (``exp/hyperopt.py``) stays the path
    for shape-changing axes."""
    from sgp.train.fused_window import make_fused_eval
    from sgp.train.multi_trial import (best_trial, eval_trials,
                                       init_trial_params,
                                       make_fused_iid_multi_trial_step,
                                       take_trial)

    lrs = [float(v) for v in (args.search_lr or str(args.lr)).split(",")]
    seeds = [int(v) for v in
             (args.search_seeds or str(args.seed)).split(",")]
    trials = [(lr, seed) for lr in lrs for seed in seeds]
    k_trials = len(trials)
    logger.info(f"vmapped search over {k_trials} trials (lr x seed): "
                f"{trials}")
    ex = {"x": jnp.zeros((4, x_size)),
          "node_index": jnp.zeros(4, jnp.int32), "iid": True,
          **({"u": jnp.zeros((4, u_size))} if u_size else {})}
    stack = init_trial_params(model, [s for _, s in trials], ex)
    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    step = make_fused_iid_multi_trial_step(
        model, enc, tgt, mask, valid, h_off, ds.scaler_params(),
        lrs=np.asarray([lr for lr, _ in trials], np.float32), u=u,
        batch_size=args.batch_size, grad_clip=args.grad_clip_val,
        scale_target=args.scale_target, steps_per_call=batches_epoch,
        packed=packed)
    opt_state = step.init_opt(stack)

    @jax.jit
    def keep_best(best_p, p, best_l, losses):
        better = losses < best_l
        sel = jax.tree.map(
            lambda b, q: jnp.where(
                better.reshape((k_trials,) + (1,) * (q.ndim - 1)), q, b),
            best_p, p)
        return sel, jnp.minimum(best_l, losses)

    key = jax.random.PRNGKey(args.seed)
    best_losses = jnp.full((k_trials,), np.inf)
    best_stack = stack
    t0 = time.time()
    for epoch in range(args.epochs):
        key, k = jax.random.split(key)
        stack, opt_state, losses = step(stack, opt_state, k)
        best_stack, best_losses = keep_best(best_stack, stack,
                                            best_losses, losses)
        if epoch % max(1, args.epochs // 20) == 0:
            bps = (batches_epoch * k_trials * (epoch + 1)
                   / max(time.time() - t0, 1e-9))
            logger.info(f"epoch {epoch}: train_mae="
                        f"{np.asarray(losses).round(4).tolist()} "
                        f"({bps:.1f} trial-batch/s)")
    train_time = time.time() - t0

    metrics = MaskedMetrics.forecasting()
    infer_bs = args.batch_inference or 16
    w_off = jnp.asarray(ds.windowing.window_offsets())
    x_big = packed if streaming_packed else enc
    x_sl = x_size if streaming_packed else None

    def fused(items):
        return make_fused_eval(model, x_big, tgt, mask, items, w_off,
                               h_off, ds.scaler_params(), metrics, u=u,
                               batch_size=infer_bs, x_slice=x_sl)

    val_items = ds.indices()[split.val]
    sel_eval = fused(val_items if len(val_items) else
                     ds.indices()[split.train])
    per_trial_val = eval_trials(sel_eval, best_stack)
    k_best = best_trial(per_trial_val, "mae")
    test_res = fused(ds.indices()[split.test])(
        take_trial(best_stack, k_best))
    results = {f"test_{k}": v for k, v in test_res.items()}
    results.update(
        best_lr=trials[k_best][0], best_seed=trials[k_best][1],
        val_mae_per_trial=per_trial_val["mae"].tolist(),
        trials=[{"lr": lr, "seed": s} for lr, s in trials],
        train_time_s=train_time)
    logger.info(f"best trial {k_best} {trials[k_best]}: {results}")
    return results


def run_experiment_stratified(args):
    """Beyond-HBM path: only the reservoir (temporal) embedding stays
    resident; spatial propagation happens inside the fused step
    (``make_fused_iid_stratified_step``) — the full (k+1)x expansion is
    never materialized, so series too long for the precompute path train
    on one chip."""
    if getattr(args, "search_lr", None) or getattr(args, "search_seeds",
                                                   None):
        raise ValueError("--search-lr/--search-seeds are not supported "
                         "with --iid-stratified (the vmapped trial "
                         "search runs on the precompute path)")
    from sgp.data.sgp_loader import build_support_operators
    from sgp.encode import Reservoir
    from sgp.train.iid import make_fused_iid_stratified_step

    ds, split = prepare_dataset(args)
    input_size = encoder_input_size(args, ds)
    res = Reservoir(input_size=input_size,
                    hidden_size=args.reservoir_size,
                    num_layers=args.reservoir_layers,
                    leaking_rate=args.leaking_rate,
                    spectral_radius=args.spectral_radius,
                    density=args.density, alpha_decay=args.alpha_decay,
                    input_scaling=args.input_scaling,
                    activation=args.reservoir_activation,
                    seed=args.seed)
    from sgp.encode.encode_dataset import (encoder_input_array,
                                           rewire_exog_keys)
    x_series = encoder_input_array(ds, args.preprocess_exogenous)
    t0 = time.time()
    h_temporal = jax.block_until_ready(
        res(x_series, out_dtype=args.encode_dtype or "bfloat16"))
    del x_series
    logger.info(f"reservoir encode {h_temporal.shape} in "
                f"{time.time() - t0:.1f}s (resident bf16)")

    ops = build_support_operators(
        ds.graph, k=args.receptive_field,
        undirected=args.undirected, add_loops=args.add_self_loops,
        bidirectional=args.bidirectional, global_attr=False)
    d_total = int(h_temporal.shape[-1]) * (1 + len(ops)
                                           + (1 if args.global_attr else 0))
    # decoder exogenous mirrors encode_dataset's rewiring: the datetime
    # exog goes to the decoder only if NOT already encoded into the
    # reservoir; keep_raw adds the scaled raw series
    rewire_exog_keys(ds, args.preprocess_exogenous, args.keep_raw)
    u_arr = ds.exog_array()
    u = None if u_arr is None else jnp.asarray(u_arr)
    u_size = 0 if u is None else int(u.shape[-1])

    model = build_model(args, ds, d_total, u_size)
    key = jax.random.PRNGKey(args.seed)
    params = model.init(
        {"params": key, "dropout": key}, jnp.zeros((4, d_total)),
        node_index=jnp.zeros(4, jnp.int32), iid=True,
        **({"u": jnp.zeros((4, u_size))} if u_size else {}))
    optimizer = optax.chain(
        optax.clip_by_global_norm(args.grad_clip_val),
        optax.adam(args.lr))
    opt_state = optimizer.init(params)

    batches_epoch = args.batches_epoch if args.batches_epoch > 0 else 32
    times_per_batch = getattr(args, "times_per_batch", 32)
    nodes_per_time = max(args.batch_size // times_per_batch, 1)
    from sgp.ops import GlobalMeanOperator
    eval_ops = list(ops) + ([GlobalMeanOperator(ds.n_nodes)]
                            if args.global_attr else [])
    metrics = MaskedMetrics.forecasting()
    infer_bs = args.batch_inference or 16
    w_off = jnp.asarray(ds.windowing.window_offsets())
    h_off = jnp.asarray(ds.windowing.horizon_offsets())
    data_sharding = getattr(args, "data_sharding", "none")
    if data_sharding == "nodes":
        # multi-chip x beyond-HBM: resident embedding 1/n per device;
        # the step all-gathers only the sampled time rows; eval
        # propagates each time batch the same way (support_ops inside
        # the sharded eval) — nothing full-size ever lives on one chip
        from sgp.parallel import (make_mesh, make_sharded_iid_eval,
                                  make_sharded_iid_stratified_step)
        n_dev = len(jax.devices())
        mesh = make_mesh(n_dev, 1)
        logger.info(f"data-sharding=nodes over {n_dev} devices "
                    f"(stratified)")
        npt = max(-(-nodes_per_time // n_dev) * n_dev, n_dev)
        if npt != nodes_per_time:
            logger.info(f"nodes_per_time {nodes_per_time} -> {npt} "
                        f"(rounded up to {n_dev} devices; effective "
                        f"batch {times_per_batch * npt})")
        step = make_sharded_iid_stratified_step(
            model, optimizer, h_temporal, jnp.asarray(ds.target),
            jnp.asarray(ds.mask),
            jnp.asarray(ds.indices()[split.train]), h_off,
            ds.scaler_params(), ops, mesh,
            global_attr=args.global_attr, u=u,
            times_per_batch=times_per_batch, nodes_per_time=npt,
            scale_target=args.scale_target,
            steps_per_call=batches_epoch)

        def test_eval_fn(p):
            ev = make_sharded_iid_eval(
                model, step.data[0], step.data[1], step.data[2],
                ds.indices()[split.test], w_off, h_off,
                ds.scaler_params(), metrics, mesh,
                u=step.data[-1] if u is not None else None,
                batch_size=infer_bs, support_ops=eval_ops,
                n_nodes=ds.n_nodes)
            return ev(p)
    else:
        step = make_fused_iid_stratified_step(
            model, optimizer, h_temporal, jnp.asarray(ds.target),
            jnp.asarray(ds.mask), jnp.asarray(ds.indices()[split.train]),
            h_off, ds.scaler_params(),
            ops, global_attr=args.global_attr, u=u,
            times_per_batch=times_per_batch,
            nodes_per_time=nodes_per_time,
            scale_target=args.scale_target, steps_per_call=batches_epoch)

        def test_eval_fn(p):
            # full-graph test evaluation: the reservoir embedding is
            # the model input, propagated through the same supports
            # (+ global mean) — ONE dispatch, identical math to the
            # in-step assembly
            from sgp.train.fused_window import make_fused_eval
            ev = make_fused_eval(
                model, h_temporal, jnp.asarray(ds.target),
                jnp.asarray(ds.mask), ds.indices()[split.test], w_off,
                h_off, ds.scaler_params(), metrics, u=u,
                support_ops=eval_ops, batch_size=infer_bs)
            return ev(p)

    best_params, key, fit_state = _run_restartable_fit(
        args, model, step, params, opt_state, key, batches_epoch)
    logger.info(f"train done in {fit_state['train_time_s']:.1f}s")

    predictor = Predictor(model, metrics=metrics)
    predictor.params = best_params
    predictor._build_steps(ds.scaler_params())
    predictor.save(f"{args.logdir}/best.npz")
    results = {f"test_{k}": v for k, v in test_eval_fn(best_params).items()}
    results.update(fit_state, train_mae=fit_state["best_loss"],
                   path="stratified")
    if data_sharding != "none":
        results["data_sharding"] = data_sharding
    logger.info(f"results: {results}")
    return results


def configure_parser_largescale():
    from sgp.exp.common import str2bool
    parser = configure_parser(data_sharding_choices=None)
    parser.add_argument("--iid-stratified", type=str2bool, default=False)
    parser.add_argument("--times-per-batch", type=int, default=32)
    parser.add_argument("--data-sharding", type=str, default="none",
                        choices=("none", "nodes"),
                        help="'nodes': node-shard the big arrays over "
                             "all local devices (1/n HBM per chip), "
                             "per-shard sampling + psum grads, "
                             "node-sharded fused eval")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save params+opt+RNG+best every N epochs "
                             "(atomic; 0 disables)")
    parser.add_argument("--checkpoint-path", type=str, default="",
                        help="train-state path (default: "
                             "<logdir>/train_state.ckpt — pass an "
                             "explicit path to resume across runs)")
    parser.add_argument("--resume", type=str2bool, default=False,
                        help="continue from --checkpoint-path with the "
                             "exact RNG stream of the uninterrupted run")
    parser.add_argument("--search-lr", type=str, default="",
                        help="comma-separated lr list: train all lr x "
                             "seed trials in ONE vmapped program on "
                             "shared batches, select on fused val MAE")
    parser.add_argument("--search-seeds", type=str, default="",
                        help="comma-separated init seeds for the "
                             "vmapped trial search")
    parser.add_argument("--encode-precision", type=str, default="highest",
                        choices=("highest", "default"),
                        help="matmul precision for the streaming K-hop "
                             "propagation; 'highest' matches the "
                             "encode_dataset fallback, 'default' lets "
                             "the tensor cores round f32 inputs (TF32)")
    parser.add_argument("--gather-block", type=int, default=1,
                        help="G>1: sample batch/G (time, node-block) "
                             "pairs and gather G consecutive packed "
                             "rows per draw — G-fold fewer random row "
                             "fetches (the fused step's latency bound)."
                             " Cluster sampling over a fixed node "
                             "partition; requires G | batch and "
                             "G | n_nodes and the packed layout")
    parser.add_argument("--packed-gather", type=str2bool, default=True,
                        help="pack features+targets+masks into one wide "
                             "bf16 row per (t, n) so the fused IID step "
                             "gathers once per sample")
    return parser


if __name__ == "__main__":
    Experiment(run_experiment, configure_parser_largescale()).run()
