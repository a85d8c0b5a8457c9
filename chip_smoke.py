"""Run the SGP trainer's main path on NVIDIA GPUs and check what it computes.

Usage, from the repository root::

    python chip_smoke.py             # one GPU
    python chip_smoke.py --chips 4   # four GPUs: the node-sharded path only

One GPU runs, in one process:

- ``device``: the card JAX found (it must be a GPU) and its name and power
  limit from ``nvidia-smi``;
- ``encoder``, ``iid_step``, ``serving``: the runner's fused streaming
  encode (reservoir + K-hop), one fused IID train step (loss and
  gradients) and the online forecaster (``warm_up`` plus 10 ``step``
  calls), each at the published PV-US widths and compared with the plain
  float32 path it must equal, run under
  ``jax.default_matmul_precision("highest")``;
- ``reservoir_modes``: the ``sequential`` and ``wavefront`` reservoir scans
  timed at PV-US year scale;
- ``trainer``: the PV-US SGP configuration
  (``configs/largescale_100nn/sgp_pv.toml``) on the synthetic stand-in at
  5,016 nodes and 8,868 steps, through the runner's own
  ``configure_parser_largescale`` / ``run_experiment``, for a few epochs of
  32 batches. The loss must be finite and fall.

``--chips 4`` runs only the node-sharded encode (halo K-hop), training and
eval on a 4-device mesh, each against its one-card counterpart.

Every phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``. Without a GPU, or when any phase fails,
the script exits non-zero and prints no such line.

Tolerances. On Hopper, a float32 matmul at JAX's default precision runs on
the tensor cores in TF32, whose inputs keep 10 mantissa bits (unit roundoff
2**-11, about 4.9e-4), where the reference keeps float32; the error of a
TF32 dot product is about that roundoff times the sum of the magnitudes of
its terms. The decoder and the halo K-hop run at default precision; the
reservoir recurrence and the single-card K-hop run in float32
(``encode/reservoir.py`` says why). Errors are reported as the largest
absolute difference and that difference over the reference's largest
magnitude ("max_rel"); each tolerance is on max_rel.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.encode import SGPEncoder, streaming_encode
from sgp.encode.encode_dataset import (encoder_input_array,
                                       rewire_exog_keys)
from sgp.encode.reservoir import AUTO_MODE, Reservoir, reservoir_scan
from sgp.exp.common import Experiment, filter_kwargs
from sgp.exp.run_largescale_sgp import (build_encoder, build_model,
                                        configure_parser_largescale,
                                        derive_order, encode_packed,
                                        encoder_input_size,
                                        prepare_dataset, run_experiment)
from sgp.obs.device import device_peaks

PV_ARGV = ["--config", "largescale_100nn/sgp_pv.toml",
           "--dataset-name", "synthetic_large",
           "--synthetic-nodes", "5016", "--synthetic-steps", "8868",
           "--seed", "0"]

# max_rel tolerances (see the module docstring for the TF32 reasoning)
# two float32 encodes that differ in summation order only; the
# recurrence can amplify a rounding difference by 1/(1 - 0.99) = 100
TOL_ENCODER = 1e-3
# the same float32 scan in two schedules, outputs stored in bf16
# (one bf16 ulp is 2**-8 = 3.9e-3 relative)
TOL_MODES = 1e-2
TOL_LOSS = 1e-2        # TF32 decoder: one loss over a 4096-sample batch
TOL_GRAD = 2e-2        # TF32 decoder: MSE grads per leaf, 4 matmul layers
TOL_SERVING = 1e-2     # TF32 decoder on float32 features
TOL_SHARDED = 1e-2     # TF32 halo K-hop (2 hops) vs the float32 one
TOL_EVAL = 1e-2        # eval metrics averaged over every test window


class PhaseFailed(RuntimeError):
    pass


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=_plain),
          flush=True)


def _plain(v):
    if isinstance(v, (np.generic, jax.Array)):
        return np.asarray(v).tolist()
    raise TypeError(type(v))


def errors(got, ref) -> tuple[float, float]:
    """``(max |got - ref|, that / max |ref|)`` in float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = float(np.abs(got - ref).max())
    return diff, diff / max(float(np.abs(ref).max()), 1e-30)


def check(phase: str, ok: bool, what: str):
    if not ok:
        raise PhaseFailed(f"{phase}: {what}")


def parse_args(argv: list, **overrides) -> argparse.Namespace:
    args = Experiment(run_experiment, configure_parser_largescale()).parse(
        list(argv))
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def device_phase(count: int) -> dict:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform "
            f"{devices[0].platform!r}); this check runs only on the card")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: --chips {count} needs {count} GPUs, "
                         f"JAX found {len(devices)}")
    kind = devices[0].device_kind
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    emit("device", platform=devices[0].platform, kind=kind,
         count=len(devices), peaks=device_peaks(kind),
         bytes_limit=devices[0].memory_stats().get("bytes_limit"))
    print(smi[0], flush=True)
    return {"platform": devices[0].platform, "kind": kind,
            "count": len(devices)}


def encoder_phase(args) -> tuple:
    """The runner's fused streaming encode (time chunks, reservoir state
    carried across them) on ``args.synthetic_steps`` steps, against the
    plain whole-series encoder (reservoir scan, then K-hop propagation)
    in float32."""
    ds, split = prepare_dataset(args)
    encoder = build_encoder(args, ds)
    x = encoder_input_array(ds, args.preprocess_exogenous)
    got = jax.block_until_ready(streaming_encode(
        encoder, x, ds.graph, time_chunk=args.encode_time_chunk or 64,
        out_dtype=jnp.float32, precision=args.encode_precision))
    with jax.default_matmul_precision("highest"):
        ref = encoder(x, ds.graph)
    max_abs, max_rel = errors(got, ref)
    emit("encoder", shape=list(got.shape), max_abs=max_abs, max_rel=max_rel,
         tol_rel=TOL_ENCODER)
    check("encoder", max_rel <= TOL_ENCODER, f"max_rel {max_rel}")
    return ds, split, encoder


def iid_step_phase(args, ds, split, encoder):
    """Loss and gradients of one fused IID step (sampling, packed-row
    gather, forward, masked loss, backward in one program) against the
    unfused float32 reference on the same sampled batch. The loss is
    checked as trained (MAE); gradients are checked under MSE, because
    an MAE gradient flips sign for any sample whose residual is below
    the TF32 rounding of its forecast, and a node-embedding row fed by
    one such sample then differs by 100% (measured 0.10 max_rel on the
    embedding leaf at batch 4096)."""
    from sgp.train.iid import make_fused_iid_step
    packed, tgt, mask, h_off, u = encode_packed(args, ds, encoder)
    u_size = 0 if u is None else int(u.shape[-1])
    model = build_model(args, ds, encoder.output_size, u_size)
    key = jax.random.PRNGKey(args.seed)
    params = model.init(
        {"params": key, "dropout": key},
        jnp.zeros((4, encoder.output_size)),
        node_index=jnp.zeros(4, jnp.int32), iid=True,
        **({"u": jnp.zeros((4, u_size))} if u_size else {}))
    scaler = ds.scaler_params()
    rng = jax.random.PRNGKey(1)

    def fused(loss):
        step = make_fused_iid_step(
            model, optax.adam(args.lr), None, tgt, mask,
            jnp.asarray(ds.indices()[split.train]), h_off, scaler, u=u,
            batch_size=args.batch_size, packed=packed, loss=loss)
        out = jax.jit(jax.value_and_grad(step.sample_and_loss))(
            params, rng, step.data)
        return out, step

    (mae, _), step = fused("mae")
    (mse, grads), _ = fused("mse")
    x, y, m, n, u_rows = jax.jit(step.sample_and_loss.sample)(
        rng, step.data)

    def ref_loss(p, kind):
        y_hat = model.apply(
            p, x.astype(jnp.float32), node_index=n, iid=True,
            training=True, rngs={"dropout": jax.random.split(rng, 3)[2]},
            **({} if u_rows is None else {"u": u_rows}))
        d = scaler.index_nodes_iid(n).inverse_transform(y_hat) - y
        w = m.astype(jnp.float32)
        e = jnp.abs(d) if kind == "mae" else d * d
        return jnp.sum(e * w) / jnp.maximum(w.sum(), 1.0)

    with jax.default_matmul_precision("highest"):
        ref_mae = jax.jit(lambda p: ref_loss(p, "mae"))(params)
        ref_mse, ref_grads = jax.jit(jax.value_and_grad(
            lambda p: ref_loss(p, "mse")))(params)
    _, mae_rel = errors(mae, ref_mae)
    _, mse_rel = errors(mse, ref_mse)
    leaf_errs = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda g, r: errors(g, r)[1], grads, ref_grads))[0]
    worst_path, worst = max(leaf_errs, key=lambda kv: kv[1])
    emit("iid_step", batch=int(x.shape[0]), features=int(x.shape[-1]),
         mae=float(mae), ref_mae=float(ref_mae), mae_max_rel=mae_rel,
         mse=float(mse), ref_mse=float(ref_mse), mse_max_rel=mse_rel,
         tol_loss_rel=TOL_LOSS, mse_grad_max_rel=worst,
         grad_worst_leaf=jax.tree_util.keystr(worst_path),
         tol_grad_rel=TOL_GRAD)
    check("iid_step", math.isfinite(float(mae))
          and max(mae_rel, mse_rel) <= TOL_LOSS,
          f"loss max_rel {mae_rel}, {mse_rel}")
    check("iid_step", worst <= TOL_GRAD, f"grad max_rel {worst}")


def serving_phase(args, ds, n_live: int = 10):
    """``OnlineForecaster.warm_up`` on all but the last ``n_live`` steps,
    then ``n_live`` calls of ``step``, against the offline precompute of
    the same steps decoded in full-graph mode under "highest"."""
    from sgp.serve import OnlineForecaster
    # serving ingests raw [N, C] observations: the datetime exogenous
    # is not part of the reservoir input here
    sargs = argparse.Namespace(**{**vars(args),
                                  "preprocess_exogenous": False})
    encoder = SGPEncoder(**filter_kwargs(SGPEncoder.__init__, {
        **vars(sargs), "input_size": encoder_input_size(sargs, ds)}))
    model = build_model(sargs, ds, encoder.output_size, 0)
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((1, ds.n_nodes, encoder.output_size)))
    scaler = ds.scaler_params()
    x_raw = jnp.asarray(ds.target, jnp.float32)
    warm = x_raw.shape[0] - n_live

    fc = OnlineForecaster(encoder, ds.graph, model, params, scaler,
                          precision=args.encode_precision)
    fc.warm_up(x_raw[:warm])
    got, step_s = [], []
    for t in range(warm, warm + n_live):
        t0 = time.perf_counter()
        got.append(jax.block_until_ready(fc.step(x_raw[t])))
        step_s.append(time.perf_counter() - t0)
    got = jnp.stack(got)

    with jax.default_matmul_precision("highest"):
        enc = streaming_encode(encoder, scaler.transform(x_raw), ds.graph,
                               out_dtype=jnp.float32, precision="highest")
        ref = scaler.inverse_transform(model.apply(
            params, enc[warm:, None], training=False))
    max_abs, max_rel = errors(got, ref)
    emit("serving", nodes=ds.n_nodes, warm_up_steps=int(warm),
         steps=n_live, forecast_shape=list(got.shape[1:]),
         max_abs=max_abs, max_rel=max_rel, tol_rel=TOL_SERVING,
         step_s_median=statistics.median(step_s[1:]),
         step_s_first=step_s[0])
    check("serving", max_rel <= TOL_SERVING, f"max_rel {max_rel}")


def reservoir_modes_phase(args, input_size: int, reps: int = 3):
    """Time the two reservoir scan schedules on the runner's widths
    (steps x nodes x layers x units) and check they agree."""
    res = Reservoir(input_size=input_size,
                    hidden_size=args.reservoir_size,
                    num_layers=args.reservoir_layers,
                    leaking_rate=args.leaking_rate,
                    spectral_radius=args.spectral_radius,
                    density=args.density, alpha_decay=args.alpha_decay,
                    input_scaling=args.input_scaling,
                    activation=args.reservoir_activation, seed=args.seed)
    x = jax.random.uniform(jax.random.PRNGKey(2), (
        args.synthetic_steps, args.synthetic_nodes, input_size),
        jnp.float32, -1.0, 1.0)
    times, outs = {}, {}
    for mode in ("sequential", "wavefront"):
        run = lambda: jax.block_until_ready(reservoir_scan(  # noqa: E731
            tuple(res.layers), res.activation, x, out_dtype=jnp.bfloat16,
            mode=mode))
        outs[mode] = run()                       # compile + warm up
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        times[mode] = statistics.median(ts)
    max_abs, max_rel = errors(outs["wavefront"][-64:],
                              outs["sequential"][-64:])
    faster = min(times, key=times.get)
    emit("reservoir_modes", steps=int(x.shape[0]), nodes=int(x.shape[1]),
         layers=args.reservoir_layers, units=args.reservoir_size,
         sequential_s=times["sequential"], wavefront_s=times["wavefront"],
         faster=faster, auto=AUTO_MODE, last64_max_abs=max_abs,
         last64_max_rel=max_rel, tol_rel=TOL_MODES)
    check("reservoir_modes", max_rel <= TOL_MODES, f"max_rel {max_rel}")


def packed_bytes(args) -> int:
    """Device bytes of the packed IID array the precompute path holds:
    ``T x N x (features + 3 x horizon steps x channels)`` bf16."""
    from sgp.data import Windowing
    h = Windowing(window=args.window, horizon=args.horizon,
                  horizon_lag=args.horizon_lag).horizon_steps
    lanes = derive_order(args) * args.reservoir_size + 3 * h
    return args.synthetic_steps * args.synthetic_nodes * lanes * 2


def trainer_phase(argv: list, epochs: int, batches_epoch: int,
                  bytes_limit: int):
    """The runner end to end. The packed precompute is taken when its
    array fits in 85% of the device limit, else the stratified path."""
    argv = list(argv) + ["--epochs", str(epochs),
                         "--batches-epoch", str(batches_epoch)]
    need = packed_bytes(parse_args(argv))
    if need > 0.85 * bytes_limit:
        argv += ["--iid-stratified", "true"]
    t0 = time.time()
    res = Experiment(run_experiment, configure_parser_largescale()).run(
        argv)
    wall = time.time() - t0
    losses, epoch_s = res["epoch_losses"], res["epoch_s"]
    stats = jax.devices()[0].memory_stats() or {}
    emit("trainer", path=res["path"], packed_bytes=need,
         bytes_limit=bytes_limit, compile_s=res["compile_s"],
         steady_batch_s=batches_epoch / statistics.median(epoch_s[1:]),
         epoch_s=epoch_s, epoch_losses=losses,
         test_mae=res.get("test_mae"),
         train_step_memory=res["train_step_memory"],
         peak_bytes_in_use=stats.get("peak_bytes_in_use"), wall_s=wall)
    check("trainer", all(map(math.isfinite, losses)), f"losses {losses}")
    check("trainer", losses[-1] < losses[0], f"loss did not fall {losses}")


def sharded_phase(argv: list, steps: int, epochs: int, batches_epoch: int):
    """Node-sharded encode (halo K-hop), fused IID training and eval on
    a 4-device mesh against the one-card encode and eval."""
    from sgp.parallel import (make_mesh, make_sharded_iid_eval,
                              make_sharded_iid_step)
    from sgp.parallel.encode import encode_series_sharded
    from sgp.train import MaskedMetrics
    from sgp.train.fused_window import make_fused_eval
    args = parse_args(argv, synthetic_steps=steps)
    n_dev = 4
    mesh = make_mesh(n_dev, 1, jax.devices()[:n_dev])
    ds, split = prepare_dataset(args)
    encoder = build_encoder(args, ds)
    x = encoder_input_array(ds, args.preprocess_exogenous)
    enc = encode_series_sharded(
        encoder.reservoir, x, ds.graph, mesh, k=args.receptive_field,
        undirected=args.undirected, add_loops=args.add_self_loops,
        bidirectional=args.bidirectional, global_attr=args.global_attr)
    shard_shapes = sorted({tuple(s.data.shape)
                           for s in enc.addressable_shards})
    with jax.default_matmul_precision("highest"):
        ref = streaming_encode(encoder, x, ds.graph, out_dtype=jnp.float32,
                               precision="highest")
    max_abs, max_rel = errors(enc, ref)
    quarter = [(enc.shape[0], enc.shape[1] // n_dev, enc.shape[2])]
    emit("sharded_encode", shape=list(enc.shape), shards=shard_shapes,
         max_abs=max_abs, max_rel=max_rel, tol_rel=TOL_SHARDED)
    check("sharded_encode", shard_shapes == quarter,
          f"shards {shard_shapes}, want {quarter}")
    check("sharded_encode", max_rel <= TOL_SHARDED, f"max_rel {max_rel}")

    enc = enc.astype(jnp.bfloat16)
    ref = ref.astype(jnp.bfloat16)
    rewire_exog_keys(ds, args.preprocess_exogenous, args.keep_raw)
    u = jnp.asarray(ds.exog_array(), jnp.float32)
    tgt = jnp.asarray(ds.target, jnp.float32)
    mask = jnp.asarray(ds.mask)
    h_off = jnp.asarray(ds.windowing.horizon_offsets())
    w_off = jnp.asarray(ds.windowing.window_offsets())
    d = int(enc.shape[-1])
    model = build_model(args, ds, d, int(u.shape[-1]))
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)), node_index=jnp.zeros(4, jnp.int32),
                        iid=True, u=jnp.zeros((4, int(u.shape[-1]))))
    optimizer = optax.chain(optax.clip_by_global_norm(args.grad_clip_val),
                            optax.adam(args.lr))
    opt_state = optimizer.init(params)
    step = make_sharded_iid_step(
        model, optimizer, enc, tgt, mask,
        jnp.asarray(ds.indices()[split.train]), h_off, ds.scaler_params(),
        mesh, u=u, batch_size=args.batch_size,
        steps_per_call=batches_epoch, packed=True)
    losses = []
    for e in range(epochs):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(100 + e))
        losses.append(float(loss))
    packed_shards = sorted({tuple(s.data.shape)
                            for s in step.data[0].addressable_shards})
    metrics = MaskedMetrics.forecasting()
    test = ds.indices()[split.test]
    sharded = make_sharded_iid_eval(
        model, step.data[0], None, None, test, w_off, h_off,
        ds.scaler_params(), metrics, mesh, u=step.data[-1],
        batch_size=args.batch_inference or 16, x_slice=d,
        unpack_targets=True, n_nodes=ds.n_nodes)(params)
    with jax.default_matmul_precision("highest"):
        single = make_fused_eval(
            model, ref, tgt, mask, test, w_off, h_off, ds.scaler_params(),
            metrics, u=u, batch_size=args.batch_inference or 16)(params)
    eval_rel = {k: abs(sharded[k] - single[k]) / max(abs(single[k]), 1e-30)
                for k in single}
    emit("sharded_train_eval", epoch_losses=losses,
         packed_shards=packed_shards, sharded_eval=sharded,
         one_card_eval=single, eval_max_rel=max(eval_rel.values()),
         tol_rel=TOL_EVAL)
    check("sharded_train_eval", all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"losses {losses}")
    check("sharded_train_eval",
          all(s[1] == enc.shape[1] // n_dev for s in packed_shards),
          f"packed shards {packed_shards}")
    check("sharded_train_eval", max(eval_rel.values()) <= TOL_EVAL,
          f"eval {eval_rel}")


def run_one_card(argv: list, bytes_limit: int, encoder_steps: int = 512,
                 epochs: int = 8, batches_epoch: int = 32):
    small = parse_args(argv, synthetic_steps=encoder_steps)
    ds, split, encoder = encoder_phase(small)
    iid_step_phase(small, ds, split, encoder)
    serving_phase(small, ds)
    input_size = encoder_input_size(small, ds)
    del ds, split, encoder
    gc.collect()
    reservoir_modes_phase(parse_args(argv), input_size)
    gc.collect()
    trainer_phase(argv, epochs, batches_epoch, bytes_limit)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the node-sharded path on four GPUs")
    opts = p.parse_args(argv)
    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: compile_s.append(secs)
        if name == "/jax/core/compile/backend_compile_duration" else None)
    device = device_phase(opts.chips)
    t0 = time.time()
    if opts.chips == 4:
        sharded_phase(PV_ARGV, steps=1024, epochs=4, batches_epoch=32)
    else:
        run_one_card(PV_ARGV,
                     jax.devices()[0].memory_stats()["bytes_limit"])
    emit("done", wall_s=time.time() - t0,
         backend_compile_s=sum(compile_s), programs_compiled=len(compile_s))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
