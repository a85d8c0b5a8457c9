"""Training engine: jitted train/eval steps + fit loop.

Counterpart of the reference's Lightning ``Predictor``
(``tsl/predictors/base_predictor.py:12-320``) re-built around JAX:
one jitted, donated train step (forward, masked loss, grad-clip, Adam,
MultiStep LR), metric accumulation on device, best-checkpoint tracking
and early stopping on a monitored metric.

Loss semantics (``base_predictor.py:243-265``): with
``scale_target=False`` (default) the model output is inverse-transformed
and the loss computed in the raw data space; with ``scale_target=True``
the loss is computed in scaled space. Metrics are always raw-space.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data.scalers import ScalerParams
from sgp.train.metrics import MaskedMetrics, _METRIC_FNS, _masked_reduce
from sgp.utils.logging import logger


def default_batch_to_call(batch, training: bool):
    """Generic call adapter: ``(args, kwargs)`` for the model from a
    batch — x (+u, node_index, iid when present). Models needing graph
    operators supply their own adapter (the experiment runners do)."""
    kwargs = {"training": training}
    if "u" in batch:
        kwargs["u"] = batch["u"]
    if "node_index" in batch:
        kwargs["node_index"] = batch["node_index"]
        if np.ndim(batch["node_index"]) == 1 and batch["x"].ndim <= 3:
            kwargs["iid"] = True
    return (batch["x"],), kwargs


class Predictor:
    def __init__(self, model,
                 loss: str = "mae",
                 lr: float = 1e-3,
                 weight_decay: float = 0.0,
                 grad_clip: float = 5.0,
                 lr_milestones: Optional[list] = None,
                 lr_gamma: float = 0.25,
                 steps_per_epoch: int = 1,
                 scale_target: bool = False,
                 metrics: Optional[MaskedMetrics] = None,
                 batch_to_call: Optional[Callable] = None,
                 seed: int = 0,
                 mesh=None,
                 static_batch: Optional[dict] = None,
                 compute_dtype: Optional[str] = None):
        """``mesh``: a ``jax.sharding.Mesh`` with a ``data`` axis turns
        every loader-based step data-parallel — batches are sharded
        along the sample dim, params/optimizer replicated, and XLA's
        SPMD partitioner inserts the gradient/metric reductions. Works
        for ANY model/batch layout the Predictor handles (incl.
        subgraph batches); ragged tail batches fall back to replicated
        placement (identical math).

        ``static_batch``: per-run graph state (dense supports, [N, N]
        adjacency masks, ELL neighbor tables, edge lists) merged into
        EVERY batch before the jitted step, so the arrays trace as step
        ARGUMENTS. Closure-capturing them in ``batch_to_call`` instead
        embeds them as HLO constants — at Table-2 scale that stalls
        XLA constant folding for minutes. Keys already present in a
        batch win.

        ``compute_dtype`` (e.g. ``'bfloat16'``): mixed-precision steps
        — f32 master params/optimizer, but the forward/backward runs
        with params AND float batch inputs cast to this dtype (the
        cast's gradient accumulates f32 at the boundary). Halves the
        HBM traffic of bandwidth-bound stacks; loss/metrics stay f32
        and norm layers keep f32 statistics internally
        (``models/tcn.py::Norm``)."""
        self.model = model
        self.mesh = mesh
        self.compute_dtype = (None if compute_dtype is None
                              else jnp.dtype(compute_dtype))
        self.static_batch = {
            k: jax.tree.map(jnp.asarray, v)
            for k, v in (static_batch or {}).items()}
        self._static_placed = None   # mesh-replicated cache (_place)
        self.loss_kind = loss
        self.scale_target = scale_target
        self.metrics = metrics or MaskedMetrics.forecasting()
        self.batch_to_call = batch_to_call or default_batch_to_call
        self.rng = jax.random.PRNGKey(seed)
        self.params = None
        self.opt_state = None
        if lr_milestones:
            schedule = optax.piecewise_constant_schedule(
                lr, {int(m * steps_per_epoch): lr_gamma
                     for m in lr_milestones})
        else:
            schedule = lr
        if weight_decay > 0:
            opt = optax.adamw(schedule, weight_decay=weight_decay)
        else:
            opt = optax.adam(schedule)
        self.optimizer = optax.chain(
            optax.clip_by_global_norm(grad_clip), opt)
        self._train_step = None
        self._eval_step = None

    # -- setup -------------------------------------------------------------
    def init(self, batch, scaler: ScalerParams):
        batch = _to_device({**self.static_batch, **batch})
        self.rng, init_rng, drop_rng = jax.random.split(self.rng, 3)
        args, kwargs = self.batch_to_call(batch, training=False)
        # jit the init into ONE program (an eager init dispatches every
        # op of the forward pass on its own)
        def _is_static(v):
            """Python scalars and (nested) tuples of them — e.g. the
            GatedGN ``adj_band`` window table — stay trace-time
            constants; arrays trace as arguments."""
            if isinstance(v, (bool, int, float, str, type(None),
                              np.generic)):
                return True
            return isinstance(v, tuple) and all(_is_static(x)
                                                for x in v)

        static_kw = {k: v for k, v in kwargs.items() if _is_static(v)}
        dyn_kw = {k: v for k, v in kwargs.items() if k not in static_kw}

        @jax.jit
        def _init(rngs, args, dyn_kw):
            return self.model.init(rngs, *args, **dyn_kw, **static_kw)

        self.params = _init({"params": init_rng, "dropout": drop_rng},
                            args, dyn_kw)
        self.opt_state = self.optimizer.init(self.params)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            repl = NamedSharding(self.mesh, PartitionSpec())
            put = lambda t: jax.tree.map(
                lambda p: jax.device_put(p, repl), t)
            self.params = put(self.params)
            self.opt_state = put(self.opt_state)
        n_params = sum(int(np.prod(p.shape))
                       for p in jax.tree_util.tree_leaves(self.params))
        logger.info(f"Initialized model with {n_params:,} parameters")
        self._build_steps(scaler)
        return self

    def _build_steps(self, scaler: ScalerParams):
        model, to_call = self.model, self.batch_to_call
        cdt = self.compute_dtype

        def cast(tree):
            return jax.tree.map(
                lambda a: a.astype(cdt)
                if getattr(a, "dtype", None) == jnp.float32 else a, tree)

        def fwd(model, params, batch, training, rng):
            args, kwargs = to_call(batch, training)
            rngs = {"dropout": rng} if training else {}
            if cdt is not None:
                # mixed precision: bf16 fwd/bwd, f32 master params.
                # The cast's VJP upcasts grads to f32 at the boundary.
                params, args, kwargs = (cast(params), cast(args),
                                        cast(kwargs))
            out = model.apply(params, *args, rngs=rngs, **kwargs)
            if cdt is not None:
                out = out.astype(jnp.float32)
            return out
        loss_fn_pt = _METRIC_FNS[self.loss_kind]
        scale_target = self.scale_target
        metrics = self.metrics

        def slice_targets(batch, y_hat):
            """Root-only loss for subgraph batches
            (``lib/predictors/subgraph_predictor.py:14-15``)."""
            y, mask = batch["y"], batch.get("mask")
            if "target_nodes" in batch:
                tn = batch["target_nodes"]
                y_hat = jnp.take(y_hat, tn, axis=-2)
                y = jnp.take(y, tn, axis=-2)
                mask = None if mask is None else jnp.take(mask, tn, axis=-2)
            return y_hat, y, mask

        def compute_loss(params, batch, rng):
            y_hat = fwd(model, params, batch, True, rng)
            y_hat, y, mask = slice_targets(batch, y_hat)
            sc = batch.get("scaler", scaler)
            if scale_target:
                y_ref = sc.transform(y)
            else:
                y_hat = sc.inverse_transform(y_hat)
                y_ref = y
            v, n = _masked_reduce(loss_fn_pt, y_hat, y_ref, mask)
            return v / jnp.maximum(n, 1.0)

        @jax.jit
        def train_step(params, opt_state, batch, rng):
            loss, grads = jax.value_and_grad(compute_loss)(
                params, batch, rng)
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        @jax.jit
        def eval_step(params, state, batch):
            y_hat = fwd(model, params, batch, False, None)
            y_hat, y, mask = slice_targets(batch, y_hat)
            sc = batch.get("scaler", scaler)
            y_hat = sc.inverse_transform(y_hat)
            return metrics.update(state, y_hat, y, mask)

        @jax.jit
        def predict_step(params, batch):
            y_hat = fwd(model, params, batch, False, None)
            sc = batch.get("scaler", scaler)
            return sc.inverse_transform(y_hat)

        self._train_step = train_step
        self._eval_step = eval_step
        self._predict_step = predict_step

    # Batch entries whose leading dim is the SAMPLE dim (shardable for
    # DP). Everything else (node_index, target_nodes, sub_* edge arrays,
    # scalers) is shared per-batch state and replicates — membership is
    # by key, not by shape, so a subgraph array whose length happens to
    # coincide with the batch size is never mis-sharded.
    _SAMPLE_DIM_KEYS = frozenset(
        {"x", "y", "mask", "u", "u_horizon", "eval_mask"})

    # -- loops -------------------------------------------------------------
    def _place(self, batch):
        """Host batch -> device: sample-dim entries (``_SAMPLE_DIM_KEYS``)
        shard over the mesh's ``data`` axis, everything else (shared
        per-batch subgraph arrays, node_index, scalers) replicates.
        Ragged tail batches replicate entirely — identical math, XLA
        just skips the partitioning. No mesh: plain device arrays."""
        if self.static_batch and self.mesh is None:
            batch = {**self.static_batch, **batch}
        if self.mesh is None:
            return _to_device(batch)
        from jax.sharding import NamedSharding, PartitionSpec as P
        n = self.mesh.shape["data"]
        b = np.shape(batch["x"])[0]
        if self.static_batch and self._static_placed is None:
            # place the per-run graph state (dense supports, [N, N]
            # adjacency) ONCE — re-device_putting it per batch would
            # re-broadcast up to hundreds of MB every step
            repl = NamedSharding(self.mesh, P())
            self._static_placed = {
                k: jax.tree.map(lambda p: jax.device_put(
                    jnp.asarray(p), repl), v)
                for k, v in self.static_batch.items()}

        def put(k, v):
            if not isinstance(v, (np.ndarray, jax.Array)):
                # non-array batch state (ScalerParams, operator pytrees,
                # index tuples): replicate leaf-wise
                return jax.tree.map(
                    lambda p: jax.device_put(
                        jnp.asarray(p), NamedSharding(self.mesh, P())), v)
            arr = jnp.asarray(v)
            spec = P("data", *([None] * (arr.ndim - 1))) \
                if (k in self._SAMPLE_DIM_KEYS and b % n == 0
                    and arr.ndim and arr.shape[0] == b) \
                else P()
            return jax.device_put(arr, NamedSharding(self.mesh, spec))

        placed = {k: put(k, v) for k, v in batch.items()}
        if self.static_batch:
            placed = {**self._static_placed, **placed}
        return placed

    def _check_dp_batch_size(self, loader):
        """DP must actually shard: a batch size not divisible by the
        device count would silently replicate EVERY batch (the
        replicated fallback exists for the ragged tail only)."""
        if self.mesh is None:
            return
        n = self.mesh.shape["data"]
        bs = getattr(loader, "batch_size", None)
        if bs is not None and bs % n:
            raise ValueError(
                f"Predictor DP: batch_size ({bs}) must be divisible by "
                f"the mesh's data-axis size ({n}) — otherwise every "
                f"batch falls back to fully-replicated execution")

    def train_epoch(self, loader) -> float:
        assert self.params is not None, "call init() first"
        self._check_dp_batch_size(loader)
        total, count = 0.0, 0
        for batch in loader:
            self.rng, step_rng = jax.random.split(self.rng)
            self.params, self.opt_state, loss = self._train_step(
                self.params, self.opt_state, self._place(batch), step_rng)
            total += float(loss)
            count += 1
        return total / max(count, 1)

    def evaluate(self, loader, prefix: str = "") -> Dict[str, float]:
        state = self.metrics.init()
        for batch in loader:
            state = self._eval_step(self.params, state, self._place(batch))
        out = self.metrics.compute(state)
        return {f"{prefix}{k}": v for k, v in out.items()}

    def predict(self, loader) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self._predict_step(self.params, self._place(b)))
             for b in loader], axis=0)

    def predict_loader(self, loader):
        """Predictions + targets + mask over a loader
        (``base_predictor.py:183-211`` predict_loader). Returns
        ``(y, y_hat, mask)`` numpy arrays concatenated over batches."""
        ys, yhs, ms = [], [], []
        for b in loader:
            db = self._place(b)
            yhs.append(np.asarray(self._predict_step(self.params, db)))
            ys.append(np.asarray(b["y"]))
            ms.append(None if b.get("mask") is None
                      else np.asarray(b["mask"]))
        mask = None if ms[0] is None else np.concatenate(ms, 0)
        return (np.concatenate(ys, 0), np.concatenate(yhs, 0), mask)

    def fit(self, train_loader, val_loader=None, epochs: int = 1,
            patience: Optional[int] = None, monitor: str = "mae",
            log_every: int = 1, scaler: Optional[ScalerParams] = None,
            logdir: Optional[str] = None):
        if self.params is None:
            first = next(iter(train_loader))
            self.init(first, scaler if scaler is not None
                      else ScalerParams(jnp.zeros(1), jnp.ones(1)))
        if val_loader is not None and monitor not in self.metrics.names:
            raise ValueError(
                f"monitor={monitor!r} is not a tracked metric; "
                f"available: {sorted(self.metrics.names)}")
        run_logger = None
        if logdir is not None:
            from sgp.obs.run_logger import RunLogger
            run_logger = RunLogger(logdir)
        best_metric, best_params, bad_epochs = np.inf, self.params, 0
        for epoch in range(epochs):
            t0 = time.time()
            train_loss = self.train_epoch(train_loader)
            logs = {"train_loss": train_loss}
            if val_loader is not None:
                logs.update(self.evaluate(val_loader, prefix="val_"))
                current = logs[f"val_{monitor}"]
            else:
                current = train_loss
            if run_logger is not None:
                run_logger.log_metrics(logs, step=epoch)
            if current < best_metric:
                best_metric, best_params, bad_epochs = current, \
                    self.params, 0
            else:
                bad_epochs += 1
            if log_every and epoch % log_every == 0:
                msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items())
                logger.info(f"epoch {epoch}: {msg} "
                            f"({time.time() - t0:.1f}s)")
            if patience is not None and bad_epochs > patience:
                logger.info(f"early stop at epoch {epoch}")
                break
        if run_logger is not None:
            run_logger.close()
        self.params = best_params  # restore best checkpoint
        return best_metric

    # -- checkpoint --------------------------------------------------------
    def save_state(self, path: str, epoch: int = 0,
                   best_metric: float = float("inf")):
        """Full restartable state: params + optimizer + RNG + progress
        (SURVEY.md §5.4)."""
        from sgp.train.checkpoint import model_config, save_train_state
        save_train_state(path, self.params, self.opt_state, self.rng,
                         extra={"epoch": epoch,
                                "best_metric": best_metric,
                                "model_config": model_config(self.model)})

    def load_state(self, path: str):
        from sgp.train.checkpoint import load_train_state
        assert self.params is not None, "init() before load_state()"
        params, opt_state, rng, extra = load_train_state(
            path, self.params, self.opt_state, model=self.model)
        self.params = params
        if opt_state is not None:
            self.opt_state = opt_state
        if rng is not None:
            self.rng = rng
        return extra

    def save(self, path: str):
        from sgp.train.checkpoint import tree_to_bytes
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fp:
            fp.write(tree_to_bytes(self.params))

    def load(self, path: str):
        from sgp.train.checkpoint import tree_from_bytes
        assert self.params is not None, "init() before load()"
        with open(path, "rb") as fp:
            self.params = tree_from_bytes(self.params, fp.read())
        return self


def _to_device(batch):
    """numpy batch dict -> device arrays (scaler params pass through).
    Values may be pytrees (e.g. a list of operators riding in the batch
    so their [N, N] arrays trace as step ARGUMENTS instead of becoming
    HLO constants that XLA would embed and fold)."""
    out = {}
    for k, v in batch.items():
        out[k] = v if isinstance(v, ScalerParams) else jax.tree.map(
            jnp.asarray, v)
    return out
