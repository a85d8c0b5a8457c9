"""Imputation training engine.

Counterpart of ``tsl/imputers/imputer.py:11-229`` (unused by the
reference experiments, kept for capability parity): trains an imputation
model (e.g. :class:`~sgp.models.grin.GRINModel`) with
*whiten-masked* batches — a random fraction of observed points is hidden
at train time and the loss computed on those plus the synthetic eval
mask; window edges can be trimmed from the loss
(``prediction_loss_weight`` / ``warm_up`` semantics).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from sgp.train.metrics import _abs_err, _masked_reduce


def split_imputation_output(out):
    """Normalize an imputation model's output to
    ``(merged_imputation, aux_predictions)``.

    Models may return the imputed series alone (RNNI), or a tuple whose
    first element is the merged imputation and whose remaining leaves
    are auxiliary one-step/stage predictions trained with
    ``prediction_loss_weight`` (GRIN returns
    ``(merged, (imp_f, pred_f), (imp_b, pred_b))``; BiRNNI returns
    ``(merged, (fwd, bwd))``) — the ``imputer.py`` training_step
    semantics of "loss on the imputation plus weighted loss on every
    extra output".
    """
    if isinstance(out, (tuple, list)):
        return out[0], jax.tree.leaves(list(out[1:]))
    return out, []


def make_imputer_train_step(model, optimizer, batch_to_call: Callable,
                            whiten_prob: float = 0.05,
                            prediction_loss_weight: float = 1.0,
                            warm_up: int = 0):
    """Build ``step(params, opt_state, batch, rng)``.

    The loss sums the merged imputation error and the error of every
    auxiliary prediction the model returns (see
    :func:`split_imputation_output`), each weighted by
    ``prediction_loss_weight`` (``imputer.py`` training_step
    semantics).
    """

    def loss_fn(params, batch, rng):
        x, mask = batch["x"], batch["mask"].astype(bool)
        # whitening: hide a random subset of observed points
        rng_w, rng_d, rng_s, rng_c = jax.random.split(rng, 4)
        keep = jax.random.uniform(rng_w, mask.shape) > whiten_prob
        train_mask = mask & keep
        target_mask = mask & ~keep
        batch_in = dict(batch)
        batch_in["x"] = jnp.where(train_mask, x, 0.0)
        batch_in["mask"] = train_mask
        args, kwargs = batch_to_call(batch_in, True)
        # state_init/state_init_c serve RNNI ``state_init='noise'``
        # hidden-state draws (rnni.py::_init_carry); unused rng streams
        # are harmless for models that never call make_rng on them
        out = model.apply(params, *args,
                          rngs={"dropout": rng_d, "state_init": rng_s,
                                "state_init_c": rng_c}, **kwargs)
        merged, aux = split_imputation_output(out)
        # ground truth: ImputationDataset.gather_batch's ``y`` (raw
        # window; at eval_mask points x is zeroed, y holds the value)
        y = batch.get("y", x)

        def trimmed(v):
            return v[:, warm_up:] if warm_up else v

        lm = trimmed(target_mask | (~mask & batch.get(
            "eval_mask", jnp.zeros_like(mask)).astype(bool)))
        total = 0.0
        for pred, w in [(merged, 1.0)] + [(p, prediction_loss_weight)
                                          for p in aux]:
            v, n = _masked_reduce(_abs_err, trimmed(pred), trimmed(y), lm)
            total = total + w * v / jnp.maximum(n, 1.0)
        return total

    @jax.jit
    def step(params, opt_state, batch, rng):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, rng)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
