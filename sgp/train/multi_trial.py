"""Vmapped multi-trial fused IID training: K decoder trials in ONE
XLA program.

On-device hyperparameter search (the complement of ``exp/hyperopt.py``'s
worker pool, whose process-parallel trials must SERIALIZE on one
accelerator): the fused IID step is small next to the device, so
training K small decoders on the SAME sampled batch via ``jax.vmap``
amortizes
the row gather and the per-step dispatch across trials — ops that don't
depend on the vmapped axis (sampling, the packed-row gather) are
computed once, only the forward/backward/Adam batch over trials.
Sharing batches across trials also gives paired comparisons (lower
variance between trials than independent streams).

Vmappable trial axes: anything that doesn't change parameter shapes —
init seed and learning rate here (the reference's searchable lr/seed
axes, ``tsl/utils/experiment.py:54-83``); shape-changing axes
(hidden_size, ...) still go through ``exp/hyperopt.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data.scalers import ScalerParams
from sgp.train.iid import _build_iid_sample_and_loss


def init_trial_params(model, seeds, example_inputs: dict):
    """Stacked per-trial params: ``vmap(model.init)`` over per-trial
    PRNG seeds, jitted into one program (an eager per-trial init
    dispatches every op on its own). ``example_inputs`` are
    the kwargs/args for ``model.init`` (e.g. ``{"x": zeros[B, D],
    "node_index": ..., "iid": True}``); arrays are shared across trials.
    Returns a params pytree whose leaves carry a leading [K] axis."""
    seeds = jnp.asarray(seeds)

    @jax.jit
    def init_all(keys):
        def one(key):
            return model.init({"params": key, "dropout": key},
                              **example_inputs)
        return jax.vmap(one)(keys)

    return init_all(jax.vmap(jax.random.PRNGKey)(seeds))


def make_fused_iid_multi_trial_step(model,
                                    encoded, target, mask,
                                    valid_starts, horizon_offsets,
                                    scaler: ScalerParams,
                                    lrs,                    # [K]
                                    u=None,
                                    batch_size: int = 4096,
                                    grad_clip: float = 5.0,
                                    loss: str = "mae",
                                    scale_target: bool = False,
                                    steps_per_call: int = 1,
                                    packed: bool = False,
                                    compute_dtype=None,
                                    pipeline: bool = False,
                                    gather_block: int = 1) -> Callable:
    """Build ``step(params_stack, opt_stack, rng) -> (params_stack,
    opt_stack, losses[K])`` training all K trials on the same sampled
    batches. Per-trial optimizer is ``clip_by_global_norm(grad_clip) →
    adam(lr_k)`` — identical math to the single-trial runner's chain
    (adam == scale_by_adam + scale(-lr), applied per trial under vmap).

    ``step.init_opt(params_stack)`` builds the stacked optimizer state.
    The big arrays stay explicit jit arguments (never closure
    constants), exactly as in ``make_fused_iid_step``. ``pipeline``
    and ``compute_dtype`` mirror :func:`make_fused_iid_multi_step` —
    the shared gather is issued once per step and prefetched during
    the K vmapped fwd/bwd passes, which is exactly where the K-trial
    amortization pays.
    """
    lrs = jnp.asarray(lrs, jnp.float32)
    base = optax.chain(optax.clip_by_global_norm(grad_clip),
                       optax.scale_by_adam())
    data, sample_and_loss = _build_iid_sample_and_loss(
        model, encoded, target, mask, valid_starts, horizon_offsets,
        scaler, u=u, batch_size=batch_size, loss=loss,
        scale_target=scale_target, packed=packed,
        compute_dtype=compute_dtype, gather_block=gather_block)

    def trial_update(params, opt_state, lr, sampled, rng):
        loss_val, grads = jax.value_and_grad(sample_and_loss.loss)(
            params, sampled, rng)
        updates, opt_state = base.update(grads, opt_state, params)
        updates = jax.tree.map(lambda g: -lr * g, updates)
        return optax.apply_updates(params, updates), opt_state, loss_val

    # sampled/rng unbatched: the gather runs once, shared by all K
    v_update = jax.vmap(trial_update, in_axes=(0, 0, 0, None, None))

    @jax.jit
    def _multi(params, opt_state, rng, data):
        keys = jax.random.split(rng, max(steps_per_call, 1))

        if pipeline:
            first = sample_and_loss.sample(keys[0], data)

            def body(carry, key_pair):
                p, s, sampled = carry
                key_cur, key_next = key_pair
                p, s, losses = v_update(p, s, lrs, sampled, key_cur)
                nxt = sample_and_loss.sample(key_next, data)
                return (p, s, nxt), losses

            key_pairs = (keys, jnp.roll(keys, -1, axis=0))
            (params, opt_state, _), losses = jax.lax.scan(
                body, (params, opt_state, first), key_pairs)
        else:
            def body(carry, key):
                p, s = carry
                sampled = sample_and_loss.sample(key, data)
                p, s, losses = v_update(p, s, lrs, sampled, key)
                return (p, s), losses

            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), keys)
        return params, opt_state, losses.mean(0)          # [K]

    def step(params, opt_state, rng):
        return _multi(params, opt_state, rng, data)

    @jax.jit
    def init_opt(params_stack):
        return jax.vmap(base.init)(params_stack)

    step.init_opt = init_opt
    step.core = _multi
    step.data = data
    return step


def eval_trials(eval_fn, params_stack):
    """Evaluate all K trials through a ``make_fused_eval`` callable in
    ONE program: vmap its jitted core over the stacked params (the
    window gathers don't depend on params — computed once). Per-trial
    metrics come from the suite's own ``compute`` so the reduction can
    never diverge from single-trial evaluation. Returns
    ``{metric: np.ndarray[K]}``."""
    states = jax.jit(jax.vmap(eval_fn.core, in_axes=(0, None)))(
        params_stack, eval_fn.data)
    k = jax.tree_util.tree_leaves(states)[0].shape[0]
    per = [eval_fn.metrics.compute(take_trial(states, i))
           for i in range(k)]
    return {name: np.asarray([p[name] for p in per]) for name in per[0]}


def best_trial(metrics_per_trial: dict, monitor: str = "mae",
               minimize: bool = True) -> int:
    vals = np.asarray(metrics_per_trial[monitor])
    return int(np.argmin(vals) if minimize else np.argmax(vals))


def take_trial(tree, k: int):
    """Slice trial ``k``'s params/opt-state out of a stacked pytree."""
    return jax.tree.map(lambda a: a[k], tree)
