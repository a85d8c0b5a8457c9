"""Vmapped multi-trial fused IID training: each trial of the stacked
step must reproduce an independent single-trial run exactly (same
batches, same optimizer math), and the stacked eval must match
per-params fused eval."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sgp.data import ScalerParams
from sgp.models import SGPModel
from sgp.train.fused_window import make_fused_eval
from sgp.train.iid import make_fused_iid_step
from sgp.train.multi_trial import (best_trial, eval_trials,
                                   init_trial_params,
                                   make_fused_iid_multi_trial_step,
                                   take_trial)
from sgp.train.metrics import MaskedMetrics

pytestmark = pytest.mark.slow


def _setup(rng, t=60, n=10, d=6, h=2):
    encoded = jnp.asarray(rng.standard_normal((t, n, d)).astype(np.float32))
    target = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    mask = jnp.asarray(rng.random((t, n, 1)) > 0.1)
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=12,
                     mlp_size=8, output_size=1, n_layers=1, horizon=h,
                     positional_encoding=True)
    valid = jnp.arange(t - h - 1)
    h_off = 1 + jnp.arange(h)
    scaler = ScalerParams(jnp.zeros(1), 2.0 * jnp.ones(1))
    return encoded, target, mask, model, valid, h_off, scaler


def test_init_trial_params_matches_per_seed(rng):
    _, _, _, model, _, _, _ = _setup(rng)
    seeds = [3, 7, 11]
    ex = {"x": jnp.zeros((4, 6)),
          "node_index": jnp.zeros(4, jnp.int32), "iid": True}
    stack = init_trial_params(model, seeds, ex)
    for k, s in enumerate(seeds):
        key = jax.random.PRNGKey(s)
        ref = model.init({"params": key, "dropout": key}, **ex)
        got = take_trial(stack, k)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("packed", [False, True])
def test_multi_trial_matches_single_trials(rng, packed):
    """Trial k of the vmapped step == make_fused_iid_step with
    clip+adam(lr_k) from the same init and the same RNG stream."""
    enc, tgt, msk, model, valid, h_off, scaler = _setup(rng)
    if packed:
        enc = enc.astype(jnp.bfloat16)
    lrs = [1e-2, 1e-3, 3e-3]
    seeds = [0, 1, 2]
    ex = {"x": jnp.zeros((4, 6)),
          "node_index": jnp.zeros(4, jnp.int32), "iid": True}
    stack = init_trial_params(model, seeds, ex)
    step = make_fused_iid_multi_trial_step(
        model, enc, tgt, msk, valid, h_off, scaler, lrs,
        batch_size=16, steps_per_call=3, packed=packed)
    opt_stack = step.init_opt(stack)
    key = jax.random.PRNGKey(9)
    p2, s2, losses = step(stack, opt_stack, key)
    assert losses.shape == (3,)

    keys = jax.random.split(key, 3)     # the scanned per-step keys
    for k, (lr, seed) in enumerate(zip(lrs, seeds)):
        opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
        single = make_fused_iid_step(
            model, opt, enc, tgt, msk, valid, h_off, scaler,
            batch_size=16, packed=packed)
        kp = jax.random.PRNGKey(seed)
        p = model.init({"params": kp, "dropout": kp}, **ex)
        s = opt.init(p)
        ls = []
        for kk in keys:
            p, s, l = single.core(p, s, kk, single.data)
            ls.append(float(l))
        np.testing.assert_allclose(float(losses[k]), np.mean(ls),
                                   rtol=1e-6)
        got = take_trial(p2, k)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(p)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)


def test_eval_trials_matches_per_params(rng):
    enc, tgt, msk, model, valid, h_off, scaler = _setup(rng)
    seeds = [4, 5]
    ex = {"x": jnp.zeros((2, 1, 10, 6))}
    stack = init_trial_params(model, seeds, ex)
    metrics = MaskedMetrics.forecasting()
    ev = make_fused_eval(model, enc, tgt, msk, np.arange(40),
                         np.array([0]), np.asarray(h_off), scaler,
                         metrics, batch_size=8)
    got = eval_trials(ev, stack)
    assert got["mae"].shape == (2,)
    for k in range(2):
        ref = ev(take_trial(stack, k))
        for name in ref:
            np.testing.assert_allclose(got[name][k], ref[name],
                                       rtol=1e-5, err_msg=name)
    assert best_trial(got, "mae") in (0, 1)
