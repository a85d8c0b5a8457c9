"""Restartable checkpoints + determinism (SURVEY.md §5.2: same seed ->
same result serves as the race-detection analog)."""
import numpy as np
import pytest

from sgp.data import (SpatioTemporalDataset, StandardScaler,
                      WindowedLoader, Windowing)
from sgp.models import SGPModel
from sgp.train import Predictor


def make_setup(rng, seed=0):
    data = rng.standard_normal((80, 6, 1)).astype(np.float32)
    enc = rng.standard_normal((80, 6, 8)).astype(np.float32)
    ds = SpatioTemporalDataset(data, windowing=Windowing(window=1,
                                                         horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    ds.add_covariate("encoded_x", enc)
    ds.set_input_keys(["encoded_x"])
    model = SGPModel(input_size=8, order=2, n_nodes=6, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False, dropout=0.1)
    pred = Predictor(model, lr=1e-2, seed=seed)
    loader = WindowedLoader(ds, batch_size=16, shuffle=True, seed=seed)
    return ds, pred, loader


def test_training_is_deterministic(rng):
    rng_a = np.random.default_rng(7)
    rng_b = np.random.default_rng(7)
    ds1, p1, l1 = make_setup(rng_a, seed=4)
    ds2, p2, l2 = make_setup(rng_b, seed=4)
    loss1 = [p1.fit(l1, epochs=2, scaler=ds1.scaler_params(), log_every=0)]
    loss2 = [p2.fit(l2, epochs=2, scaler=ds2.scaler_params(), log_every=0)]
    assert loss1 == loss2
    out1 = p1.predict(WindowedLoader(ds1, batch_size=16))
    out2 = p2.predict(WindowedLoader(ds2, batch_size=16))
    np.testing.assert_array_equal(out1, out2)


def test_resume_matches_uninterrupted(rng, tmp_path):
    """2 epochs straight == 1 epoch + checkpoint + resume + 1 epoch."""
    rng_a = np.random.default_rng(3)
    rng_b = np.random.default_rng(3)
    path = str(tmp_path / "state.pkl")

    # uninterrupted: 2 epochs
    ds1, p1, l1 = make_setup(rng_a, seed=9)
    p1.fit(l1, epochs=1, scaler=ds1.scaler_params(), log_every=0)
    p1.train_epoch(l1)
    ref = p1.predict(WindowedLoader(ds1, batch_size=16))

    # interrupted: 1 epoch, save, new predictor, load, 1 epoch
    ds2, p2, l2 = make_setup(rng_b, seed=9)
    p2.fit(l2, epochs=1, scaler=ds2.scaler_params(), log_every=0)
    p2.save_state(path, epoch=1)
    ds3, p3, l3 = make_setup(np.random.default_rng(3), seed=9)
    p3.fit(l3, epochs=0, scaler=ds3.scaler_params(), log_every=0)  # init
    extra = p3.load_state(path)
    assert extra["epoch"] == 1
    # loader RNG state: recreate a loader that has advanced one epoch
    next(iter(l3))  # not exact loader state; use l2's advanced loader
    p3.train_epoch(l2)
    out = p3.predict(WindowedLoader(ds2, batch_size=16))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_load_state_asserts_hparam_match(rng, tmp_path):
    """Reloading a checkpoint into a model with different hparams raises
    (parity: ``tsl/predictors/base_predictor.py:89-96``)."""
    import pytest

    path = str(tmp_path / "state.pkl")
    ds, p, l = make_setup(np.random.default_rng(1), seed=2)
    p.fit(l, epochs=1, scaler=ds.scaler_params(), log_every=0)
    p.save_state(path, epoch=1)
    # same-config reload works
    p.load_state(path)
    # different decoder width -> rejected
    other = SGPModel(input_size=8, order=2, n_nodes=6, hidden_size=32,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False, dropout=0.1)
    p_other = Predictor(other, lr=1e-2, seed=2)
    p_other.fit(l, epochs=0, scaler=ds.scaler_params(), log_every=0)
    with pytest.raises(ValueError, match="hidden_size"):
        p_other.load_state(path)


def test_fit_rejects_unknown_monitor(rng):
    import pytest

    ds, p, l = make_setup(np.random.default_rng(1), seed=2)
    with pytest.raises(ValueError, match="monitor"):
        p.fit(l, val_loader=l, epochs=1, monitor="nope",
              scaler=ds.scaler_params(), log_every=0)


def test_async_checkpointer_matches_sync(rng, tmp_path):
    """AsyncCheckpointer writes the same restorable state the
    synchronous path writes, and serializes one-save-at-a-time."""
    import jax
    import jax.numpy as jnp
    import optax

    from sgp.models.sgp import SGPModel
    from sgp.train.checkpoint import (AsyncCheckpointer,
                                      restore_run_state)

    model = SGPModel(input_size=8, order=2, n_nodes=6, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=False, dropout=0.0)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, 8)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    path = str(tmp_path / "async.ckpt")
    ck = AsyncCheckpointer()
    for epoch in range(3):   # consecutive saves join their predecessor
        ck.save(path, model, params, opt_state, key, epoch,
                0.5 - epoch * 0.1, params, elapsed_s=1.0,
                train_config={"lr": 1e-3})
    ck.wait()
    (p2, s2, rng2, start, best, bp, el) = restore_run_state(
        path, model, params, opt_state, train_config={"lr": 1e-3})
    assert start == 3 and abs(best - 0.3) < 1e-9
    for a, b in zip(jax.tree_util.tree_leaves(p2),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_checkpointer_raises_writer_error(tmp_path):
    from sgp.train.checkpoint import AsyncCheckpointer

    def boom(*a, **k):
        raise RuntimeError("disk full")

    ck = AsyncCheckpointer(save_fn=boom)
    ck.save("x")
    with pytest.raises(RuntimeError, match="disk full"):
        ck.wait()
    # the error does not stick to the next save
    ok = AsyncCheckpointer(save_fn=lambda *a, **k: None)
    ok.save("y")
    ok.wait()


def test_tree_bytes_round_trip_and_mismatch():
    """Pytrees (params, optax state, bf16 leaves) survive the path-keyed
    numpy archive exactly; a template with another shape or leaf set is
    refused."""
    import jax
    import jax.numpy as jnp
    import optax

    from sgp.train.checkpoint import tree_from_bytes, tree_to_bytes
    params = {"a": {"kernel": jnp.arange(6.0).reshape(2, 3)},
              "b": jnp.ones(4, jnp.bfloat16)}
    opt_state = optax.adam(1e-3).init(params)
    tree = {"params": params, "opt": opt_state}
    back = tree_from_bytes(tree, tree_to_bytes(tree))
    for x, y in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    data = tree_to_bytes(params)
    with pytest.raises(ValueError, match="shape"):
        tree_from_bytes({**params, "b": jnp.ones(5, jnp.bfloat16)}, data)
    with pytest.raises(ValueError, match="no leaf"):
        tree_from_bytes({**params, "c": jnp.ones(1)}, data)
    with pytest.raises(ValueError, match="not in the template"):
        tree_from_bytes({"a": params["a"]}, data)
