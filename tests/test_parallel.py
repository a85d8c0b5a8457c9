"""Multi-chip sharding on the 8-device virtual CPU mesh: sharded
propagation == single-device result; DP/TP train step runs; sharded
ridge == dense solve (SURVEY.md §4c determinism-across-shardings)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.ops import build_operator
from sgp.parallel import (make_mesh, shard_batch, shard_operator,
                          shard_params_tp, sharded_ridge, sharded_spmm)

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(len(jax.devices()) < 8,
                                 reason="needs 8 virtual devices")]


def graph(rng, n=32):
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, 200), rng.integers(0, n, 200),
        rng.random(200).astype(np.float32), n)), "row")


def test_sharded_spmm_matches_single_device(rng):
    g = graph(rng)
    mesh = make_mesh(2, 4)
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((32, 16)).astype(np.float32))
    expect = np.asarray(op @ x)
    op_s = shard_operator(op, mesh)
    with mesh:
        out = jax.jit(lambda x: sharded_spmm(op_s, x, mesh))(x)
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)


def test_sharded_khop_matches(rng):
    g = graph(rng)
    mesh = make_mesh(4, 2)
    op = build_operator(g, "dense")
    x = jnp.asarray(rng.standard_normal((5, 32, 8)).astype(np.float32))
    expect = np.asarray(op @ (op @ x))
    op_s = shard_operator(op, mesh)

    @jax.jit
    def khop(x):
        return sharded_spmm(op_s, sharded_spmm(op_s, x, mesh), mesh)

    with mesh:
        out = khop(x)
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)


def test_dp_tp_train_step_matches_single_device(rng):
    """The full dryrun path: same batch, same init -> sharded loss equals
    single-device loss."""
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)  # asserts finiteness internally


def test_sharded_ridge_matches_dense(rng):
    from sgp.train import ridge_regression
    mesh = make_mesh(8, 1)
    x = rng.standard_normal((800, 12)).astype(np.float32)
    y = rng.standard_normal((800, 2)).astype(np.float32)
    w_ref, _ = ridge_regression(x, y, alpha=0.3, fit_intercept=False)
    with mesh:
        w = sharded_ridge(jnp.asarray(x), jnp.asarray(y), 0.3, mesh)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), atol=1e-3)


def test_shard_batch_shapes(rng):
    mesh = make_mesh(8, 1)
    batch = {"x": rng.standard_normal((16, 4)).astype(np.float32),
             "y": rng.standard_normal((16, 2, 1)).astype(np.float32)}
    sharded = shard_batch(batch, mesh)
    assert sharded["x"].shape == (16, 4)
    # each device holds 1/8 of the batch
    assert len(sharded["x"].addressable_shards) == 8
    assert sharded["x"].addressable_shards[0].data.shape == (2, 4)


def _iid_setup(rng, t=100, n=16, d=8):
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel

    encoded = jnp.asarray(rng.standard_normal((t, n, d)).astype(np.float32))
    target = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    mask = jnp.asarray(rng.random((t, n, 1)) > 0.1)
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    scaler = ScalerParams(jnp.zeros(1), jnp.ones(1))
    return encoded, target, mask, model, params, opt, scaler


def test_sharded_iid_step_runs_and_is_replicated(rng):
    """DP fused IID step over the data axis: executes, loss finite, and
    params remain bit-identical across devices after the update."""
    from sgp.parallel.sharding import make_sharded_iid_step

    mesh = make_mesh(8, 1)
    t, n = 100, 16
    encoded, target, mask, model, params, opt, scaler = _iid_setup(rng)
    key = jax.random.PRNGKey(0)
    step = make_sharded_iid_step(
        model, opt, encoded, target, mask,
        jnp.arange(t - 3), 1 + jnp.arange(2), scaler, mesh, batch_size=64)
    with mesh:
        p2, s2, loss = step(params, opt.init(params), key)
        p2, s2, loss2 = step(p2, s2, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss)) and np.isfinite(float(loss2))
    leaf = jax.tree_util.tree_leaves(p2)[0]
    assert np.isfinite(np.asarray(leaf)).all()


def test_sharded_iid_memory_is_node_sharded(rng):
    """Each device holds ~1/n of every big array — multi-chip scales
    memory capacity, not just FLOPs."""
    from sgp.parallel.sharding import make_sharded_iid_step

    mesh = make_mesh(8, 1)
    t, n = 100, 16
    encoded, target, mask, model, params, opt, scaler = _iid_setup(rng)
    step = make_sharded_iid_step(
        model, opt, encoded, target, mask,
        jnp.arange(t - 3), 1 + jnp.arange(2), scaler, mesh, batch_size=64)
    enc_s, tgt_s, msk_s = step.data[:3]
    for arr in (enc_s, tgt_s, msk_s):
        shards = arr.addressable_shards
        assert len(shards) == 8
        assert shards[0].data.nbytes * 8 == arr.nbytes
    assert enc_s.nbytes == encoded.nbytes  # 16 % 8 == 0: no padding


def test_sharded_iid_matches_single_device_emulation(rng):
    """The sharded step's loss AND updated params equal a single-device
    emulation of the same per-shard RNG streams and masked reduction."""
    import optax

    from sgp.parallel.sharding import make_sharded_iid_step
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    mesh = make_mesh(8, 1)
    t, n, d = 100, 16, 8
    n_shards, local_bs = 8, 8
    n_local = n // n_shards
    encoded, target, mask, model, params, opt, scaler = _iid_setup(rng)
    valid = jnp.arange(t - 3)
    h_off = 1 + jnp.arange(2)
    key = jax.random.PRNGKey(42)
    step = make_sharded_iid_step(
        model, opt, encoded, target, mask, valid, h_off, scaler, mesh,
        batch_size=n_shards * local_bs)
    with mesh:
        p_sh, s_sh, loss_sh = step(params, opt.init(params), key)
    loss_sh = float(loss_sh)

    # single-device emulation of the 8 per-shard streams
    def emulated_loss(p):
        keys = jax.random.split(key, 1)  # scan over steps_per_call=1
        total_v, total_c = 0.0, 0.0
        for shard_id in range(n_shards):
            r = jax.random.fold_in(keys[0], shard_id)
            rng_t, rng_n, rng_d = jax.random.split(r, 3)
            ts = jax.random.choice(rng_t, valid, (local_bs,))
            n_loc = jax.random.randint(rng_n, (local_bs,), 0, n_local)
            n_glob = shard_id * n_local + n_loc
            x = encoded[ts, n_glob]
            y = target[ts[:, None] + h_off[None, :], n_glob[:, None]]
            m = mask[ts[:, None] + h_off[None, :], n_glob[:, None]]
            sc = scaler.index_nodes_iid(n_glob)
            y_hat = model.apply(p, x, node_index=n_glob, training=True,
                                iid=True, rngs={"dropout": rng_d})
            y_hat = sc.inverse_transform(y_hat)
            v, c = _masked_reduce(_METRIC_FNS["mae"], y_hat, y, m)
            total_v = total_v + v
            total_c = total_c + c
        return total_v / jnp.maximum(total_c, 1.0)

    loss_em, grads = jax.value_and_grad(emulated_loss)(params)
    np.testing.assert_allclose(loss_sh, float(loss_em), rtol=1e-5)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_em = optax.apply_updates(params, updates)
    for a, b in zip(jax.tree_util.tree_leaves(p_sh),
                    jax.tree_util.tree_leaves(p_em)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_sharded_iid_padded_nodes_are_masked(rng):
    """N not divisible by the axis: padded node slots carry mask=False
    and the step still runs with a finite loss."""
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel.sharding import make_sharded_iid_step

    mesh = make_mesh(8, 1)
    t, n, d = 60, 13, 8    # 13 -> pads to 16
    encoded = jnp.asarray(rng.standard_normal((t, n, d)).astype(np.float32))
    target = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    model = SGPModel(input_size=d, order=2, n_nodes=16, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    step = make_sharded_iid_step(
        model, opt, encoded, target, jnp.ones((t, n, 1), bool),
        jnp.arange(t - 3), 1 + jnp.arange(2),
        ScalerParams(jnp.zeros(1), jnp.ones(1)), mesh, batch_size=64)
    msk_s = step.data[2]
    assert msk_s.shape[1] == 16
    assert not np.asarray(msk_s)[:, 13:].any()
    with mesh:
        _, _, loss = step(params, opt.init(params), key)
    assert np.isfinite(float(loss))


def test_sharded_iid_packed_matches_unpacked(rng):
    """packed=True (single wide-row gather, pack after shard) gives the
    same loss/params as the unpacked sharded step: same RNG -> same
    samples, bf16 features identical, targets bit-exact via hi/lo."""
    import optax

    from sgp.parallel.sharding import make_sharded_iid_step

    mesh = make_mesh(8, 1)
    t = 100
    encoded, target, mask, model, params, opt, scaler = _iid_setup(rng)
    encoded = encoded.astype(jnp.bfloat16)   # packed requires bf16
    valid, h_off = jnp.arange(t - 3), 1 + jnp.arange(2)
    key = jax.random.PRNGKey(3)
    outs = {}
    for packed in (False, True):
        step = make_sharded_iid_step(
            model, opt, encoded, target, mask, valid, h_off, scaler,
            mesh, batch_size=64, steps_per_call=3, packed=packed)
        with mesh:
            p2, _, loss = step(params, opt.init(params), key)
        outs[packed] = (p2, float(loss))
    assert abs(outs[True][1] - outs[False][1]) < 1e-6
    for a, b in zip(jax.tree_util.tree_leaves(outs[True][0]),
                    jax.tree_util.tree_leaves(outs[False][0])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6)


def test_sharded_iid_packed_is_node_sharded(rng):
    """The packed wide-row array is still 1/n per device (pack after
    shard preserves the node sharding)."""
    from sgp.parallel.sharding import make_sharded_iid_step

    mesh = make_mesh(8, 1)
    t = 100
    encoded, target, mask, model, params, opt, scaler = _iid_setup(rng)
    encoded = encoded.astype(jnp.bfloat16)
    step = make_sharded_iid_step(
        model, opt, encoded, target, mask, jnp.arange(t - 3),
        1 + jnp.arange(2), scaler, mesh, batch_size=64, packed=True)
    big = step.data[0]
    assert big.shape[-1] == encoded.shape[-1] + 3 * 2 * 1  # D + 3HC
    shards = big.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.nbytes * 8 == big.nbytes


def test_sharded_eval_matches_fused_eval(rng):
    """Node-sharded fused eval == single-device make_fused_eval on the
    same params (non-divisible N exercises node padding; per-node
    scaler exercises index_nodes inside the shard)."""
    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel import make_sharded_iid_eval
    from sgp.train import MaskedMetrics
    from sgp.train.fused_window import make_fused_eval

    t, n, f, h = 40, 21, 6, 3
    enc = rng.standard_normal((t, n, f)).astype(np.float32)
    tgt = rng.standard_normal((t, n, 1)).astype(np.float32)
    msk = rng.random((t, n, 1)) > 0.2
    u = rng.standard_normal((t, 2)).astype(np.float32)
    scaler = ScalerParams(
        jnp.asarray(rng.standard_normal((1, n, 1)).astype(np.float32)),
        jnp.asarray(1.0 + rng.random((1, n, 1)).astype(np.float32)))
    # n_pad nodes so positional embeddings cover the padded slab too
    n_pad = -(-n // 8) * 8
    model = SGPModel(input_size=f, order=3, n_nodes=n_pad, hidden_size=12,
                     mlp_size=8, output_size=1, n_layers=1, horizon=h,
                     positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, f)), u=jnp.zeros((2, 1, 2)),
                        node_index=jnp.arange(n))
    items = np.arange(t - h - 1)
    w_off, h_off = np.array([0]), 1 + np.arange(h)
    metrics = MaskedMetrics.forecasting()
    def apply_fn(p, x, uu):   # model built with n_pad nodes: the
        return model.apply(   # single-device run names its n real nodes
            p, x, u=uu, node_index=jnp.arange(n), training=False)

    ref = make_fused_eval(model, jnp.asarray(enc), jnp.asarray(tgt),
                          jnp.asarray(msk), items, w_off, h_off, scaler,
                          metrics, u=jnp.asarray(u), batch_size=8,
                          apply_fn=apply_fn)(params)
    mesh = make_mesh(8, 1)
    with mesh:
        got = make_sharded_iid_eval(
            model, jnp.asarray(enc), jnp.asarray(tgt), jnp.asarray(msk),
            items, w_off, h_off, scaler, metrics, mesh,
            u=jnp.asarray(u), batch_size=8)(params)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, err_msg=k)


def test_sharded_eval_packed_x_slice(rng):
    """Sharded eval over a PACKED row layout (x_slice) == sharded eval
    over the unpacked encoding, and the packed array stays 1/n/device."""
    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel import make_sharded_iid_eval
    from sgp.train import MaskedMetrics
    from sgp.train.iid import pack_iid_data

    t, n, f, h = 30, 24, 4, 2
    enc = jnp.asarray(
        rng.standard_normal((t, n, f)).astype(np.float32)
    ).astype(jnp.bfloat16)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.ones((t, n, 1), bool)
    h_off = 1 + jnp.arange(h)
    packed = pack_iid_data(enc, tgt, msk, h_off)
    model = SGPModel(input_size=f, order=2, n_nodes=n, hidden_size=8,
                     mlp_size=8, output_size=1, n_layers=1, horizon=h,
                     positional_encoding=True)
    key = jax.random.PRNGKey(1)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, f)))
    items = np.arange(t - h - 1)
    metrics = MaskedMetrics.forecasting()
    scaler = ScalerParams(jnp.zeros(1), jnp.ones(1))
    mesh = make_mesh(8, 1)
    with mesh:
        ev_ref = make_sharded_iid_eval(
            model, enc.astype(jnp.float32), tgt, msk, items,
            np.array([0]), h_off, scaler, metrics, mesh, batch_size=4)
        ref = ev_ref(params)
        ev_pk = make_sharded_iid_eval(
            model, packed, tgt, msk, items, np.array([0]), h_off,
            scaler, metrics, mesh, batch_size=4, x_slice=f)
        got = ev_pk(params)
    big = ev_pk.data[0]
    assert big.addressable_shards[0].data.nbytes * 8 <= big.nbytes
    for k in ref:
        # bf16 features either way; forward in f32 vs bf16-cast rows
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-3, err_msg=k)


def test_sharded_window_step_matches_single_device_emulation(rng):
    """DP windowed training (the traffic path's multi-chip variant):
    sharded loss AND updated params equal a single-device emulation of
    the 8 per-shard RNG streams, incl. support-op propagation."""
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel import make_sharded_window_step
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    mesh = make_mesh(8, 1)
    t, n, f, h = 60, 12, 3, 2
    g = graph(rng, n)
    op = build_operator(g, "dense")
    xf = jnp.asarray(rng.standard_normal((t, n, f)).astype(np.float32))
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(rng.random((t, n, 1)) > 0.1)
    starts = jnp.arange(t - h - 2)
    w_off, h_off = jnp.arange(2), 2 + jnp.arange(h)
    scaler = ScalerParams(jnp.zeros(1), 2.0 * jnp.ones(1))
    model = SGPModel(input_size=2 * f, order=2, n_nodes=n, hidden_size=12,
                     mlp_size=8, output_size=1, n_layers=1, horizon=h,
                     positional_encoding=True)
    key = jax.random.PRNGKey(3)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 2, n, 2 * f)))
    opt = optax.adam(1e-3)
    n_shards, local_bs = 8, 4
    step = make_sharded_window_step(
        model, opt, xf, tgt, msk, starts, w_off, h_off, scaler, mesh,
        support_ops=[op], batch_size=n_shards * local_bs)
    with mesh:
        p_sh, _, loss_sh = step(params, opt.init(params), key)
    loss_sh = float(loss_sh)

    def emulated_loss(p):
        keys = jax.random.split(key, 1)
        total_v, total_c = 0.0, 0.0
        for shard_id in range(n_shards):
            r = jax.random.fold_in(keys[0], shard_id)
            rng_i, rng_d = jax.random.split(r)
            items = jax.random.choice(rng_i, starts, (local_bs,))
            x = xf[items[:, None] + w_off[None, :]]
            x = jnp.concatenate([x, op @ x], -1)
            y = tgt[items[:, None] + h_off[None, :]]
            m = msk[items[:, None] + h_off[None, :]]
            y_hat = model.apply(p, x, training=True,
                                rngs={"dropout": rng_d})
            y_hat = scaler.inverse_transform(y_hat)
            v, c = _masked_reduce(_METRIC_FNS["mae"], y_hat, y, m)
            total_v = total_v + v
            total_c = total_c + c
        return total_v / jnp.maximum(total_c, 1.0)

    loss_em, grads = jax.value_and_grad(emulated_loss)(params)
    np.testing.assert_allclose(loss_sh, float(loss_em), rtol=1e-5)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_em = optax.apply_updates(params, updates)
    for a, b in zip(jax.tree_util.tree_leaves(p_sh),
                    jax.tree_util.tree_leaves(p_em)):
        # psum vs sequential-sum grad noise (~1e-7) passes through
        # adam's m/sqrt(v): near-zero-gradient entries move by O(lr)
        # regardless of the noise size, so compare at the lr scale
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=3e-4)


def test_sharded_stratified_step_matches_emulation(rng):
    """Multi-chip beyond-HBM trainer: node-sharded resident embedding
    (1/n per device asserted), shared sampled times, per-shard node
    streams — sharded loss AND updated params equal the single-device
    emulation."""
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel import make_sharded_iid_stratified_step
    from sgp.train.iid import take_time_rows
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    mesh = make_mesh(8, 1)
    t, n, ht, h = 50, 16, 8, 2
    n_shards, tb, p_local = 8, 4, 2
    n_local = n // n_shards
    g = graph(rng, n)
    op = build_operator(g, "dense")
    h_temp = jnp.asarray(rng.standard_normal((t, n, ht)).astype(np.float32))
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(rng.random((t, n, 1)) > 0.1)
    valid = jnp.arange(t - h - 1)
    h_off = 1 + jnp.arange(h)
    scaler = ScalerParams(jnp.zeros(1), jnp.ones(1))
    d_total = ht * 3                       # self + 1 op + global mean
    model = SGPModel(input_size=d_total, order=3, n_nodes=n,
                     hidden_size=12, mlp_size=8, output_size=1,
                     n_layers=1, horizon=h, positional_encoding=True)
    key0 = jax.random.PRNGKey(5)
    params = model.init({"params": key0, "dropout": key0},
                        jnp.zeros((4, d_total)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    step = make_sharded_iid_stratified_step(
        model, opt, h_temp, tgt, msk, valid, h_off, scaler, [op], mesh,
        global_attr=True, times_per_batch=tb,
        nodes_per_time=n_shards * p_local)
    hs = step.data[0]
    assert hs.addressable_shards[0].data.nbytes * 8 == hs.nbytes
    key = jax.random.PRNGKey(77)
    with mesh:
        p_sh, _, loss_sh = step(params, opt.init(params), key)
    loss_sh = float(loss_sh)

    def emulated_loss(p):
        k0 = jax.random.split(key, 1)[0]
        rng_t, rng_n, rng_d = jax.random.split(k0, 3)
        ts = jax.random.choice(rng_t, valid, (tb,))
        h_sel = take_time_rows(h_temp, ts)            # [Tb, N, Ht]
        total_v, total_c = 0.0, 0.0
        for sid in range(n_shards):
            rn = jax.random.fold_in(rng_n, sid)
            rd = jax.random.fold_in(rng_d, sid)
            n_loc = jax.random.randint(rn, (tb, p_local), 0, n_local)
            n_glob = sid * n_local + n_loc
            h_smp = jnp.take_along_axis(h_sel, n_glob[:, :, None], axis=1)
            rows = op.mat[n_glob]
            hop = jnp.einsum("tpn,tnf->tpf", rows, h_sel,
                             precision=op.precision,
                             preferred_element_type=jnp.float32
                             ).astype(h_sel.dtype)
            gmean = jnp.broadcast_to(h_sel.mean(-2, keepdims=True),
                                     h_smp.shape)
            x = jnp.concatenate([h_smp, hop, gmean], -1).reshape(
                tb * p_local, -1)
            steps = (ts[:, None] + h_off[None, :]).reshape(-1)

            def gather_tn(arr):
                rows_ = take_time_rows(arr, steps).reshape(
                    (tb, h) + arr.shape[1:])
                sel = jnp.take_along_axis(
                    rows_, n_glob[:, None, :, None], axis=2)
                return sel.transpose(0, 2, 1, 3).reshape(
                    tb * p_local, h, arr.shape[-1])

            y = gather_tn(tgt)
            m = gather_tn(msk)
            n_flat = n_glob.reshape(-1)
            y_hat = model.apply(p, x, node_index=n_flat, training=True,
                                iid=True, rngs={"dropout": rd})
            v, c = _masked_reduce(_METRIC_FNS["mae"], y_hat, y, m)
            total_v = total_v + v
            total_c = total_c + c
        return total_v / jnp.maximum(total_c, 1.0)

    loss_em, grads = jax.value_and_grad(emulated_loss)(params)
    np.testing.assert_allclose(loss_sh, float(loss_em), rtol=1e-5)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_em = optax.apply_updates(params, updates)
    for a, b in zip(jax.tree_util.tree_leaves(p_sh),
                    jax.tree_util.tree_leaves(p_em)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=3e-4)


def test_sharded_eval_unpack_targets_matches(rng):
    """Packed-lane target unpacking (no separate target/mask arrays in
    HBM) reproduces the explicit-arrays sharded eval exactly."""
    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.parallel import make_sharded_iid_eval
    from sgp.train import MaskedMetrics
    from sgp.train.iid import pack_iid_data

    t, n, f, h = 30, 24, 4, 2
    enc = jnp.asarray(rng.standard_normal((t, n, f)).astype(np.float32)
                      ).astype(jnp.bfloat16)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(rng.random((t, n, 1)) > 0.3)
    h_off = 1 + jnp.arange(h)
    packed = pack_iid_data(enc, tgt, msk, h_off)
    model = SGPModel(input_size=f, order=2, n_nodes=n, hidden_size=8,
                     mlp_size=8, output_size=1, n_layers=1, horizon=h,
                     positional_encoding=True)
    key = jax.random.PRNGKey(1)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, f)))
    items = np.arange(t - h - 1)
    metrics = MaskedMetrics.forecasting()
    scaler = ScalerParams(jnp.zeros(1), jnp.ones(1))
    mesh = make_mesh(8, 1)
    with mesh:
        ref = make_sharded_iid_eval(
            model, packed, tgt, msk, items, np.array([0]), h_off,
            scaler, metrics, mesh, batch_size=4, x_slice=f)(params)
        got_ev = make_sharded_iid_eval(
            model, packed, None, None, items, np.array([0]), h_off,
            scaler, metrics, mesh, batch_size=4, x_slice=f,
            unpack_targets=True)
        got = got_ev(params)
    assert len(got_ev.data) == 3      # packed + starts/ok, no tgt/msk
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


def test_sharded_eval_support_ops_matches_fused(rng):
    """Sharded eval with on-the-fly support propagation (the stratified
    layout: all-gather only each batch's time rows, contract local
    operator row slabs) == single-device make_fused_eval with the same
    support_ops, incl. a non-dense GlobalMeanOperator."""
    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.ops import GlobalMeanOperator
    from sgp.parallel import make_sharded_iid_eval
    from sgp.train import MaskedMetrics
    from sgp.train.fused_window import make_fused_eval

    t, n, ht, h = 30, 16, 6, 2
    g = graph(rng, n)
    ops = [build_operator(g, "dense"), GlobalMeanOperator(n)]
    h_temp = jnp.asarray(rng.standard_normal((t, n, ht)).astype(np.float32))
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(rng.random((t, n, 1)) > 0.2)
    items = np.arange(t - h - 1)
    h_off = 1 + jnp.arange(h)
    scaler = ScalerParams(jnp.zeros(1), jnp.ones(1))
    model = SGPModel(input_size=3 * ht, order=3, n_nodes=n,
                     hidden_size=12, mlp_size=8, output_size=1,
                     n_layers=1, horizon=h, positional_encoding=True)
    key = jax.random.PRNGKey(2)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((2, 1, n, 3 * ht)))
    metrics = MaskedMetrics.forecasting()
    ref = make_fused_eval(model, h_temp, tgt, msk, items, np.array([0]),
                          h_off, scaler, metrics, support_ops=ops,
                          batch_size=4)(params)
    mesh = make_mesh(8, 1)
    with mesh:
        got = make_sharded_iid_eval(
            model, h_temp, tgt, msk, items, np.array([0]), h_off,
            scaler, metrics, mesh, batch_size=4,
            support_ops=ops)(params)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, err_msg=k)


def test_predictor_mesh_dp_matches_single(rng):
    """Predictor(mesh=...) generic data parallelism: batch-sharded fit
    over the 8-device mesh reproduces the single-device fit (XLA GSPMD
    inserts the reductions; float-level agreement — reduction order may
    differ across shardings). Also covers the ragged-tail replicated
    fallback (the last loader batch)."""
    from sgp.data import (SpatioTemporalDataset, StandardScaler,
                          WindowedLoader, Windowing)
    from sgp.models.rnn import RNNModel
    from sgp.train import Predictor

    data = rng.standard_normal((90, 6, 1)).astype(np.float32) + 2
    ds = SpatioTemporalDataset(
        data, windowing=Windowing(window=4, horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    items = np.arange(20)

    def fit(mesh):
        p = Predictor(RNNModel(output_size=1, horizon=2, hidden_size=8,
                               ff_size=8),
                      lr=1e-2, seed=0, mesh=mesh)
        # batch 8 divides the mesh; 20 items -> ragged last batch of 4
        tr = WindowedLoader(ds, items, batch_size=8, shuffle=True,
                            seed=3)
        va = WindowedLoader(ds, items, batch_size=8)
        p.fit(tr, va, epochs=2, scaler=ds.scaler_params())
        return p.evaluate(va)

    single = fit(None)
    dp = fit(make_mesh(8, 1))
    for k in single:
        np.testing.assert_allclose(dp[k], single[k], rtol=2e-5,
                                   err_msg=k)


def test_predictor_dp_rejects_indivisible_batch_size(rng):
    """A batch size not divisible by the data-axis size would silently
    replicate EVERY batch (zero parallelism) — Predictor refuses."""
    import pytest

    from sgp.data import (SpatioTemporalDataset, WindowedLoader,
                          Windowing)
    from sgp.models.rnn import RNNModel
    from sgp.train import Predictor

    data = rng.standard_normal((40, 6, 1)).astype(np.float32)
    ds = SpatioTemporalDataset(
        data, windowing=Windowing(window=4, horizon=2))
    p = Predictor(RNNModel(output_size=1, horizon=2, hidden_size=8,
                           ff_size=8),
                  lr=1e-2, seed=0, mesh=make_mesh(8, 1))
    tr = WindowedLoader(ds, np.arange(20), batch_size=12)
    with pytest.raises(ValueError, match="divisible"):
        p.fit(tr, epochs=1)


def test_predictor_mesh_dp_subgraph_batches(rng):
    """The DP mesh also handles subgraph batches (padded node/edge
    arrays + root-only loss via target_nodes)."""
    from sgp.data import SpatioTemporalDataset, Windowing
    from sgp.data.subgraph import SubgraphLoader
    from sgp.models.gated_gn import GatedGraphNetworkMLPModel
    from sgp.train import Predictor

    n = 16
    g = graph(rng, n)
    data = rng.standard_normal((60, n, 1)).astype(np.float32)
    ds = SpatioTemporalDataset(
        data, graph=g, windowing=Windowing(window=3, horizon=2))
    model = GatedGraphNetworkMLPModel(
        input_window_size=3, hidden_size=8, output_size=1, horizon=2,
        n_nodes=n, enc_layers=1, gnn_layers=1,
        positional_encoding=True)

    def to_call(batch, training):
        return (batch["x"],), {
            "src": batch["sub_src"], "dst": batch["sub_dst"],
            "node_index": batch.get("node_index"),
            "edge_mask": batch["sub_weight"] != 0, "training": training}

    def loader():
        return SubgraphLoader(ds, np.arange(16), batch_size=8,
                              num_roots=4, k=1, max_edges=64,
                              pad_nodes=12, seed=5, shuffle=False)

    def fit(mesh):
        p = Predictor(model, lr=1e-2, seed=0, mesh=mesh,
                      batch_to_call=to_call)
        p.fit(loader(), epochs=2)
        return p.evaluate(loader())

    single = fit(None)
    dp = fit(make_mesh(8, 1))
    for k in single:
        np.testing.assert_allclose(dp[k], single[k], rtol=2e-5,
                                   err_msg=k)
