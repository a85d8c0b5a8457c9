"""Fused on-device IID training: learns and matches batch semantics."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sgp.data import (ScalerParams, SpatioTemporalDataset, StandardScaler,
                      Windowing)
from sgp.models import SGPModel
from sgp.train.iid import fused_iid_inputs, make_fused_iid_step


def test_fused_iid_learns(rng):
    t, n, d = 200, 10, 8
    # static per-node features, linear target: exactly learnable from
    # the window-start gather y[t+h, n] = f(encoded[t, n])
    e_static = rng.standard_normal((1, n, d)).astype(np.float32)
    encoded = np.broadcast_to(e_static, (t, n, d)).copy()
    w_true = rng.standard_normal((d, 1)).astype(np.float32)
    target = encoded @ w_true
    ds = SpatioTemporalDataset(target,
                               windowing=Windowing(window=1, horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    ds.add_covariate("encoded_x", encoded)
    ds.set_input_keys(["encoded_x"])

    enc, tgt, mask, valid, h_off, u = fused_iid_inputs(ds)
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=32,
                     mlp_size=16, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    optimizer = optax.adam(5e-3)
    opt_state = optimizer.init(params)
    step = make_fused_iid_step(model, optimizer, enc, tgt, mask, valid,
                               h_off, ds.scaler_params(), batch_size=128)
    losses = []
    for i in range(200):
        key, k = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, k)
        losses.append(float(loss))
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20]), \
        (np.mean(losses[:20]), np.mean(losses[-20:]))


def test_fused_iid_with_exog_and_node_scaler(rng):
    t, n, d = 100, 6, 4
    target = (rng.standard_normal((t, n, 1)) * 5 + 10).astype(np.float32)
    ds = SpatioTemporalDataset(target,
                               covariates={"u": rng.standard_normal(
                                   (t, 2)).astype(np.float32)},
                               windowing=Windowing(window=1, horizon=3))
    ds.fit_scaler(StandardScaler(axis=0))  # per-node params [1, N, 1]
    ds.add_covariate("encoded_x",
                     rng.standard_normal((t, n, d)).astype(np.float32))
    ds.set_input_keys(["encoded_x"])
    enc, tgt, mask, valid, h_off, u = fused_iid_inputs(ds)
    assert u is not None
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=3,
                     positional_encoding=False, exog_size=2)
    key = jax.random.PRNGKey(1)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)), u=jnp.zeros((4, 2)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    optimizer = optax.adam(1e-3)
    step = make_fused_iid_step(model, optimizer, enc, tgt, mask, valid,
                               h_off, ds.scaler_params(), u=u,
                               batch_size=64)
    params2, _, loss = step(params, optimizer.init(params), key)
    assert np.isfinite(float(loss))
    # params actually changed
    delta = jax.tree_util.tree_reduce(
        lambda a, p: a + float(jnp.abs(p).sum()),
        jax.tree.map(lambda a, b: a - b, params, params2), 0.0)
    assert delta > 0


def test_fused_iid_node_level_exog_gathers_own_node(rng):
    """keep_raw makes u node-level [T, N, F]; each sample must receive
    ITS OWN node's u (regression: previously every sample got u[t][-1])."""
    t, n, d = 60, 5, 4
    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    ds = SpatioTemporalDataset(target,
                               windowing=Windowing(window=1, horizon=2))
    ds.fit_scaler(StandardScaler(axis=(0, 1)))
    ds.add_covariate("encoded_x",
                     rng.standard_normal((t, n, d)).astype(np.float32))
    ds.set_input_keys(["encoded_x"])
    ds.exog_keys = ["target_scaled"]  # node-level exog (keep_raw path)
    from sgp.train.iid import fused_iid_inputs
    enc, tgt, mask, valid, h_off, u = fused_iid_inputs(ds)
    assert u is not None and u.ndim == 3
    # capture what u the model receives by making the model's output
    # depend only on u (zero weights elsewhere is hard; instead check
    # the gather directly against the step's semantics)
    import jax
    key = jax.random.PRNGKey(0)
    t_idx = jax.random.choice(jax.random.split(key, 3)[0], valid, (8,))
    n_idx = jax.random.randint(jax.random.split(key, 3)[1], (8,), 0, n)
    gathered = np.asarray(u)[np.asarray(t_idx), np.asarray(n_idx)]
    expect = np.asarray(ds.target_scaled)[np.asarray(t_idx),
                                          np.asarray(n_idx)]
    np.testing.assert_allclose(gathered, expect, atol=1e-6)


def test_bsr_operator_inside_jit(rng):
    """BSROperator passed as a pytree arg through jit (regression:
    host-side prep used to run on tracers and crash)."""
    import jax
    import jax.numpy as jnp
    from sgp.graph import Graph, coalesce, normalize_adj
    from sgp.ops import build_operator
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, 200, 1500), rng.integers(0, 200, 1500),
        rng.random(1500).astype(np.float32), 200)), "row")
    op = build_operator(g, "bsr")
    x = jnp.asarray(rng.standard_normal((200, 16)).astype(np.float32))

    @jax.jit
    def f(op, x):
        return op @ x

    out = np.asarray(f(op, x))
    np.testing.assert_allclose(out, g.to_dense() @ np.asarray(x),
                               atol=1e-4)


def test_stratified_features_match_precompute(rng):
    """The stratified step's feature assembly [h, A h, ..., mean(h)]
    must equal apply_support's precomputed layout at the sampled
    (time, node) pairs — pinned by replicating the in-step assembly."""
    import jax
    import jax.numpy as jnp
    from sgp.data.sgp_loader import apply_support, build_support_operators
    from sgp.graph import Graph, coalesce
    from sgp.ops import GlobalMeanOperator
    t, n, h_dim = 40, 10, 4
    g = coalesce(Graph(rng.integers(0, n, 40), rng.integers(0, n, 40),
                       rng.random(40).astype(np.float32), n))
    ops = build_support_operators(g, k=2)
    h = jnp.asarray(rng.standard_normal((t, n, h_dim)).astype(np.float32))
    t_idx = jnp.asarray([3, 17, 5])
    # in-step assembly (mirrors make_fused_iid_stratified_step)
    h_sel = h[t_idx]
    parts = [h_sel] + [op @ h_sel for op in ops]
    parts.append(jnp.broadcast_to(h_sel.mean(-2, keepdims=True),
                                  h_sel.shape))
    x_step = np.asarray(jnp.concatenate(parts, -1))
    # precompute layout: apply_support with ops + global-mean operator
    full = np.asarray(apply_support(
        h, ops + [GlobalMeanOperator(n)]))
    np.testing.assert_allclose(x_step, full[np.asarray(t_idx)], atol=1e-5)


def test_stratified_step_matches_precomputed_semantics(rng):
    """On-the-fly propagation in the stratified step gives the same
    features a precomputed (k+1)x embedding would."""
    import optax
    from sgp.data.sgp_loader import build_support_operators
    from sgp.graph import Graph, coalesce
    from sgp.train.iid import make_fused_iid_stratified_step
    t, n, h_dim = 80, 12, 6
    g = coalesce(Graph(rng.integers(0, n, 50), rng.integers(0, n, 50),
                       rng.random(50).astype(np.float32), n))
    ops = build_support_operators(g, k=2)
    h_temporal = rng.standard_normal((t, n, h_dim)).astype(np.float32)
    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    d_total = h_dim * (1 + len(ops) + 1)  # + global
    model = SGPModel(input_size=d_total, order=4, n_nodes=n,
                     hidden_size=16, mlp_size=8, output_size=1,
                     n_layers=1, horizon=2, positional_encoding=False)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d_total)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    step = make_fused_iid_stratified_step(
        model, opt, jnp.asarray(h_temporal), jnp.asarray(target),
        jnp.ones((t, n, 1), bool), jnp.arange(t - 3), 1 + jnp.arange(2),
        ScalerParams(jnp.zeros(1), jnp.ones(1)), ops, global_attr=True,
        times_per_batch=4, nodes_per_time=8, steps_per_call=5)
    p, s, loss = step(params, opt.init(params), key)
    assert np.isfinite(float(loss))
    # and it learns on a learnable problem
    e_static = np.broadcast_to(
        rng.standard_normal((1, n, h_dim)).astype(np.float32), (t, n, h_dim)
    ).copy()
    w_true = rng.standard_normal((h_dim, 1)).astype(np.float32)
    tgt2 = e_static @ w_true
    step2 = make_fused_iid_stratified_step(
        model, opt, jnp.asarray(e_static), jnp.asarray(tgt2),
        jnp.ones((t, n, 1), bool), jnp.arange(t - 3), 1 + jnp.arange(2),
        ScalerParams(jnp.zeros(1), jnp.ones(1)), ops, global_attr=True,
        times_per_batch=8, nodes_per_time=16, steps_per_call=40)
    st2 = opt.init(params)
    p2, losses = params, []
    for i in range(6):
        key, k = jax.random.split(key)
        p2, st2, l = step2(p2, st2, k)
        losses.append(float(l))
    assert losses[-1] < 0.6 * losses[0], losses


def test_stratified_gather_spmm_matches_full_propagation(rng):
    """The gather-SpMM (rows of A at the sampled nodes only) must give
    the exact features the old propagate-all-nodes assembly produced for
    the same RNG stream — same t/n draws, same values."""
    import jax
    import jax.numpy as jnp
    from sgp.data.sgp_loader import build_support_operators
    from sgp.graph import Graph, coalesce

    t, n, h_dim, tb, p = 60, 14, 5, 4, 6
    g = coalesce(Graph(rng.integers(0, n, 60), rng.integers(0, n, 60),
                       rng.random(60).astype(np.float32), n))
    ops = build_support_operators(g, k=2)
    ht = jnp.asarray(rng.standard_normal((t, n, h_dim)).astype(np.float32))
    key = jax.random.PRNGKey(3)
    rng_t, rng_n, _ = jax.random.split(key, 3)
    t_idx = jax.random.choice(rng_t, jnp.arange(t - 3), (tb,))
    n_idx = jax.random.randint(rng_n, (tb, p), 0, n)
    h_sel = ht[t_idx]

    # old assembly: full propagation, then gather sampled nodes
    parts_full = [h_sel] + [op @ h_sel for op in ops]
    parts_full.append(jnp.broadcast_to(h_sel.mean(-2, keepdims=True),
                                       h_sel.shape))
    x_old = jnp.take_along_axis(jnp.concatenate(parts_full, -1),
                                n_idx[:, :, None], axis=1)

    # new assembly: row-gathered contraction
    h_smp = jnp.take_along_axis(h_sel, n_idx[:, :, None], axis=1)
    parts = [h_smp]
    for op in ops:
        rows = op.mat[n_idx]
        parts.append(jnp.einsum("tpn,tnf->tpf", rows, h_sel,
                                precision=op.precision,
                                preferred_element_type=jnp.float32))
    parts.append(jnp.broadcast_to(h_sel.mean(-2, keepdims=True),
                                  h_smp.shape))
    x_new = jnp.concatenate(parts, -1)
    np.testing.assert_allclose(np.asarray(x_new), np.asarray(x_old),
                               atol=1e-5)


def test_stratified_assembly_modes_agree(rng):
    """``assembly='full_prop'`` (square-GEMM + row gather, the large-GEMM
    path) must produce the same training trajectory as
    ``assembly='gather_rows'`` for the same RNG stream; bf16 supports
    stay close."""
    import optax
    from sgp.data.sgp_loader import build_support_operators
    from sgp.graph import Graph, coalesce
    from sgp.train.iid import make_fused_iid_stratified_step

    t, n, h_dim = 50, 10, 4
    g = coalesce(Graph(rng.integers(0, n, 40), rng.integers(0, n, 40),
                       rng.random(40).astype(np.float32), n))
    ops = build_support_operators(g, k=2)
    ht = jnp.asarray(rng.standard_normal((t, n, h_dim)).astype(np.float32))
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    d_total = h_dim * (1 + len(ops) + 1)
    model = SGPModel(input_size=d_total, order=4, n_nodes=n,
                     hidden_size=12, mlp_size=8, output_size=1,
                     n_layers=1, horizon=2, positional_encoding=False)
    key = jax.random.PRNGKey(7)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d_total)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)

    def run(assembly, support_dtype=None):
        step = make_fused_iid_stratified_step(
            model, opt, ht, tgt, jnp.ones((t, n, 1), bool),
            jnp.arange(t - 3), 1 + jnp.arange(2),
            ScalerParams(jnp.zeros(1), jnp.ones(1)), ops,
            global_attr=True, times_per_batch=3, nodes_per_time=5,
            steps_per_call=4, assembly=assembly,
            support_dtype=support_dtype)
        p, s, loss = step(params, opt.init(params), key)
        return float(loss)

    l_rows = run("gather_rows")
    l_full = run("full_prop")
    assert abs(l_rows - l_full) < 1e-4, (l_rows, l_full)
    l_bf16 = run("full_prop", jnp.bfloat16)
    assert abs(l_rows - l_bf16) < 5e-2, (l_rows, l_bf16)


def test_pack_iid_data_roundtrip_bitexact(rng):
    """f32 targets split into two bf16 lanes must reconstruct the EXACT
    bits; masks survive; rows line up with (t, n) indexing."""
    from sgp.train.iid import pack_iid_data, unpack_iid_rows
    t, n, d, c = 30, 7, 8, 2
    h_off = np.array([1, 4, 9])
    enc = rng.standard_normal((t, n, d)).astype(np.float32)
    tgt = (rng.standard_normal((t, n, c)) * 1e3).astype(np.float32)
    msk = rng.random((t, n, c)) > 0.3
    packed = pack_iid_data(jnp.asarray(enc, jnp.bfloat16),
                           jnp.asarray(tgt), jnp.asarray(msk), h_off)
    assert packed.shape == (t, n, d + 3 * len(h_off) * c)
    t_idx = np.array([0, 5, 11, 20])
    n_idx = np.array([3, 0, 6, 2])
    rows = packed.reshape(t * n, -1)[t_idx * n + n_idx]
    x, y, m = unpack_iid_rows(rows, d, len(h_off), c)
    np.testing.assert_array_equal(
        np.asarray(x), np.asarray(jnp.asarray(enc, jnp.bfloat16))[t_idx,
                                                                  n_idx])
    expect_y = np.stack([tgt[t_idx + h, n_idx] for h in h_off], axis=1)
    np.testing.assert_array_equal(np.asarray(y), expect_y)  # bit-exact
    expect_m = np.stack([msk[t_idx + h, n_idx] for h in h_off], axis=1)
    np.testing.assert_array_equal(np.asarray(m), expect_m)


def test_fused_iid_packed_matches_unpacked(rng):
    """packed=True must reproduce the unpacked step's loss bit-for-bit
    when the encoding is already bf16 (same RNG stream, same gathers)."""
    import optax
    t, n, d = 80, 9, 8
    enc = jnp.asarray(rng.standard_normal((t, n, d)), jnp.bfloat16)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(rng.random((t, n, 1)) > 0.2)
    valid = jnp.arange(t - 6)
    h_off = jnp.asarray([1, 3, 5])
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=3,
                     positional_encoding=True)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    opt = optax.adam(1e-3)
    sc = ScalerParams(jnp.zeros(1), jnp.ones(1))

    losses = {}
    for packed in (False, True):
        step = make_fused_iid_step(model, opt, enc, tgt, msk, valid,
                                   h_off, sc, batch_size=32,
                                   packed=packed)
        p, s = params, opt.init(params)
        ls = []
        k = jax.random.PRNGKey(42)
        for _ in range(4):
            k, k2 = jax.random.split(k)
            p, s, l = step(p, s, k2)
            ls.append(float(l))
        losses[packed] = ls
    np.testing.assert_array_equal(losses[False], losses[True])


def test_fused_iid_gather_block_semantics(rng):
    """gather_block=G gathers G CONSECUTIVE node rows per draw: every
    sampled row must equal the packed row at its reported (t, n), node
    indices must form aligned G-blocks, and the step must train."""
    import optax

    from sgp.train.iid import _build_iid_sample_and_loss
    t, n, d, g = 60, 12, 8, 4
    enc = jnp.asarray(rng.standard_normal((t, n, d)), jnp.bfloat16)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(np.ones((t, n, 1), bool))
    valid = jnp.arange(t - 6)
    h_off = jnp.asarray([1, 3, 5])
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=3,
                     positional_encoding=True)
    sc = ScalerParams(jnp.zeros(1), jnp.ones(1))
    data, snl = _build_iid_sample_and_loss(
        model, enc, tgt, msk, valid, h_off, sc, batch_size=16,
        packed=True, gather_block=g)
    x, y, m, n_idx, _ = snl.sample(jax.random.PRNGKey(3), data)
    n_np = np.asarray(n_idx).reshape(-1, g)
    # aligned blocks of consecutive node ids
    assert np.all(n_np % g == np.arange(g)[None, :])
    assert np.all(np.diff(n_np, axis=1) == 1)
    # x rows must be real encoding rows for SOME valid t at that node
    enc_np = np.asarray(enc, np.float32)
    x_np = np.asarray(x, np.float32)
    for i, node in enumerate(np.asarray(n_idx)):
        match = np.all(enc_np[:, node] == x_np[i][None, :], axis=1)
        assert match.any()
    # the full step trains (loss finite and decreasing-ish)
    opt = optax.adam(5e-3)
    step = make_fused_iid_step(model, opt, enc, tgt, msk, valid, h_off,
                               sc, batch_size=16, packed=True,
                               gather_block=g)
    key = jax.random.PRNGKey(0)
    p = model.init({"params": key, "dropout": key}, jnp.zeros((4, d)),
                   node_index=jnp.zeros(4, jnp.int32), iid=True)
    s = opt.init(p)
    first = None
    for i in range(30):
        key, k2 = jax.random.split(key)
        p, s, l = step(p, s, k2)
        if first is None:
            first = float(l)
    assert np.isfinite(float(l)) and float(l) < first


def test_fused_iid_gather_block_node_perm(rng):
    """With a shuffled packed layout + node_perm, sampled rows must
    still pair with their ORIGINAL node ids (embedding/scaler rows)."""
    from sgp.train.iid import (_build_iid_sample_and_loss,
                               pack_iid_data)
    t, n, d, g = 40, 12, 8, 4
    enc = jnp.asarray(rng.standard_normal((t, n, d)), jnp.bfloat16)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.asarray(np.ones((t, n, 1), bool))
    valid = jnp.arange(t - 6)
    h_off = jnp.asarray([1, 3, 5])
    perm = rng.permutation(n)
    packed = pack_iid_data(enc[:, perm], tgt[:, perm], msk[:, perm],
                           h_off)
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=3,
                     positional_encoding=True)
    sc = ScalerParams(jnp.zeros(1), jnp.ones(1))
    data, snl = _build_iid_sample_and_loss(
        model, None, tgt, msk, valid, h_off, sc, batch_size=16,
        packed=packed, gather_block=g, node_perm=jnp.asarray(perm))
    x, y, m, n_idx, _ = snl.sample(jax.random.PRNGKey(7), data)
    enc_np = np.asarray(enc, np.float32)
    x_np = np.asarray(x, np.float32)
    tgt_np = np.asarray(tgt)
    for i, node in enumerate(np.asarray(n_idx)):
        # x row i must be the ORIGINAL encoding of node `node` at some
        # valid t, and y must be that same (t, node)'s horizon targets
        match = np.all(enc_np[:, node] == x_np[i][None, :], axis=1)
        assert match.any()
        ti = int(np.argmax(match))
        np.testing.assert_array_equal(
            np.asarray(y)[i, :, 0],
            tgt_np[ti + np.asarray(h_off), node, 0])


def test_fused_iid_gather_block_validates(rng):
    from sgp.train.iid import make_fused_iid_step
    import optax
    enc = jnp.zeros((20, 10, 4), jnp.bfloat16)
    tgt = jnp.zeros((20, 10, 1))
    msk = jnp.ones((20, 10, 1), bool)
    model = SGPModel(input_size=4, order=1, n_nodes=10, hidden_size=8,
                     mlp_size=8, output_size=1, n_layers=1, horizon=1)
    sc = ScalerParams(jnp.zeros(1), jnp.ones(1))
    args = (model, optax.adam(1e-3), enc, tgt, msk, jnp.arange(10),
            jnp.asarray([1]), sc)
    with pytest.raises(ValueError):   # G does not divide n_nodes
        make_fused_iid_step(*args, batch_size=16, packed=True,
                            gather_block=8)
    with pytest.raises(ValueError):   # blocked gather needs packed
        make_fused_iid_step(*args, batch_size=16, packed=False,
                            gather_block=2)
    with pytest.raises(ValueError):   # node_perm needs blocked gather
        make_fused_iid_step(*args, batch_size=16, packed=True,
                            node_perm=jnp.arange(10))


def test_fused_iid_packed_falls_back_for_non_bf16(rng):
    """packed=True with an f32 or f16 encoding must silently fall back
    to the unpacked gather path (packing would change the precision the
    caller chose) — the step must still run and keep full-precision
    features."""
    import optax

    from sgp.data import ScalerParams
    from sgp.models import SGPModel
    from sgp.train.iid import make_fused_iid_step

    t, n, d = 40, 6, 8
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=8,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2)
    tgt = jnp.asarray(rng.standard_normal((t, n, 1)).astype(np.float32))
    msk = jnp.ones((t, n, 1), bool)
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(0)
    sc = ScalerParams(jnp.zeros(1), jnp.ones(1))
    for dtype in (jnp.float32, jnp.float16):
        enc = jnp.asarray(rng.standard_normal((t, n, d)), dtype)
        step = make_fused_iid_step(model, opt, enc, tgt, msk,
                                   jnp.arange(t - 3), 1 + jnp.arange(2),
                                   sc, batch_size=16, packed=True)
        # fall back => data tuple is the 5-element unpacked layout
        assert len(step.data) == 5, dtype
        params = model.init({"params": key, "dropout": key},
                            jnp.zeros((4, d)),
                            node_index=jnp.zeros(4, jnp.int32), iid=True)
        p2, s2, loss = step(params, opt.init(params), key)
        assert np.isfinite(float(loss))


def _tiny_iid_setup(rng, t=60, n=6, d=8, packed=True):
    from sgp.train.iid import pack_iid_data

    target = rng.standard_normal((t, n, 1)).astype(np.float32)
    mask = np.ones((t, n, 1), bool)
    h_off = jnp.asarray([1, 3])
    enc = jnp.asarray(
        rng.standard_normal((t, n, d)).astype(np.float32)
    ).astype(jnp.bfloat16)
    pk = pack_iid_data(enc, jnp.asarray(target), jnp.asarray(mask),
                       h_off) if packed else False
    valid = jnp.arange(t - 4)
    model = SGPModel(input_size=d, order=2, n_nodes=n, hidden_size=16,
                     mlp_size=8, output_size=1, n_layers=1, horizon=2,
                     positional_encoding=True, dropout=0.1)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key},
                        jnp.zeros((4, d)),
                        node_index=jnp.zeros(4, jnp.int32), iid=True)
    optimizer = optax.adam(1e-3)
    return (model, optimizer, params, optimizer.init(params),
            jnp.asarray(target), jnp.asarray(mask), valid, h_off,
            ScalerParams(jnp.zeros(1), jnp.ones(1)), pk)


def test_pipelined_multi_step_matches_unpipelined(rng):
    """pipeline=True must be a pure scheduling change: identical loss
    and parameter trajectory to the sequential scan (same keys)."""
    from sgp.train.iid import make_fused_iid_multi_step

    (model, opt, params, opt_state, tgt, msk, valid, h_off, sc,
     pk) = _tiny_iid_setup(rng)
    outs = {}
    for pipe in (False, True):
        step = make_fused_iid_multi_step(
            model, opt, None, tgt, msk, valid, h_off, sc,
            batch_size=32, steps_per_call=5, packed=pk, pipeline=pipe)
        p, s, loss = step(params, opt_state, jax.random.PRNGKey(7))
        outs[pipe] = (p, float(loss))
    np.testing.assert_allclose(outs[True][1], outs[False][1],
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(outs[True][0]),
                    jax.tree_util.tree_leaves(outs[False][0])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-7)


def test_compute_dtype_bf16_trains(rng):
    """bf16 fwd/bwd keeps f32 master params and stays close to the
    f32 step's loss on the same keys."""
    from sgp.train.iid import make_fused_iid_multi_step

    (model, opt, params, opt_state, tgt, msk, valid, h_off, sc,
     pk) = _tiny_iid_setup(rng)
    losses = {}
    for dt in (None, jnp.bfloat16):
        step = make_fused_iid_multi_step(
            model, opt, None, tgt, msk, valid, h_off, sc,
            batch_size=32, steps_per_call=5, packed=pk,
            compute_dtype=dt)
        p, s, loss = step(params, opt_state, jax.random.PRNGKey(3))
        losses[dt is None] = float(loss)
        # master params stay f32
        assert all(a.dtype == l.dtype for a, l in zip(
            jax.tree_util.tree_leaves(p),
            jax.tree_util.tree_leaves(params)))
        assert np.isfinite(losses[dt is None])
    assert abs(losses[True] - losses[False]) < 0.05 * (
        abs(losses[True]) + 1e-6) + 0.05
