"""Model blocks and decoder models: shape/semantics oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.models import (GroupedLinear, LinearReadout, SGPModel,
                        StaticGraphEmbedding)
from sgp.models.blocks import MLP, ResidualMLP
from sgp.models.esn import ESNModel
from sgp.models.rnn import FCRNNModel, RNNModel


def init_apply(model, *args, **kwargs):
    rng = jax.random.PRNGKey(0)
    params = model.init({"params": rng, "dropout": rng}, *args, **kwargs)
    return params, model.apply(params, *args, **kwargs)


def test_grouped_linear_block_diagonal(rng):
    x = jnp.asarray(rng.standard_normal((5, 12)).astype(np.float32))
    m = GroupedLinear(output_size=8, groups=4)
    params, out = init_apply(m, x)
    assert out.shape == (5, 8)
    # oracle: apply each group separately
    w = params["params"]["kernel"]  # [4, 3, 2]
    b = params["params"]["bias"]
    expect = np.concatenate(
        [np.asarray(x)[:, g * 3:(g + 1) * 3] @ np.asarray(w[g])
         for g in range(4)], -1) + np.asarray(b)
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)


def test_linear_readout_shapes(rng):
    x = jnp.asarray(rng.standard_normal((3, 7, 16)).astype(np.float32))
    _, out = init_apply(LinearReadout(output_size=2, horizon=5), x)
    assert out.shape == (3, 5, 7, 2)
    # 4-dim input takes last step
    x4 = jnp.asarray(rng.standard_normal((3, 9, 7, 16)).astype(np.float32))
    m = LinearReadout(output_size=2, horizon=5)
    p = m.init(jax.random.PRNGKey(0), x4)
    out4 = m.apply(p, x4)
    out_last = m.apply(p, x4[:, -1])
    np.testing.assert_allclose(np.asarray(out4), np.asarray(out_last),
                               atol=1e-6)


def test_mlp_residual_shapes(rng):
    x = jnp.asarray(rng.standard_normal((4, 6, 10)).astype(np.float32))
    _, out = init_apply(MLP(hidden_size=32, n_layers=2), x)
    assert out.shape == (4, 6, 32)
    _, out2 = init_apply(ResidualMLP(hidden_size=32, n_layers=2,
                                     parametrized_skip=True), x)
    assert out2.shape == (4, 6, 32)


def test_static_graph_embedding(rng):
    m = StaticGraphEmbedding(n_tokens=10, emb_size=4)
    params = m.init(jax.random.PRNGKey(0))
    full = m.apply(params)
    sub = m.apply(params, token_index=jnp.array([2, 7]))
    np.testing.assert_allclose(np.asarray(sub), np.asarray(full)[[2, 7]])


def test_sgp_model_full_graph(rng):
    b, n, order, f = 4, 9, 3, 24
    x = jnp.asarray(rng.standard_normal((b, 1, n, f)).astype(np.float32))
    m = SGPModel(input_size=f, order=order, n_nodes=n, hidden_size=32,
                 mlp_size=16, output_size=1, n_layers=2, horizon=6,
                 positional_encoding=True, resnet=True)
    _, out = init_apply(m, x)
    assert out.shape == (b, 6, n, 1)


def test_sgp_model_iid(rng):
    b, n, order, f = 8, 9, 3, 24
    x = jnp.asarray(rng.standard_normal((b, 1, f)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, n, b))
    m = SGPModel(input_size=f, order=order, n_nodes=n, hidden_size=32,
                 mlp_size=16, output_size=1, n_layers=1, horizon=6,
                 positional_encoding=True)
    rngk = jax.random.PRNGKey(0)
    params = m.init({"params": rngk, "dropout": rngk}, x, node_index=idx,
                    iid=True)
    out = m.apply(params, x, node_index=idx, iid=True)
    assert out.shape == (b, 6, 1)
    # IID per-pair forward must agree with full-graph forward on the
    # same features (same params): node i sampled -> same output
    xg = jnp.asarray(rng.standard_normal((1, 1, n, f)).astype(np.float32))
    out_full = m.apply(params, xg)
    out_iid = m.apply(params, xg[0, :, 3][None], node_index=jnp.array([3]),
                      iid=True)
    np.testing.assert_allclose(np.asarray(out_iid[0]),
                               np.asarray(out_full[0, :, 3]), atol=1e-5)


def test_sgp_model_with_exog(rng):
    b, n, order, f = 4, 9, 3, 24
    x = jnp.asarray(rng.standard_normal((b, 1, n, f)).astype(np.float32))
    u = jnp.asarray(rng.standard_normal((b, 1, 2)).astype(np.float32))
    m = SGPModel(input_size=f, order=order, n_nodes=n, hidden_size=30,
                 mlp_size=16, output_size=1, n_layers=1, horizon=3,
                 positional_encoding=False, exog_size=2)
    rngk = jax.random.PRNGKey(0)
    params = m.init({"params": rngk, "dropout": rngk}, x, u=u)
    out = m.apply(params, x, u=u)
    assert out.shape == (b, 3, n, 1)


def test_esn_model(rng):
    x = jnp.asarray(rng.standard_normal((2, 12, 5, 1)).astype(np.float32))
    m = ESNModel.build(input_size=1, hidden_size=16, output_size=1,
                       exog_size=0, rec_layers=2, horizon=4)
    _, out = init_apply(m, x)
    assert out.shape == (2, 4, 5, 1)


def test_rnn_model(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 5, 1)).astype(np.float32))
    m = RNNModel(output_size=1, horizon=4, hidden_size=16, ff_size=16)
    _, out = init_apply(m, x)
    assert out.shape == (2, 4, 5, 1)


def test_fc_rnn_model(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 5, 1)).astype(np.float32))
    m = FCRNNModel(n_nodes=5, output_size=1, horizon=4, hidden_size=16,
                   ff_size=16)
    _, out = init_apply(m, x)
    assert out.shape == (2, 4, 5, 1)


def test_gwnet_scan_matches_unrolled(rng):
    """scan-over-layer-blocks GWNet == the unrolled block stack when the
    per-block params are stacked."""
    import jax
    import jax.numpy as jnp

    from sgp.graph import Graph, coalesce, normalize_adj
    from sgp.models.gwnet import GraphWaveNetModel
    from sgp.ops import build_operator

    n = 8
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, n, 30), rng.integers(0, n, 30),
        rng.random(30).astype(np.float32), n)), "row")
    ops = [build_operator(g, "dense")]
    x = jnp.asarray(rng.standard_normal((2, 6, n, 3)).astype(np.float32))
    kw = dict(hidden_size=8, ff_size=8, output_size=1, horizon=2,
              n_layers=4, n_nodes=n)
    m_loop = GraphWaveNetModel(scan_layers=False, **kw)
    m_scan = GraphWaveNetModel(scan_layers=True, **kw)
    key = jax.random.PRNGKey(0)
    p_loop = m_loop.init({"params": key, "dropout": key}, x, ops)
    p_scan = m_scan.init({"params": key, "dropout": key}, x, ops)
    y_loop = m_loop.apply(p_loop, x, ops)

    # stack the unrolled per-block params into the scan layout
    blocks = [p_loop["params"][f"_GWNetBlock_{i}"] for i in range(2)]
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *blocks)
    p2 = dict(p_loop["params"])
    for i in range(2):
        del p2[f"_GWNetBlock_{i}"]
    scan_key = [k for k in p_scan["params"] if "GWNetBlock" in k][0]
    p2[scan_key] = stacked
    y_scan = m_scan.apply({"params": p2}, x, ops)
    np.testing.assert_allclose(np.asarray(y_scan), np.asarray(y_loop),
                               atol=1e-5)


def test_gwnet_nondivisible_dilation_cycle(rng):
    """n_layers % dilation_mod != 0 must still apply the cycling
    dilations 2**(i % mod) per layer (regression: the block fallback
    once ran every layer at dilations[0]). With dilations [1, 2, 1] and
    kernel 2 the receptive field is 5, so a perturbation at t=0 of a
    length-5 buffer must reach the readout (it cannot at d=1 uniform,
    where the field is only 4)."""
    import jax
    import jax.numpy as jnp

    from sgp.graph import Graph, coalesce, normalize_adj
    from sgp.models.gwnet import GraphWaveNetModel
    from sgp.ops import build_operator

    n = 6
    g = normalize_adj(coalesce(Graph(
        rng.integers(0, n, 20), rng.integers(0, n, 20),
        rng.random(20).astype(np.float32), n)), "row")
    ops = [build_operator(g, "dense")]
    m = GraphWaveNetModel(hidden_size=8, ff_size=8, output_size=1,
                          horizon=2, n_layers=3, n_nodes=n,
                          dilation=2, dilation_mod=2, norm="layer")
    x = jnp.asarray(rng.standard_normal((1, 5, n, 3)).astype(np.float32))
    key = jax.random.PRNGKey(0)
    p = m.init({"params": key, "dropout": key}, x, ops)
    y0 = m.apply(p, x, ops)
    y1 = m.apply(p, x.at[:, 0].add(10.0), ops)
    assert not np.allclose(np.asarray(y0), np.asarray(y1)), \
        "t=0 perturbation lost: cycling dilation not applied"


def test_gwnet_constant_buffer_masked_norm_lemmas(rng):
    """The two lemmas behind loop==shrinking equivalence: (a) causal
    left-pad conv tail == VALID conv; (b) Norm('batch') with time_mask
    == Norm over the valid slice."""
    import jax
    import jax.numpy as jnp

    from sgp.models.tcn import Norm, TemporalConv

    x = jnp.asarray(rng.standard_normal((2, 9, 4, 3)).astype(np.float32))
    key = jax.random.PRNGKey(1)
    conv_pad = TemporalConv(5, 2, dilation=2, causal_pad=True)
    p = conv_pad.init(key, x)
    y_pad = conv_pad.apply(p, x)
    conv_valid = TemporalConv(5, 2, dilation=2, causal_pad=False)
    y_valid = conv_valid.apply(p, x)          # same param shapes
    np.testing.assert_allclose(np.asarray(y_pad[:, -y_valid.shape[1]:]),
                               np.asarray(y_valid), atol=1e-5)

    norm = Norm("batch")
    pn = norm.init(key, x)
    mask = jnp.arange(9) >= 3
    y_masked = norm.apply(pn, x, time_mask=mask)
    y_slice = norm.apply(pn, x[:, 3:])
    np.testing.assert_allclose(np.asarray(y_masked[:, 3:]),
                               np.asarray(y_slice), atol=1e-5)


def test_linear_matches_flax_dense(rng):
    """The plain-JAX Linear names, seeds and computes its parameters as
    flax.linen.Dense does (the trees and checkpoints interchange)."""
    import flax.linen as nn

    from sgp.models.blocks import Linear
    x = jnp.asarray(rng.standard_normal((5, 7)).astype(np.float32))
    key = jax.random.PRNGKey(3)
    ours = Linear(11).init({"params": key}, x)
    theirs = nn.Dense(11).init({"params": key}, x)
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(np.asarray(ours["params"][leaf]),
                                      np.asarray(theirs["params"][leaf]))
    np.testing.assert_array_equal(
        np.asarray(Linear(11).apply(ours, x)),
        np.asarray(nn.Dense(11).apply(theirs, x)))


def test_sgp_model_param_tree_names(rng):
    """flax auto-names: counters per class name and scope, "Dense"
    shared between the linear layer and the Dense block."""
    m = SGPModel(input_size=24, order=3, n_nodes=9, hidden_size=32,
                 mlp_size=16, output_size=1, n_layers=2, horizon=6,
                 positional_encoding=True, resnet=True)
    x = jnp.zeros((4, 24))
    p = m.init({"params": jax.random.PRNGKey(0)}, x,
               node_index=jnp.zeros(4, jnp.int32), iid=True)
    paths = sorted(jax.tree_util.keystr(k) for k, _ in
                   jax.tree_util.tree_flatten_with_path(p)[0])
    # per layer: Dense block (nested Linear), Linear, skip Linear
    trunk = [f"['params']['ResidualMLP_0']['{d}']"
             for d in ("Dense_0']['Dense_0", "Dense_1", "Dense_2",
                       "Dense_3']['Dense_0", "Dense_4", "Dense_5")]
    want = (["['params']['Dense_0']", "['params']['GroupedLinear_0']",
             "['params']['LinearReadout_0']['Dense_0']"] + trunk)
    want = sorted(f"{w}['{leaf}']" for w in want
                  for leaf in ("bias", "kernel")) + \
        ["['params']['StaticGraphEmbedding_0']['emb']"]
    assert paths == sorted(want)


def test_sgp_model_dropout_uses_the_dropout_stream(rng):
    x = jnp.asarray(rng.standard_normal((4, 1, 5, 24)).astype(np.float32))
    m = SGPModel(input_size=24, order=3, n_nodes=5, hidden_size=30,
                 mlp_size=16, output_size=1, n_layers=1, horizon=2,
                 dropout=0.5)
    p = m.init({"params": jax.random.PRNGKey(0)}, x)
    run = lambda k: np.asarray(m.apply(  # noqa: E731
        p, x, training=True, rngs={"dropout": jax.random.PRNGKey(k)}))
    np.testing.assert_array_equal(run(1), run(1))
    assert not np.array_equal(run(1), run(2))
    assert not np.array_equal(run(1), np.asarray(m.apply(p, x)))
    with pytest.raises(KeyError, match="dropout"):
        m.apply(p, x, training=True)
