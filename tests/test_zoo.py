"""Zoo completeness: attention, transformers, graph layers, STCN/TCN/
GCN-decoder models, GRIN imputation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgp.graph import Graph, coalesce, normalize_adj
from sgp.models.attention import (AttentionEncoder,
                                  CausalLinearAttention,
                                  MultiHeadAttention,
                                  PositionalEncoding,
                                  SpatioTemporalTransformerLayer,
                                  TransformerLayer, TransformerModel)
from sgp.models.graph_layers import (GATConv, GraphConv,
                                     SpatioTemporalAttention,
                                     diff_conv_support)
from sgp.models.grin import GRIL, GRINModel
from sgp.models.stgn_extra import (AttPool, ConditionalTCNBlock,
                                   DenseDCRNNCell, GCNDecoder,
                                   GraphConvRNN, InputEncoder,
                                   MultiHorizonMLPDecoder,
                                   RNNEncGCNDecModel, STCNModel,
                                   TCNModel)
from sgp.ops import build_operator


def init_apply(model, *args, **kwargs):
    rng = jax.random.PRNGKey(0)
    params = model.init({"params": rng, "dropout": rng}, *args, **kwargs)
    return params, model.apply(params, *args, **kwargs)


@pytest.fixture
def graph(rng):
    n = 8
    return coalesce(Graph(rng.integers(0, n, 30), rng.integers(0, n, 30),
                          rng.random(30).astype(np.float32), n))


@pytest.fixture
def op(graph):
    return build_operator(normalize_adj(graph, "row"), "dense")


def test_positional_encoding(rng):
    x = jnp.zeros((2, 10, 4, 8))
    _, out = init_apply(PositionalEncoding(), x)
    assert out.shape == x.shape
    # encodings vary over time, constant over nodes
    assert not np.allclose(out[0, 0], out[0, 5])
    np.testing.assert_allclose(out[0, 3, 0], out[0, 3, 2])


def test_mha_time_and_nodes(rng):
    x = jnp.asarray(rng.standard_normal((2, 6, 4, 16)).astype(np.float32))
    for axis in ("time", "nodes"):
        _, out = init_apply(MultiHeadAttention(16, 4, axis=axis), x)
        assert out.shape == x.shape


def test_mha_causal(rng):
    """Causal attention: output at step t must not depend on steps > t."""
    x = np.asarray(rng.standard_normal((1, 8, 1, 16)), np.float32)
    m = MultiHeadAttention(16, 2, axis="time", causal=True)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out1 = m.apply(params, jnp.asarray(x))
    x2 = x.copy()
    x2[:, 5:] += 100.0  # perturb the future
    out2 = m.apply(params, jnp.asarray(x2))
    np.testing.assert_allclose(np.asarray(out1)[:, :5],
                               np.asarray(out2)[:, :5], atol=1e-5)


def test_attention_encoder_and_linear(rng):
    x = jnp.asarray(rng.standard_normal((2, 7, 16)).astype(np.float32))
    _, out = init_apply(AttentionEncoder(16, 2, axis="time"), x)
    assert out.shape == (2, 7, 16)
    _, out2 = init_apply(CausalLinearAttention(16, 2), x)
    assert out2.shape == (2, 7, 16)


def test_causal_linear_attention_causality(rng):
    x = np.asarray(rng.standard_normal((1, 8, 16)), np.float32)
    m = CausalLinearAttention(16, 2)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out1 = np.asarray(m.apply(params, jnp.asarray(x)))
    x2 = x.copy()
    x2[:, 6:] += 50
    out2 = np.asarray(m.apply(params, jnp.asarray(x2)))
    np.testing.assert_allclose(out1[:, :6], out2[:, :6], atol=1e-4)


def test_transformer_layers_and_model(rng):
    x = jnp.asarray(rng.standard_normal((2, 6, 4, 8)).astype(np.float32))
    _, out = init_apply(TransformerLayer(16, 32, 2), x)
    assert out.shape == (2, 6, 4, 16)
    _, out2 = init_apply(SpatioTemporalTransformerLayer(16, 32, 2), x)
    assert out2.shape == (2, 6, 4, 16)
    m = TransformerModel(hidden_size=16, ff_size=32, output_size=1,
                         horizon=3, n_layers=2, n_heads=2, axis="both")
    _, out3 = init_apply(m, x)
    assert out3.shape == (2, 3, 4, 1)


def test_graph_conv(rng, graph, op):
    x = jnp.asarray(rng.standard_normal((3, 8, 5)).astype(np.float32))
    params, out = init_apply(GraphConv(12), x, op)
    assert out.shape == (3, 8, 12)
    # oracle: A (x W) + x W_root + b
    p = params["params"]
    expect = (np.einsum("ij,bjf->bif", np.asarray(op.mat),
                        np.asarray(x) @ np.asarray(p["Dense_0"]["kernel"]))
              + np.asarray(x) @ np.asarray(p["root"]["kernel"])
              + np.asarray(p["bias"]))
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-4)


def test_gat_conv(rng, graph):
    x = jnp.asarray(rng.standard_normal((8, 6)).astype(np.float32))
    src = jnp.asarray(graph.src.astype(np.int32))
    dst = jnp.asarray(graph.dst.astype(np.int32))
    _, out = init_apply(GATConv(4, heads=2), x, src, dst)
    assert out.shape == (8, 8)  # heads * out
    xb = jnp.asarray(rng.standard_normal((3, 8, 6)).astype(np.float32))
    _, outb = init_apply(GATConv(4, heads=2, concat=False), xb, src, dst)
    assert outb.shape == (3, 8, 4)


def test_spatiotemporal_attention(rng):
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 8)).astype(np.float32))
    _, out = init_apply(SpatioTemporalAttention(16, 2), x)
    assert out.shape == (2, 5, 4, 16)


def test_graph_conv_rnn(rng, op):
    x = jnp.asarray(rng.standard_normal((2, 5, 8, 3)).astype(np.float32))
    for cell in ("gru", "lstm"):
        _, out = init_apply(GraphConvRNN(12, 2, cell), x, op)
        assert out.shape == (2, 8, 12)


def test_dense_dcrnn_cell(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 4)).astype(np.float32))
    h = jnp.zeros((2, 8, 12))
    adj = jnp.asarray(rng.random((8, 8)).astype(np.float32))
    _, out = init_apply(DenseDCRNNCell(12), x, h, adj)
    assert out.shape == (2, 8, 12)


def test_conditional_tcn_and_input_encoder(rng):
    x = jnp.asarray(rng.standard_normal((2, 9, 4, 3)).astype(np.float32))
    u = jnp.asarray(rng.standard_normal((2, 9, 4, 2)).astype(np.float32))
    _, out = init_apply(ConditionalTCNBlock(16, gated=True), x, u)
    assert out.shape == (2, 9, 4, 16)
    _, out2 = init_apply(InputEncoder(16, "conditional"), x,
                         u=jnp.asarray(rng.standard_normal(
                             (2, 9, 2)).astype(np.float32)))
    assert out2.shape == (2, 9, 4, 16)


def test_decoders(rng, op):
    h = jnp.asarray(rng.standard_normal((2, 8, 16)).astype(np.float32))
    _, out = init_apply(MultiHorizonMLPDecoder(16, 1, horizon=4), h)
    assert out.shape == (2, 4, 8, 1)
    _, out2 = init_apply(GCNDecoder(16, 1, horizon=4), h, op)
    assert out2.shape == (2, 4, 8, 1)
    x = jnp.asarray(rng.standard_normal((2, 6, 16)).astype(np.float32))
    _, pooled = init_apply(AttPool(axis=1), x)
    assert pooled.shape == (2, 16)


def test_stcn_tcn_rnn2gcn_models(rng, op):
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 1)).astype(np.float32))
    _, out = init_apply(TCNModel(16, 32, 1, horizon=3), x)
    assert out.shape == (2, 3, 8, 1)
    _, out2 = init_apply(STCNModel(16, 32, 1, horizon=3), x, op)
    assert out2.shape == (2, 3, 8, 1)
    _, out3 = init_apply(RNNEncGCNDecModel(16, 1, horizon=3), x, op)
    assert out3.shape == (2, 3, 8, 1)


def test_gril_and_grin(rng, graph):
    sup = diff_conv_support(graph, operator_mode="dense")
    x = jnp.asarray(rng.standard_normal((2, 6, 8, 1)).astype(np.float32))
    mask = jnp.asarray(rng.random((2, 6, 8, 1)) > 0.3).astype(jnp.float32)
    gril = GRIL(input_size=1, hidden_size=8, n_nodes=8)
    rngk = jax.random.PRNGKey(0)
    params = gril.init({"params": rngk}, x, sup, mask=mask)
    imp, pred, reprs = gril.apply(params, x, sup, mask=mask)
    assert imp.shape == x.shape and pred.shape == x.shape
    model = GRINModel(input_size=1, hidden_size=8, n_nodes=8)
    params = model.init({"params": rngk, "dropout": rngk}, x, sup,
                        mask=mask)
    merged, (f_i, f_p), (b_i, b_p) = model.apply(params, x, sup,
                                                 mask=mask)
    assert merged.shape == x.shape
    assert np.isfinite(np.asarray(merged)).all()


def test_imputer_train_step(rng, graph):
    import optax
    from sgp.train.imputer import make_imputer_train_step
    sup = diff_conv_support(graph, operator_mode="dense")
    model = GRINModel(input_size=1, hidden_size=8, n_nodes=8)
    x = jnp.asarray(rng.standard_normal((2, 6, 8, 1)).astype(np.float32))
    mask = jnp.asarray((rng.random((2, 6, 8, 1)) > 0.2).astype(np.float32))
    rngk = jax.random.PRNGKey(0)
    params = model.init({"params": rngk, "dropout": rngk}, x, sup,
                        mask=mask)
    opt = optax.adam(1e-3)

    def to_call(batch, training):
        return (batch["x"], sup), {"mask": batch["mask"],
                                   "training": training}

    step = make_imputer_train_step(model, opt, to_call)
    p2, _, loss = step(params, opt.init(params),
                       {"x": x, "mask": mask}, rngk)
    assert np.isfinite(float(loss))


def test_link_predictor_and_nri(rng):
    from sgp.models.stgn_extra import LinkPredictor, NRIDCRNN
    x = jnp.asarray(rng.standard_normal((10, 6)).astype(np.float32))
    _, scores = init_apply(LinkPredictor(ff_size=8, hidden_size=4), x)
    assert scores.shape == (10, 10)
    xb = jnp.asarray(rng.standard_normal((2, 5, 10, 3)).astype(np.float32))
    m = NRIDCRNN(hidden_size=8, emb_size=4, n_nodes=10, k=1)
    rngk = jax.random.PRNGKey(0)
    params = m.init({"params": rngk, "dropout": rngk}, xb)
    out = m.apply(params, xb)
    assert out.shape == (2, 10, 8)
    # training mode samples the adjacency differentiably
    out_t = m.apply(params, xb, rng=rngk, training=True)
    assert np.isfinite(np.asarray(out_t)).all()


def test_rnni_imputer(rng):
    """RNNI autoregressive imputer: shape contract, both modes, both
    cells, and the one-step-ahead causality property — preds[t] must
    not depend on x[t:] (prediction of step t uses data up to t-1)."""
    from sgp.models.rnni import RNNImputerModel
    x = jnp.asarray(rng.standard_normal((2, 6, 4, 3)).astype(np.float32))
    mask = jnp.asarray((rng.random((2, 6, 4, 3)) > 0.3)
                       .astype(np.float32))
    for indep in (False, True):
        for cell in ("gru", "lstm"):
            m = RNNImputerModel(input_size=3, hidden_size=8, n_nodes=4,
                                cell=cell,
                                process_nodes_independently=indep)
            params = m.init(jax.random.PRNGKey(0), x, mask)
            out = m.apply(params, x, mask)
            assert out.shape == x.shape
            assert np.isfinite(np.asarray(out)).all()
    # causality: perturb the last two steps; preds up to that point
    # must be identical
    m = RNNImputerModel(input_size=3, hidden_size=8, n_nodes=4)
    params = m.init(jax.random.PRNGKey(0), x, mask)
    out_a = m.apply(params, x, mask)
    x_b = x.at[:, 4:].set(99.0)
    out_b = m.apply(params, x_b, mask)
    np.testing.assert_allclose(np.asarray(out_a[:, :5]),
                               np.asarray(out_b[:, :5]), rtol=1e-6)
    # return_hidden contract
    out, h = m.apply(params, x, mask, return_hidden=True)
    assert h.shape == (2, 6, 8)
    m2 = RNNImputerModel(input_size=3, hidden_size=8, n_nodes=4,
                         process_nodes_independently=True)
    p2 = m2.init(jax.random.PRNGKey(0), x, mask)
    _, h2 = m2.apply(p2, x, mask, return_hidden=True)
    assert h2.shape == (2, 6, 4, 8)


def test_birnni_imputer(rng):
    """BiRNNI: merged output + (fwd, bwd) aux predictions; the backward
    pass gives the merged imputation access to FUTURE observations, so
    unlike the causal fwd stream the merged output at t<4 changes when
    x[4:] is perturbed."""
    from sgp.models.rnni import BiRNNImputerModel
    x = jnp.asarray(rng.standard_normal((2, 6, 4, 3)).astype(np.float32))
    mask = jnp.asarray((rng.random((2, 6, 4, 3)) > 0.3)
                       .astype(np.float32))
    for indep in (False, True):
        m = BiRNNImputerModel(input_size=3, hidden_size=8, n_nodes=4,
                              dropout=0.1,
                              process_nodes_independently=indep)
        params = m.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, x, mask)
        merged, (fwd, bwd) = m.apply(params, x, mask)
        assert merged.shape == x.shape == fwd.shape == bwd.shape
        assert np.isfinite(np.asarray(merged)).all()
    merged_b, (fwd_b, _) = m.apply(params, x.at[:, 4:].set(99.0), mask)
    np.testing.assert_allclose(np.asarray(fwd[:, :5]),
                               np.asarray(fwd_b[:, :5]), rtol=1e-6)
    assert not np.allclose(np.asarray(merged[:, :4]),
                           np.asarray(merged_b[:, :4]))


def test_imputer_step_rnni(rng):
    """The generalized imputer train step drives the RNNI contracts
    (bare array and (merged, aux-tuple)) and reduces the loss."""
    import optax
    from sgp.models.rnni import BiRNNImputerModel, RNNImputerModel
    from sgp.train.imputer import make_imputer_train_step
    x = jnp.asarray(rng.standard_normal((4, 6, 4, 1)).astype(np.float32))
    mask = jnp.asarray((rng.random((4, 6, 4, 1)) > 0.2)
                       .astype(np.float32))
    batch = {"x": x, "mask": mask}
    for cls in (RNNImputerModel, BiRNNImputerModel):
        m = cls(input_size=1, hidden_size=8, n_nodes=4)
        params = m.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, x, mask)
        opt = optax.adam(5e-3)

        def to_call(b, training):
            return (b["x"], b["mask"]), {"training": training}

        step = make_imputer_train_step(m, opt, to_call, whiten_prob=0.2)
        state = opt.init(params)
        key = jax.random.PRNGKey(7)
        losses = []
        for i in range(30):
            key, k = jax.random.split(key)
            params, state, loss = step(params, state, batch, k)
            losses.append(float(loss))
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
