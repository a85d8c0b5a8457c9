"""Numerical parity with the reference's torch implementation.

BASELINE.json requires per-layer encoder activation allclose with
imported reservoir weights. Here the reference reservoir/GESN update
rules (``lib/nn/reservoir/reservoir.py:77-81``, ``graph_reservoir.py:
85-93``) are executed in actual torch (CPU) with torch-generated
weights; the weights are exported into our JAX modules via
``from_arrays`` and the full forward activations compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sgp.encode import GraphESN, Reservoir, sgp_spatial_embedding  # noqa: E402
from sgp.graph import Graph, add_self_loops, coalesce, normalize_adj  # noqa: E402
from sgp.ops import build_operator  # noqa: E402

pytestmark = pytest.mark.slow


def torch_reservoir_layers(sizes, seed=0, density=0.7, rho=0.9,
                           alphas=None):
    """Generate weights with torch RNG following reservoir.py:54-75."""
    torch.manual_seed(seed)
    out = []
    for i, (f_in, h) in enumerate(sizes):
        w_ih = torch.empty(h, f_in).uniform_(-1, 1)
        b_ih = torch.empty(h).uniform_(-1, 1)
        w_hh = torch.empty(h, h).uniform_(-1, 1)
        if density < 1:
            n_units = h * h
            mask = torch.ones(n_units)
            drop = torch.randperm(n_units)[:int(n_units * (1 - density))]
            mask[drop] = 0.0
            w_hh = w_hh * mask.view(h, h)
        abs_eigs = torch.linalg.eigvals(w_hh).abs()
        w_hh = w_hh * (rho / abs_eigs.max())
        out.append(dict(w_ih=w_ih, w_hh=w_hh, b_ih=b_ih,
                        alpha=alphas[i] if alphas else 0.9))
    return out


def torch_reservoir_forward(layers, x):
    """reservoir.py:158-186 executed in torch."""
    t, n, _ = x.shape
    xt = torch.as_tensor(x)
    h = [torch.zeros(n, l["w_hh"].shape[0]) for l in layers]
    outs = []
    with torch.no_grad():
        for s in range(t):
            inp = xt[s]
            for i, l in enumerate(layers):
                pre = torch.nn.functional.linear(inp, l["w_ih"], l["b_ih"]) \
                    + torch.nn.functional.linear(h[i], l["w_hh"])
                h[i] = (1 - l["alpha"]) * h[i] + l["alpha"] * torch.tanh(pre)
                inp = h[i]
            outs.append(torch.cat(h, -1))
    return torch.stack(outs).numpy()


def test_reservoir_activations_match_torch(rng):
    layers = torch_reservoir_layers([(3, 16), (16, 16)], seed=1,
                                    alphas=[0.9, 0.8])
    x = rng.standard_normal((40, 7, 3)).astype(np.float32)
    expect = torch_reservoir_forward(layers, x)
    res = Reservoir.from_arrays(
        [{k: v.numpy() if hasattr(v, "numpy") else v
          for k, v in l.items()} for l in layers])
    got = np.asarray(res(jnp.asarray(x)))
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_spatial_propagation_matches_torch_dense(rng):
    """K-hop propagation vs torch dense matmul chain with the same
    row-normalized operator (sgp_preprocessing.py:200-203)."""
    g = coalesce(Graph(rng.integers(0, 15, 60), rng.integers(0, 15, 60),
                       rng.random(60).astype(np.float32), 15))
    gn = normalize_adj(g, "row")
    a_t = torch.as_tensor(gn.to_dense())
    x = rng.standard_normal((6, 15, 8)).astype(np.float32)
    res = sgp_spatial_embedding(jnp.asarray(x), g, k=3)
    cur = torch.as_tensor(x)
    with torch.no_grad():
        for j in range(1, 4):
            cur = torch.einsum("ij,tjf->tif", a_t, cur)
            np.testing.assert_allclose(np.asarray(res[j]), cur.numpy(),
                                       atol=2e-5)


def torch_gesn_forward(layers, x, a_dense):
    t, n, _ = x.shape
    xt = torch.as_tensor(x)
    at = torch.as_tensor(a_dense)
    h = [torch.zeros(n, l["w_hh"].shape[0]) for l in layers]
    outs = []
    with torch.no_grad():
        for s in range(t):
            inp = xt[s]
            for i, l in enumerate(layers):
                rec = at @ torch.nn.functional.linear(h[i], l["w_hh"])
                pre = torch.nn.functional.linear(inp, l["w_ih"],
                                                 l["b_ih"]) + rec
                h[i] = (1 - l["alpha"]) * h[i] + l["alpha"] * torch.tanh(pre)
                inp = h[i]
            outs.append(torch.cat(h, -1))
    return torch.stack(outs).numpy()


def test_gesn_activations_match_torch(rng):
    g = coalesce(Graph(rng.integers(0, 10, 40), rng.integers(0, 10, 40),
                       rng.random(40).astype(np.float32), 10))
    gn = normalize_adj(add_self_loops(g), "row")
    layers = torch_reservoir_layers([(2, 12), (12, 12)], seed=3,
                                    alphas=[0.9, 0.9])
    x = rng.standard_normal((25, 10, 2)).astype(np.float32)
    expect = torch_gesn_forward(layers, x, gn.to_dense())
    gesn = GraphESN.from_arrays(
        [{k: v.numpy() if hasattr(v, "numpy") else v
          for k, v in l.items()} for l in layers])
    got = np.asarray(gesn(jnp.asarray(x), build_operator(gn, "dense")))
    np.testing.assert_allclose(got, expect, atol=5e-5)


# ---------------------------------------------------------------------------
# Trained-layer oracles: one per baseline family —
# the reference LAYER equations executed in actual torch with the SAME
# weights as our flax modules, full forward allclose.

def _random_graph_np(n=12, e=60, seed=0):
    rng = np.random.default_rng(seed)
    return normalize_adj(coalesce(Graph(
        rng.integers(0, n, e), rng.integers(0, n, e),
        rng.random(e).astype(np.float32), n)), "row")


def test_diff_conv_matches_torch_oracle():
    """DiffConv == the reference's concat-of-diffusion-hops Linear
    (``tsl/nn/layers/graph_convs/diff_conv.py:94-105``): [x, A x,
    A^2 x, A' x, A'^2 x] @ W + b executed in torch."""
    import jax
    from sgp.models.graph_layers import DiffConv, diff_conv_support
    n, f, out, k = 12, 5, 7, 2
    g = _random_graph_np(n)
    sup = diff_conv_support(g)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, n, f)).astype(np.float32)
    layer = DiffConv(out_channels=out, k=k)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), sup)
    got = np.asarray(layer.apply(params, jnp.asarray(x), sup))

    kernel = np.asarray(params["params"]["Dense_0"]["kernel"])
    bias = np.asarray(params["params"]["Dense_0"]["bias"])
    a_fwd = np.zeros((n, n), np.float32)
    a_fwd[g.dst, g.src] = g.weight          # row-normalized fwd
    from sgp.graph import normalize_adj as _na, transpose as _tr
    gb = _na(_tr(g), "row")
    a_bwd = np.zeros((n, n), np.float32)
    a_bwd[gb.dst, gb.src] = gb.weight
    with torch.no_grad():
        xt = torch.as_tensor(x)
        outs = [xt]
        for a in (torch.as_tensor(a_fwd), torch.as_tensor(a_bwd)):
            cur = xt
            for _ in range(k):
                cur = torch.einsum("ij,bjf->bif", a, cur)
                outs.append(cur)
        lin = torch.nn.Linear(kernel.shape[0], out)
        lin.weight.copy_(torch.as_tensor(kernel.T))
        lin.bias.copy_(torch.as_tensor(bias))
        expect = lin(torch.cat(outs, -1)).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-5)


def test_gwnet_dense_diffusion_matches_torch_oracle():
    """DenseSpatialConvOrderK == the reference's dense order-K support
    concat (``tsl/nn/layers/graph_convs/dense_spatial_conv.py:59-80``)
    executed in torch."""
    import jax
    from sgp.models.gwnet import DenseSpatialConvOrderK
    n, f, out, order = 10, 4, 6, 2
    rng = np.random.default_rng(2)
    adj = rng.random((n, n)).astype(np.float32)
    sup = np.asarray(DenseSpatialConvOrderK.compute_support(
        jnp.asarray(adj)))
    x = rng.standard_normal((2, 3, n, f)).astype(np.float32)
    layer = DenseSpatialConvOrderK(output_size=out, order=order)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(sup))
    got = np.asarray(layer.apply(params, jnp.asarray(x),
                                 jnp.asarray(sup)))
    kernel = np.asarray(params["params"]["Dense_0"]["kernel"])
    bias = np.asarray(params["params"]["Dense_0"]["bias"])
    with torch.no_grad():
        xt = torch.as_tensor(x)
        outs = []
        for i in range(2):
            a = torch.as_tensor(sup[i])
            cur = xt
            for _ in range(order):
                cur = torch.einsum("ij,bsjf->bsif", a, cur)
                outs.append(cur)
        lin = torch.nn.Linear(kernel.shape[0], out)
        lin.weight.copy_(torch.as_tensor(kernel.T))
        lin.bias.copy_(torch.as_tensor(bias))
        expect = lin(torch.cat(outs, -1)).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-5)


def _torch_gated_gn(x, src, dst, P, act=torch.nn.functional.silu):
    """The reference GatedGraphNetwork forward
    (``tsl/nn/layers/graph_convs/gated_gn.py:53-64``) in torch: our
    split node-space projections recombine into its concat Dense
    (W = [W_i; W_j], b = b_i)."""
    def lin(name, t, bias_name=None):
        w = torch.as_tensor(np.asarray(P[name]["kernel"]))
        y = t @ w
        if bias_name is None and "bias" in P[name]:
            y = y + torch.as_tensor(np.asarray(P[name]["bias"]))
        return y
    xt = torch.as_tensor(x)
    x_i, x_j = xt[..., dst, :], xt[..., src, :]
    # msg_mlp: Linear(2F -> h/2) act Linear(h/2 -> h) act
    w_cat = torch.cat([torch.as_tensor(np.asarray(P["Dense_0"]["kernel"])),
                       torch.as_tensor(np.asarray(P["Dense_1"]["kernel"]))],
                      0)
    b1 = torch.as_tensor(np.asarray(P["Dense_0"]["bias"]))
    m = act(torch.cat([x_i, x_j], -1) @ w_cat + b1)
    m = act(lin("Dense_2", m))
    gate = torch.sigmoid(lin("Dense_3", m))
    m = gate * m
    n = x.shape[-2]
    agg = torch.zeros(x.shape[:-2] + (n, m.shape[-1]))
    agg.index_add_(-2, torch.as_tensor(dst), m)
    out = lin("Dense_4", torch.cat([agg, xt], -1))
    out = lin("Dense_5", act(out))
    skip = lin("Dense_6", xt) if "Dense_6" in P else xt
    return (out + skip).numpy()


@pytest.mark.parametrize("layout", ["edges", "dense"])
def test_gated_gn_layer_matches_torch_oracle(layout):
    """GatedGraphNetwork (edge-list and dense all-pairs layouts) == the
    reference message/gate/update math executed in torch with identical
    weights."""
    import jax
    from sgp.models.graph_layers import GatedGraphNetwork
    n, f, out = 10, 6, 8
    g = _random_graph_np(n, 40, seed=3)
    src, dst = g.src.astype(np.int32), g.dst.astype(np.int32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, n, f)).astype(np.float32)
    layer = GatedGraphNetwork(output_size=out)
    if layout == "edges":
        args = dict(src=jnp.asarray(src), dst=jnp.asarray(dst))
    else:
        adj = np.zeros((n, n), np.float32)
        adj[dst, src] = 1.0
        args = dict(adj=jnp.asarray(adj))
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), **args)
    got = np.asarray(layer.apply(params, jnp.asarray(x), **args))
    with torch.no_grad():
        expect = _torch_gated_gn(x, src, dst, params["params"])
    np.testing.assert_allclose(got, expect, atol=3e-5)
