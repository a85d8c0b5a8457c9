"""Trainable NN blocks of the SGP decoder, in plain JAX.

Counterparts of the reference block zoo used by the SGP decoder:
``tsl/nn/base/dense.py``, ``blocks/encoders/mlp.py`` (MLP/ResidualMLP),
``blocks/decoders/linear_readout.py``, ``base/embedding.py``
(StaticGraphEmbedding); plus the grouped 1x1 Conv1d
(``lib/nn/models/sgp_model.py:41-52``) re-expressed as a block-diagonal
einsum (``GroupedLinear``).

Each layer is a frozen dataclass with flax.linen's calling convention:
``init(rngs, *args)`` returns ``{"params": tree}`` and
``apply(variables, *args, rngs=...)`` runs the forward. Parameters are
named and seeded exactly as flax's auto-naming would (``Dense_0/kernel``,
one SHA-1 fold of the scope path per draw), so parameter trees, their
initial values and saved checkpoints are the same as with flax. The flax
baselines keep their own blocks in :mod:`sgp.models.flax_blocks`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional

import jax
import jax.numpy as jnp

_ACT = {
    "relu": jax.nn.relu, "silu": jax.nn.silu, "elu": jax.nn.elu,
    "tanh": jnp.tanh, "leaky_relu": jax.nn.leaky_relu,
    "sigmoid": jax.nn.sigmoid, "gelu": jax.nn.gelu,
    "softplus": jax.nn.softplus, "identity": lambda x: x,
    "linear": lambda x: x,
}

_lecun_normal = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros


def get_activation(name: str) -> Callable:
    return _ACT[name]


def maybe_cat_exog(x, u):
    """Concat exogenous onto x along channels, broadcasting missing axes
    (``tsl/nn/utils/utils.py`` ``maybe_cat_exog``)."""
    if u is None:
        return x
    if u.ndim < x.ndim:  # u [..., F] global vs x [..., N, C]
        u = jnp.broadcast_to(u[..., None, :],
                             x.shape[:-1] + (u.shape[-1],))
    return jnp.concatenate([x, u], axis=-1)


def _fold_in_path(key, path):
    """Fold a scope path (names, then a draw counter) into ``key`` as
    one SHA-1 digest — flax's derivation of per-parameter keys."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class Scope:
    """The parameters and random streams of one module call. Children
    are named ``<Class>_<i>`` in call order, per class name."""

    def __init__(self, tree: dict, rngs: dict, initializing: bool,
                 path: tuple = ()):
        self.tree, self.rngs = tree, rngs
        self.initializing, self.path = initializing, path
        self._n_children: dict = {}
        self._n_draws: dict = {}

    def call(self, module: "Module", *args, **kwargs):
        """Run ``module`` as the next child of this scope."""
        prefix = module.scope_name or type(module).__name__
        i = self._n_children.get(prefix, 0)
        self._n_children[prefix] = i + 1
        child = Scope(self.tree, self.rngs, self.initializing,
                      self.path + (f"{prefix}_{i}",))
        return module(child, *args, **kwargs)

    def make_rng(self, collection: str):
        if collection not in self.rngs:
            if "params" not in self.rngs:
                raise KeyError(f"{'/'.join(self.path)} needs a "
                               f"{collection!r} PRNG key")
            collection = "params"
        n = self._n_draws.get(collection, 0) + 1
        self._n_draws[collection] = n
        return _fold_in_path(self.rngs[collection], self.path + (n,))

    def param(self, name: str, init_fn: Callable, shape: tuple):
        node = self.tree
        for p in self.path:
            node = node.setdefault(p, {}) if self.initializing else node[p]
        if name not in node:
            if not self.initializing:
                raise KeyError(f"missing parameter "
                               f"{'/'.join(self.path + (name,))}")
            node[name] = init_fn(self.make_rng("params"), shape,
                                 jnp.float32)
        return node[name]


class Module:
    """Base of the layers. A subclass is a frozen dataclass whose
    ``__call__(scope, *args, **kwargs)`` reads its parameters through
    ``scope.param`` and runs its children through ``scope.call``."""

    scope_name: Optional[str] = None   # child-name prefix; class name

    def init(self, rngs, *args, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        scope = Scope({}, rngs, initializing=True)
        self(scope, *args, **kwargs)
        return {"params": scope.tree}

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None,
              **kwargs):
        return self(Scope(variables["params"], rngs or {},
                          initializing=False), *args, **kwargs)


@dataclasses.dataclass(frozen=True)
class Linear(Module):
    """``x @ kernel + bias`` with a LeCun-normal kernel and zero bias
    (flax.linen.Dense; inputs and parameters promote to a common
    dtype)."""
    features: int
    scope_name = "Dense"

    def __call__(self, s: Scope, x):
        kernel = s.param("kernel", _lecun_normal,
                         (x.shape[-1], self.features))
        bias = s.param("bias", _zeros, (self.features,))
        dtype = jnp.result_type(x, kernel, bias)
        x, kernel, bias = (jnp.asarray(a, dtype) for a in (x, kernel, bias))
        y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        return y + bias


@dataclasses.dataclass(frozen=True)
class Dropout(Module):
    """Inverted dropout drawing from the ``dropout`` stream."""
    rate: float

    def __call__(self, s: Scope, x, training: bool = False):
        if self.rate == 0.0 or not training:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(s.make_rng("dropout"), p=keep,
                                    shape=x.shape)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Dense(Module):
    """Linear -> activation -> dropout (``tsl/nn/base/dense.py:6-25``)."""
    output_size: int
    activation: str = "relu"
    dropout: float = 0.0

    def __call__(self, s: Scope, x, training: bool = False):
        x = _ACT[self.activation](s.call(Linear(self.output_size), x))
        if self.dropout > 0:
            x = s.call(Dropout(self.dropout), x, training)
        return x


@dataclasses.dataclass(frozen=True)
class GroupedLinear(Module):
    """Feature-grouped projection: input channels split into ``groups``
    equal blocks, each with its own weight — equivalent to the
    reference's ``nn.Conv1d(kernel_size=1, groups=order)``
    (``sgp_model.py:45-48``), lowered to one batched matmul."""
    output_size: int
    groups: int

    def __call__(self, s: Scope, x):
        g = self.groups
        c_in, c_out = x.shape[-1], self.output_size
        if c_in % g or c_out % g:
            raise ValueError(f"channels in {c_in} / out {c_out} not "
                             f"divisible by {g} groups")
        w = s.param("kernel", _lecun_normal, (g, c_in // g, c_out // g))
        b = s.param("bias", _zeros, (c_out,))
        xg = x.reshape(x.shape[:-1] + (g, c_in // g))
        out = jnp.einsum("...gi,gio->...go", xg, w)
        return out.reshape(x.shape[:-1] + (c_out,)) + b


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Stacked Dense layers + optional readout
    (``blocks/encoders/mlp.py:7-51``)."""
    hidden_size: int
    output_size: Optional[int] = None
    n_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0

    def __call__(self, s: Scope, x, u=None, training: bool = False):
        x = maybe_cat_exog(x, u)
        for _ in range(self.n_layers):
            x = s.call(Dense(self.hidden_size, self.activation,
                             self.dropout), x, training)
        if self.output_size is not None:
            x = s.call(Linear(self.output_size), x)
        return x


@dataclasses.dataclass(frozen=True)
class ResidualMLP(Module):
    """MLP with (optionally parametrized) skip connections
    (``blocks/encoders/mlp.py:54-113``)."""
    hidden_size: int
    output_size: Optional[int] = None
    n_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0
    parametrized_skip: bool = False

    def __call__(self, s: Scope, x, u=None, training: bool = False):
        x = maybe_cat_exog(x, u)
        for i in range(self.n_layers):
            h = s.call(Dense(self.hidden_size, self.activation,
                             self.dropout), x, training)
            h = s.call(Linear(self.hidden_size), h)
            if (i == 0 and x.shape[-1] != self.hidden_size) \
                    or self.parametrized_skip:
                skip = s.call(Linear(self.hidden_size), x)
            else:
                skip = x
            x = h + skip
        if self.output_size is not None:
            x = s.call(Linear(self.output_size), x)
        return x


@dataclasses.dataclass(frozen=True)
class LinearReadout(Module):
    """Last-step linear multi-horizon readout
    (``blocks/decoders/linear_readout.py:5-33``): ``[b (s) n f]`` ->
    ``[b h n c]``."""
    output_size: int
    horizon: int = 1

    def __call__(self, s: Scope, h):
        if h.ndim == 4:
            h = h[:, -1]
        out = s.call(Linear(self.output_size * self.horizon), h)
        # [b n (h c)] -> [b h n c]
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).transpose(0, 2, 1, 3)


@dataclasses.dataclass(frozen=True)
class StaticGraphEmbedding(Module):
    """Learned per-node embedding table with optional ``token_index``
    gather (``tsl/nn/base/embedding.py:10-101``). Init matches the
    reference's PyG ``inits.uniform``: U(-1/sqrt(emb), +1/sqrt(emb))."""
    n_tokens: int
    emb_size: int

    def __call__(self, s: Scope, token_index=None):
        bound = 1.0 / (self.emb_size ** 0.5)

        def init(key, shape, dtype):
            return jax.random.uniform(key, shape, dtype, -bound, bound)

        emb = s.param("emb", init, (self.n_tokens, self.emb_size))
        if token_index is not None:
            return emb[token_index]
        return emb
