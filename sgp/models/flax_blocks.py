"""flax.linen blocks shared by the baseline models.

Counterparts of the reference block zoo (``tsl/nn/base/dense.py``,
``blocks/encoders/mlp.py``, ``blocks/decoders/linear_readout.py`` /
``mlp_decoder.py``, ``base/embedding.py``). The SGP decoder uses the
plain-JAX versions in :mod:`sgp.models.blocks`; these stay until the
baselines leave flax.
"""
from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax.numpy as jnp

from sgp.models.blocks import get_activation, maybe_cat_exog


class Dense(nn.Module):
    """Linear -> activation -> dropout (``tsl/nn/base/dense.py:6-25``)."""
    output_size: int
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, training: bool = False):
        x = get_activation(self.activation)(nn.Dense(self.output_size)(x))
        if self.dropout > 0:
            x = nn.Dropout(self.dropout, deterministic=not training)(x)
        return x


class MLP(nn.Module):
    """Stacked Dense layers + optional readout
    (``blocks/encoders/mlp.py:7-51``)."""
    hidden_size: int
    output_size: Optional[int] = None
    n_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, u=None, training: bool = False):
        x = maybe_cat_exog(x, u)
        for _ in range(self.n_layers):
            x = Dense(self.hidden_size, self.activation,
                      self.dropout)(x, training)
        if self.output_size is not None:
            x = nn.Dense(self.output_size)(x)
        return x


class LinearReadout(nn.Module):
    """Last-step linear multi-horizon readout
    (``blocks/decoders/linear_readout.py:5-33``): ``[b (s) n f]`` ->
    ``[b h n c]``."""
    output_size: int
    horizon: int = 1

    @nn.compact
    def __call__(self, h):
        if h.ndim == 4:
            h = h[:, -1]
        out = nn.Dense(self.output_size * self.horizon)(h)
        # [b n (h c)] -> [b h n c]
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).transpose(0, 2, 1, 3)


class MLPDecoder(nn.Module):
    """Flatten the last ``receptive_field`` steps -> MLP -> horizon
    (``blocks/decoders/mlp_decoder.py:9-55``)."""
    hidden_size: int
    output_size: int
    horizon: int = 1
    receptive_field: int = 1
    n_layers: int = 1
    activation: str = "relu"
    dropout: float = 0.0

    @nn.compact
    def __call__(self, h, training: bool = False):
        # h: [b s n f] -> take last R steps and flatten channels
        if h.ndim == 4:
            h = h[:, -self.receptive_field:]
            h = h.transpose(0, 2, 1, 3).reshape(
                h.shape[0], h.shape[2], -1)  # [b n (r f)]
        out = MLP(self.hidden_size, self.output_size * self.horizon,
                  n_layers=self.n_layers, activation=self.activation,
                  dropout=self.dropout)(h, training=training)
        b, n = out.shape[0], out.shape[1]
        return out.reshape(b, n, self.horizon, self.output_size
                           ).transpose(0, 2, 1, 3)


class StaticGraphEmbedding(nn.Module):
    """Learned per-node embedding table with optional ``token_index``
    gather (``tsl/nn/base/embedding.py:10-101``). Init matches the
    reference's PyG ``inits.uniform``: U(-1/sqrt(emb), +1/sqrt(emb))."""
    n_tokens: int
    emb_size: int

    @nn.compact
    def __call__(self, token_index=None):
        bound = 1.0 / (self.emb_size ** 0.5)

        def init(key, shape, dtype=jnp.float32):
            import jax
            return jax.random.uniform(key, shape, dtype, -bound, bound)

        emb = self.param("emb", init, (self.n_tokens, self.emb_size))
        if token_index is not None:
            return emb[token_index]
        return emb
