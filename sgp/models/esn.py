"""ESN baseline: frozen reservoir + trainable linear readout
(``lib/nn/models/esn_model.py:10-46``). The reservoir params live
outside the flax variables (frozen, passed at construction)."""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn

from sgp.encode.reservoir import (ReservoirLayerParams, _ACTIVATIONS,
                                  reservoir_scan)
from sgp.models.blocks import maybe_cat_exog
from sgp.models.flax_blocks import LinearReadout


class ESNModel(nn.Module):
    reservoir_layers: Sequence[ReservoirLayerParams]
    reservoir_activation: str
    output_size: int
    horizon: int

    @nn.compact
    def __call__(self, x, u=None, training: bool = False, **kwargs):
        # x: [b s n f]
        x = maybe_cat_exog(x, u)
        b, s, n, f = x.shape
        xt = x.transpose(1, 0, 2, 3).reshape(s, b * n, f)  # [s, (b n), f]
        h = reservoir_scan(tuple(self.reservoir_layers),
                           self.reservoir_activation, xt,
                           return_last_state=True)          # [(b n), L*H]
        h = h.reshape(b, n, -1)
        return LinearReadout(self.output_size, self.horizon)(h)

    @staticmethod
    def build(input_size, hidden_size, output_size, exog_size, rec_layers,
              horizon, activation="tanh", spectral_radius=0.9,
              leaking_rate=0.9, density=0.7, seed=0):
        from sgp.encode.reservoir import Reservoir
        res = Reservoir(input_size=input_size + exog_size,
                        hidden_size=hidden_size, num_layers=rec_layers,
                        leaking_rate=leaking_rate,
                        spectral_radius=spectral_radius, density=density,
                        activation=activation, seed=seed)
        return ESNModel(reservoir_layers=tuple(res.layers),
                        reservoir_activation=activation,
                        output_size=output_size, horizon=horizon)
