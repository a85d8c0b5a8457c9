"""GraphWaveNet baseline (flax).

Re-design of ``tsl/nn/models/stgn/graph_wavenet_model.py:16-177`` with
the ``node_index``-aware learned adjacency of the lib wrapper
(``lib/nn/models/gwnet_model.py:9-54``): gated TCN x diffusion-conv
residual stack, skip accumulation into a nonlinear MLP horizon readout,
plus a dense learned adjacency from source/target node embeddings
(relu(E_s E_t^T) row-softmax) applied via order-K dense diffusion
(``dense_spatial_conv.py:9-125``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import flax.linen as nn
import jax.numpy as jnp

from sgp.models.flax_blocks import MLPDecoder, StaticGraphEmbedding
from sgp.models.graph_layers import DiffConv
from sgp.models.tcn import Norm, TemporalConvNet
from sgp.ops.spmm import Operator


class DenseSpatialConvOrderK(nn.Module):
    """Dense order-K diffusion with a batch-shared dense adjacency
    (``dense_spatial_conv.py``); ``include_self=False``. ``adj`` may be
    a single ``[n, n]`` row-stochastic support or a stacked ``[s, n, n]``
    list of supports (``compute_support``'s forward+backward pair)."""
    output_size: int
    order: int = 2

    @staticmethod
    def compute_support(adj):
        """Row-normalized forward + backward supports from a raw dense
        adjacency (``dense_spatial_conv.py:34-41``)."""
        eps = 1e-8
        fwd = adj / (adj.sum(1, keepdims=True) + eps)
        bwd = adj.T / (adj.T.sum(1, keepdims=True) + eps)
        return jnp.stack([fwd, bwd])

    @nn.compact
    def __call__(self, x, adj):
        # x: [b s n c]
        supports = adj[None] if adj.ndim == 2 else adj
        out = []
        for i in range(supports.shape[0]):
            cur = x
            for _ in range(self.order):
                cur = jnp.einsum("ij,bsjc->bsic", supports[i], cur)
                out.append(cur)
        return nn.Dense(self.output_size)(jnp.concatenate(out, -1))


class _GWNetBlock(nn.Module):
    """``len(dilations)`` consecutive GWNet layers on a CONSTANT-length
    time buffer: every temporal conv is causally left-padded so shapes
    never shrink, and a per-layer validity mask (right-aligned, shrinking
    by ``d*(k-1)`` per layer exactly like the reference's VALID convs)
    restricts the batch-norm statistics — making the activations on the
    valid tail equal the shrinking-buffer implementation
    (``graph_wavenet_model.py:125-162``) while the constant shapes admit
    ``nn.scan`` over layer blocks (compile-time ~1 block, not n_layers).
    """
    hidden_size: int
    ff_size: int
    temporal_kernel_size: int
    spatial_kernel_size: int
    dilations: Sequence[int]
    learned_adjacency: bool
    norm: str
    dropout: float
    training: bool

    @nn.compact
    def __call__(self, carry, masks, supports, adj_z):
        x, out = carry
        for j, d in enumerate(self.dilations):
            res = x
            x = TemporalConvNet(self.hidden_size,
                                self.temporal_kernel_size, dilation=d,
                                gated=True, causal_padding=True)(x)
            out = nn.Dense(self.ff_size)(x) + out
            xs = DiffConv(self.hidden_size,
                          self.spatial_kernel_size)(x, supports)
            if self.learned_adjacency:
                x = xs + DenseSpatialConvOrderK(
                    self.hidden_size, self.spatial_kernel_size)(x, adj_z)
            else:
                x = xs
            if self.dropout > 0:
                x = nn.Dropout(self.dropout,
                               deterministic=not self.training)(x)
            x = x + res
            x = Norm(self.norm)(x, time_mask=masks[j])
        return (x, out), None


class GraphWaveNetModel(nn.Module):
    hidden_size: int
    ff_size: int
    output_size: int
    horizon: int
    n_layers: int = 8
    exog_size: int = 0
    temporal_kernel_size: int = 2
    spatial_kernel_size: int = 2
    learned_adjacency: bool = True
    n_nodes: Optional[int] = None
    emb_size: int = 10
    dilation: int = 2
    dilation_mod: int = 2
    norm: str = "batch"
    dropout: float = 0.0
    scan_layers: bool = True
    # rematerialize each scanned block's forward during the backward
    # pass. Saves the blocks' activation memory at ~1 extra forward of
    # FLOPs (~+33% on this fwd:bwd≈1:2 model). The PV-US-scale step fits
    # HBM comfortably without it (~2.3 GB), so throughput runs should
    # turn it off; kept on by default for reference-parity memory
    # behavior on small accelerators.
    remat_scan: bool = True

    @nn.compact
    def __call__(self, x, supports: Sequence[Operator], u=None,
                 node_index=None, training: bool = False):
        # x: [b s n c]
        if u is not None:
            if u.ndim == 3:
                u = jnp.broadcast_to(u[:, :, None, :],
                                     x.shape[:3] + (u.shape[-1],))
            x = jnp.concatenate([x, u], -1)

        receptive_field = 1
        dilations = []
        for i in range(self.n_layers):
            d = self.dilation ** (i % self.dilation_mod)
            dilations.append(d)
            receptive_field += d * (self.temporal_kernel_size - 1)
        if receptive_field > x.shape[1]:
            x = jnp.pad(x, ((0, 0), (receptive_field - x.shape[1], 0),
                            (0, 0), (0, 0)))
        buf_len = x.shape[1]
        # right-aligned validity after each layer's (virtual) shrink
        import numpy as np
        valid, masks = buf_len, []
        for d in dilations:
            valid -= d * (self.temporal_kernel_size - 1)
            masks.append(np.arange(buf_len) >= buf_len - valid)
        masks = jnp.asarray(np.stack(masks))          # [n_layers, L]

        if self.learned_adjacency:
            # node_index-aware slice (``lib/nn/models/gwnet_model.py``)
            src = StaticGraphEmbedding(self.n_nodes, self.emb_size)(
                token_index=node_index)
            dst = StaticGraphEmbedding(self.n_nodes, self.emb_size)(
                token_index=node_index)
            adj_z = nn.softmax(nn.relu(src @ dst.T), axis=1)
        else:
            adj_z = None

        x = nn.Dense(self.hidden_size)(x)
        out = jnp.zeros(x.shape[:3] + (self.ff_size,), x.dtype)
        block_kw = dict(hidden_size=self.hidden_size,
                        ff_size=self.ff_size,
                        temporal_kernel_size=self.temporal_kernel_size,
                        spatial_kernel_size=self.spatial_kernel_size,
                        learned_adjacency=self.learned_adjacency,
                        norm=self.norm, dropout=self.dropout,
                        training=training)
        # dilations cycle with period dilation_mod -> partition into
        # identical blocks. If the period does not divide n_layers the
        # blocks are NOT identical (dilation is a static conv config),
        # so scanning is impossible: run a per-layer loop with each
        # layer's true dilation instead.
        if self.n_layers % self.dilation_mod != 0:
            for i in range(self.n_layers):
                (x, out), _ = _GWNetBlock(dilations=(dilations[i],),
                                          **block_kw)(
                    (x, out), masks[i:i + 1], tuple(supports), adj_z)
        else:
            bs = self.dilation_mod
            n_blocks = self.n_layers // bs
            block_dils = tuple(dilations[:bs])
            block_masks = masks.reshape(n_blocks, bs, -1)
            if self.scan_layers and n_blocks > 1:
                # remat_scan=False keeps the SAME wrapper (identical
                # param paths -> checkpoint-compatible both ways) but
                # saves every intermediate, so nothing is recomputed
                import jax
                policy = (None if self.remat_scan else
                          jax.checkpoint_policies.everything_saveable)
                scanned = nn.scan(
                    nn.remat(_GWNetBlock, policy=policy),
                    length=n_blocks,
                    variable_axes={"params": 0},
                    split_rngs={"params": True, "dropout": True},
                    in_axes=(0, nn.broadcast, nn.broadcast))(
                        dilations=block_dils, **block_kw)
                (x, out), _ = scanned((x, out), block_masks,
                                      tuple(supports), adj_z)
            else:
                for i in range(n_blocks):
                    (x, out), _ = _GWNetBlock(dilations=block_dils,
                                              **block_kw)(
                        (x, out), block_masks[i], tuple(supports), adj_z)

        out = nn.relu(out)
        return MLPDecoder(2 * self.ff_size, self.output_size,
                          horizon=self.horizon, activation="relu"
                          )(out, training=training)
