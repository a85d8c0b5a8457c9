"""Fully-fused IID decoder training.

The redesign of the reference's scalability layer
(``lib/datasets/iid_dataset.py`` + ``lib/dataloader/iid_dataloader.py``):
instead of DataLoader worker processes gathering (time, node) samples on
the host and shipping them to the device, the *entire* step — uniform
(t, n) sampling, feature/target gather from device-resident arrays,
forward, loss, backward, Adam — is one jitted XLA program. The host only
feeds an RNG key, so nothing crosses the host link per step.

Multi-chip: shard the batch over the ``data`` mesh axis (each chip draws
its own slice of the sample batch from its replicated/sharded arrays) —
``Predictor``-compatible params/optimizer are reused unchanged.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sgp.data.scalers import ScalerParams
from sgp.data.spatiotemporal import SpatioTemporalDataset
from sgp.train.metrics import _METRIC_FNS, _masked_reduce


def take_time_rows(arr: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """``arr[t]`` for a 1-D index vector over axis 0, as a vmapped
    ``dynamic_slice``: one contiguous slice per index, where the
    generic fancy-index gather of a big time-major array may not lower
    to slice-sized copies."""
    rows = jax.vmap(
        lambda ti: jax.lax.dynamic_slice_in_dim(arr, ti, 1, axis=0))(t)
    return rows[:, 0]


def _f32_to_bf16_pair(y: jnp.ndarray):
    """Bit-exact split of f32 into two bf16 lanes (high/low 16 bits)."""
    v = jax.lax.bitcast_convert_type(y.astype(jnp.float32), jnp.uint32)
    hi = (v >> 16).astype(jnp.uint16)
    lo = (v & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    cast = lambda u: jax.lax.bitcast_convert_type(u, jnp.bfloat16)
    return cast(hi), cast(lo)


def _bf16_pair_to_f32(hi: jnp.ndarray, lo: jnp.ndarray):
    u16 = lambda b: jax.lax.bitcast_convert_type(b, jnp.uint16)
    v = (u16(hi).astype(jnp.uint32) << 16) | u16(lo).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(v, jnp.float32)


def pack_iid_data(encoded: jnp.ndarray,    # [T, N, D] (any float dtype)
                  target: jnp.ndarray,     # [T, N, C] f32
                  mask: jnp.ndarray,       # [T, N, C] bool
                  horizon_offsets) -> jnp.ndarray:
    """Pack features + horizon-shifted targets + masks into ONE wide
    bf16 row per (t, n) so the fused IID step does a single row gather.

    One wide row per sample replaces the per-sample scalar gathers
    ``target[t+h, n]`` (narrow rows gather far less efficiently than
    wide ones). Layout per row: ``[enc(D) | y_hi(H*C) | y_lo(H*C) | mask(H*C)]``
    with f32 targets split bit-exactly into two bf16 lanes
    (``uint32 >> 16`` / ``& 0xffff``) — the step reconstructs the exact
    f32 bits. Rows whose horizon would wrap past T hold rolled garbage;
    ``valid_starts`` never samples them (same contract as unpacked).

    Returns ``packed [T, N, D + 3*H*C]`` in bf16.
    """
    h_np = np.asarray(horizon_offsets).astype(np.int64)
    t_steps, n_nodes, c = target.shape
    ys = jnp.stack([jnp.roll(target, -int(h), axis=0) for h in h_np],
                   axis=2)                       # [T, N, H, C]
    ms = jnp.stack([jnp.roll(mask, -int(h), axis=0) for h in h_np],
                   axis=2)
    hi, lo = _f32_to_bf16_pair(ys)
    parts = [jnp.asarray(encoded, jnp.bfloat16),
             hi.reshape(t_steps, n_nodes, -1),
             lo.reshape(t_steps, n_nodes, -1),
             ms.reshape(t_steps, n_nodes, -1).astype(jnp.bfloat16)]
    return jnp.concatenate(parts, axis=-1)


def unpack_iid_rows(rows: jnp.ndarray, feat: int, n_horizon: int,
                    n_channels: int):
    """Split gathered packed rows ``[B, D+3HC]`` back into
    ``x [B, D] bf16``, ``y [B, H, C] f32`` (bit-exact), ``m [B, H, C]``."""
    b = rows.shape[0]
    hc = n_horizon * n_channels
    x = rows[:, :feat]
    hi = rows[:, feat:feat + hc]
    lo = rows[:, feat + hc:feat + 2 * hc]
    m = rows[:, feat + 2 * hc:feat + 3 * hc]
    y = _bf16_pair_to_f32(hi, lo).reshape(b, n_horizon, n_channels)
    return x, y, (m > 0.5).reshape(b, n_horizon, n_channels)


def _packed_dtype_ok(encoded) -> bool:
    """The packed row stores features as bf16 lanes, so ONLY bf16
    encodings may be packed — any other float dtype (f32, f16) would be
    silently truncated/rounded to bf16, diverging from the unpacked
    path the caller asked for by choosing that dtype. Shared by the
    single-chip and node-sharded steps so the policy cannot drift."""
    if encoded is None or encoded.dtype == jnp.bfloat16:
        return True
    import logging
    logging.getLogger("sgp").info(
        "packed=True ignored: encoding is %s (packing would change its "
        "precision to bf16); using the unpacked gather path",
        encoded.dtype)
    return False


def _cast_floats(tree, dtype):
    """Cast every f32 leaf (mixed-precision compute: f32 master params,
    bf16 forward/backward — the gradient of the cast accumulates f32)."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a,
        tree)


def bind_data(jitted: Callable, data) -> Callable:
    """``step(params, opt_state, rng)`` running ``jitted(params,
    opt_state, rng, data)``: the big arrays stay explicit jit arguments
    (see :func:`make_fused_iid_step`). ``step.compile(params, opt_state,
    rng)`` compiles ahead of time and returns the same call on the
    executable, kept as its ``.compiled`` (``memory_analysis()``)."""
    def step(params, opt_state, rng):
        return jitted(params, opt_state, rng, data)

    def compile(params, opt_state, rng):
        exe = jitted.lower(params, opt_state, rng, data).compile()

        def run(params, opt_state, rng):
            return exe(params, opt_state, rng, data)

        run.compiled = exe
        return run

    step.compile = compile
    step.data = data
    return step


def _build_iid_sample_and_loss(model, encoded, target, mask,
                               valid_starts, horizon_offsets, scaler,
                               u=None, batch_size: int = 4096,
                               loss: str = "mae",
                               scale_target: bool = False,
                               packed: bool = False,
                               compute_dtype=None,
                               gather_block: int = 1,
                               node_perm=None):
    """Shared core of the fused IID steps: returns ``(data,
    sample_and_loss)`` where ``sample_and_loss(params, rng, data)`` is
    the pure sampling+gather+forward+masked-loss function and ``data``
    the big-array pytree to thread through the jit boundary. Used by
    the single-trial step and the vmapped multi-trial step so their
    sampling/gather semantics cannot drift.

    The two phases are also exposed separately
    (``sample_and_loss.sample(rng, data)`` →
    ``sample_and_loss.loss(params, sampled, rng)``) for callers that
    want to prefetch or share a gather across trials (multi_trial).

    ``compute_dtype=jnp.bfloat16`` runs the decoder fwd/bwd in bf16
    (f32 master params; loss/metrics stay f32): half the activation
    traffic, and bf16 tensor-core matmuls.

    ``gather_block=G > 1`` (packed path only) samples ``batch/G``
    (time, node-block) pairs and gathers G CONSECUTIVE packed rows per
    draw — G-fold fewer random row fetches. The estimator changes from
    per-pair IID to cluster sampling over a FIXED partition of nodes
    into G-blocks (times stay IID): unbiased for the loss, slightly
    correlated within a batch. Node order is an arbitrary graph
    labeling, so pre-permuting nodes once makes the blocks random
    subsets. Requires ``G | batch_size`` and ``G | n_nodes``.

    ``node_perm`` (``[N] int``, with blocked gather) declares that the
    packed array's node axis is ordered by a permutation:
    ``packed[:, pos] == original[:, node_perm[pos]]``. Sampled
    positions are mapped back through it so ``node_index`` (embedding/
    scaler rows) refers to ORIGINAL node ids — pack a shuffled layout
    once (``pack_iid_data(encoded[:, perm], target[:, perm],
    mask[:, perm], ...)``) and the G-blocks become random node subsets
    instead of label-adjacent ones.
    """
    loss_pt = _METRIC_FNS[loss]
    n_h = int(np.asarray(horizon_offsets).shape[0])
    n_c = target.shape[-1]
    has_u = u is not None
    if not isinstance(packed, bool):
        big = jnp.asarray(packed)          # prebuilt packed layout
        packed = True
    elif packed and not _packed_dtype_ok(encoded):
        packed, big = False, None
    elif packed:
        big = pack_iid_data(encoded, target, mask, horizon_offsets)
    else:
        big = None
    n_nodes = (encoded if encoded is not None else big).shape[1]
    feat = encoded.shape[-1] if encoded is not None \
        else big.shape[-1] - 3 * n_h * n_c
    if gather_block > 1:
        if not packed:
            raise ValueError("gather_block > 1 requires the packed "
                             "layout (packed=True or a prebuilt array)")
        if batch_size % gather_block or n_nodes % gather_block:
            raise ValueError(
                f"gather_block={gather_block} must divide both "
                f"batch_size={batch_size} and n_nodes={n_nodes}")
    elif node_perm is not None:
        raise ValueError("node_perm only applies to the blocked gather "
                         "(gather_block > 1); the per-pair IID path "
                         "samples nodes uniformly already")
    # packed rows already carry the horizon-shifted targets/masks, so
    # the packed tuple needs no horizon_offsets array
    data = ((big, jnp.asarray(valid_starts)) if packed else
            (encoded, target, mask, jnp.asarray(valid_starts),
             jnp.asarray(horizon_offsets))) \
        + ((u,) if has_u else ())

    def sample(rng, data):
        """Phase 1: draw (t, n) pairs and gather their rows. Returns
        the sampled pytree consumed by :func:`loss_on_sampled`."""
        if packed:
            pk, valid = data[:2]
        else:
            enc, tgt, msk, valid, h_off = data[:5]
        rng_t, rng_n = jax.random.split(rng, 3)[:2]
        if gather_block > 1:
            g = gather_block
            nb_count = n_nodes // g
            draws = batch_size // g
            t = jax.random.choice(rng_t, valid, (draws,))
            nb = jax.random.randint(rng_n, (draws,), 0, nb_count)
            width = pk.shape[-1]
            blocks = pk.reshape(-1, g, width)      # [T*N/g, g, W]
            rows = blocks[t * nb_count + nb].reshape(batch_size, width)
            n = (nb[:, None] * g
                 + jnp.arange(g, dtype=nb.dtype)[None, :]).reshape(-1)
            if node_perm is not None:
                # sampled POSITIONS in the shuffled layout -> original
                # node ids for the embedding / per-node scaler
                n = jnp.take(jnp.asarray(node_perm), n)
            t = jnp.repeat(t, g)
            x, y, m = unpack_iid_rows(rows, feat, n_h, n_c)
        else:
            t = jax.random.choice(rng_t, valid, (batch_size,))
            n = jax.random.randint(rng_n, (batch_size,), 0, n_nodes)
        if packed and gather_block == 1:
            # 2-component gather, NOT flat-reshape + 1D gather: the
            # [T, N, W] -> [T*N, W] reshape is a free bitcast only when
            # the backend's layout allows it; otherwise XLA materializes
            # a relayout COPY of the multi-GB packed array inside the
            # train program. Same one-gather-per-sample row fetch
            # either way.
            rows = pk[t, n]
            x, y, m = unpack_iid_rows(rows, feat, n_h, n_c)
        elif not packed:
            x = enc[t, n]                       # [B, D]
            y = tgt[t[:, None] + h_off[None, :], n[:, None]]
            m = msk[t[:, None] + h_off[None, :], n[:, None]]
        u_rows = None
        if has_u:
            u_arr = data[-1]
            if u_arr.ndim == 3:   # node-level [T, N, F] (e.g. keep_raw)
                u_rows = u_arr[t, n]            # [B, F] per-sample node
            else:                 # global [T, F]
                u_rows = u_arr[t]
        return (x, y, m, n, u_rows)

    def loss_on_sampled(params, sampled, rng):
        """Phase 2: forward + masked loss on pre-gathered rows. ``rng``
        is the SAME per-step key as in phase 1 (the dropout stream is
        its third split, exactly as in the fused form)."""
        x, y, m, n, u_rows = sampled
        rng_d = jax.random.split(rng, 3)[2]
        kwargs = {} if u_rows is None else {"u": u_rows}
        if compute_dtype is not None:
            params = _cast_floats(params, compute_dtype)
            x = x.astype(compute_dtype)
            if u_rows is not None:
                kwargs["u"] = u_rows.astype(compute_dtype)
        sc = scaler.index_nodes_iid(n)
        y_hat = model.apply(params, x, node_index=n, training=True,
                            iid=True, rngs={"dropout": rng_d}, **kwargs)
        y_hat = y_hat.astype(jnp.float32)
        if scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat = sc.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        return v / jnp.maximum(cnt, 1.0)

    def sample_and_loss(params, rng, data):
        return loss_on_sampled(params, sample(rng, data), rng)

    sample_and_loss.sample = sample
    sample_and_loss.loss = loss_on_sampled
    return data, sample_and_loss


def make_fused_iid_step(model, optimizer,
                        encoded: jnp.ndarray,      # [T, N, D] in HBM
                        target: jnp.ndarray,       # [T, N, C]
                        mask: jnp.ndarray,         # [T, N, C] bool
                        valid_starts: jnp.ndarray,  # [S] window starts
                        horizon_offsets: jnp.ndarray,  # [H]
                        scaler: ScalerParams,
                        u: Optional[jnp.ndarray] = None,  # [T, F] global
                        batch_size: int = 4096,
                        loss: str = "mae",
                        scale_target: bool = False,
                        packed: bool = False,
                        compute_dtype=None,
                        gather_block: int = 1,
                        node_perm=None) -> Callable:
    """Build ``step(params, opt_state, rng) -> (params, opt_state, loss)``
    with everything fused into one jitted program.

    The big arrays (encoded/target/mask/u) are threaded through the jit
    boundary as explicit *arguments*, never closure captures — a
    closed-over device array becomes a jaxpr constant that XLA tries to
    fold, which stalls compilation for multi-GB encodings.

    ``packed=True`` stores features+targets+masks in one wide bf16 row
    per (t, n) (:func:`pack_iid_data`) so the whole sample batch is ONE
    row gather instead of separate per-(t+h, n) scalar gathers of
    target/mask. Targets are bit-exactly
    reconstructed from two bf16 lanes; features reach the model in bf16
    (as with bf16 device-resident encodings). Passing an ARRAY as
    ``packed`` uses it as the prebuilt packed layout (``encoded`` may
    then be None — useful when the packing is fused into the encode
    program so the unpacked encoding never occupies device memory).
    """
    data, sample_and_loss = _build_iid_sample_and_loss(
        model, encoded, target, mask, valid_starts, horizon_offsets,
        scaler, u=u, batch_size=batch_size, loss=loss,
        scale_target=scale_target, packed=packed,
        compute_dtype=compute_dtype, gather_block=gather_block,
        node_perm=node_perm)

    @jax.jit
    def _step(params, opt_state, rng, data):
        loss_val, grads = jax.value_and_grad(sample_and_loss)(
            params, rng, data)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss_val

    step = bind_data(_step, data)
    step.core = _step     # (params, opt_state, rng, data) — data as args
    step.sample_and_loss = sample_and_loss
    return step


def make_fused_iid_multi_step(model, optimizer, encoded, target, mask,
                              valid_starts, horizon_offsets, scaler,
                              u=None, batch_size: int = 4096,
                              loss: str = "mae",
                              scale_target: bool = False,
                              steps_per_call: int = 32,
                              packed: bool = False,
                              compute_dtype=None,
                              pipeline: bool = False,
                              gather_block: int = 1,
                              node_perm=None) -> Callable:
    """Like :func:`make_fused_iid_step` but runs ``steps_per_call``
    optimizer steps inside ONE jitted program (``lax.scan`` over steps) —
    amortizing host->device dispatch latency. Returns
    ``multi_step(params, opt_state, rng) -> (params, opt_state,
    mean_loss)``. The big arrays remain explicit jit arguments.

    ``pipeline=True`` software-pipelines the scan: step ``i``'s row
    gather is issued during step ``i-1``'s forward/backward (the
    sampled rows ride the scan carry). BIT-IDENTICAL loss/param
    trajectory to the unpipelined form — each step still samples with
    its own key and drops out with that key's third split — verified
    by ``tests/test_iid_fused.py``. Default False: whether the
    independent gather overlaps the fwd/bwd depends on the backend's
    scheduler (not measured on the GPU)."""
    single = make_fused_iid_step(model, optimizer, encoded, target, mask,
                                 valid_starts, horizon_offsets, scaler,
                                 u=u, batch_size=batch_size, loss=loss,
                                 scale_target=scale_target, packed=packed,
                                 compute_dtype=compute_dtype,
                                 gather_block=gather_block,
                                 node_perm=node_perm)
    core, data = single.core, single.data
    snl = single.sample_and_loss

    @jax.jit
    def _multi(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            p, s, l = core(p, s, key, data)
            return (p, s), l
        keys = jax.random.split(rng, steps_per_call)
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    @jax.jit
    def _multi_pipelined(params, opt_state, rng, data):
        keys = jax.random.split(rng, steps_per_call)
        first = snl.sample(keys[0], data)

        def body(carry, key_pair):
            p, s, sampled = carry
            key_cur, key_next = key_pair
            loss_val, grads = jax.value_and_grad(snl.loss)(
                p, sampled, key_cur)
            # next step's gather: independent of the param update —
            # XLA overlaps it with the fwd/bwd above
            nxt = snl.sample(key_next, data)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s, nxt), loss_val

        # key i trains on rows sampled with key i; the carried prefetch
        # for the last step is computed with a throwaway key
        key_pairs = (keys, jnp.roll(keys, -1, axis=0))
        (params, opt_state, _), losses = jax.lax.scan(
            body, (params, opt_state, first), key_pairs)
        return params, opt_state, losses.mean()

    return bind_data(_multi_pipelined if pipeline else _multi, data)


def make_fused_iid_stratified_step(model, optimizer,
                                   h_temporal: jnp.ndarray,  # [T, N, Ht]
                                   target: jnp.ndarray,
                                   mask: jnp.ndarray,
                                   valid_starts: jnp.ndarray,
                                   horizon_offsets: jnp.ndarray,
                                   scaler: ScalerParams,
                                   support_ops,     # spatial operators
                                   global_attr: bool = True,
                                   u: Optional[jnp.ndarray] = None,
                                   times_per_batch: int = 32,
                                   nodes_per_time: int = 128,
                                   loss: str = "mae",
                                   scale_target: bool = False,
                                   steps_per_call: int = 1,
                                   assembly: str = "gather_rows",
                                   support_dtype=None) -> Callable:
    """Stratified IID training with ON-THE-FLY spatial propagation.

    For encodings too large for HBM (full-year PV-US: the (k+1)x
    expansion is ~45 GB) only the *temporal* (reservoir) embedding
    ``h_temporal`` stays resident (k+1 times smaller); each step draws
    ``times_per_batch`` window starts and ``nodes_per_time`` nodes per
    time — a batch of ``times_per_batch * nodes_per_time`` (time, node)
    pairs. Uniform over pairs (times uniform with replacement, nodes
    uniform per time); samples within a step share times —
    statistically benign for SGD and the only structure that avoids
    materializing the full expansion (documented divergence from
    per-pair IID).

    Propagation is a **gather-SpMM**: only the sampled nodes' rows of
    each support operator are contracted against the selected steps'
    states (the device analog of the reference's row-sliced minibatch
    propagation, ``lib/datasets/iid_dataset.py:111-114``) —
    ``O(Tb·P·N·F)`` instead of ``O(Tb·N²·F)``, a ~``N/P`` (≈40x at
    PV-US scale) FLOP cut with bit-equal sampling semantics.

    ``assembly`` selects how the sampled rows are produced:

    - ``"gather_rows"``: gather the sampled destination rows of each
      dense support, then a batched ``[Tb, P, N] x [Tb, N, F]`` einsum —
      the FLOP-minimal form, but a strided row gather + batched GEMM.
    - ``"full_prop"``: propagate ALL nodes of the ``Tb`` selected steps
      with one square matmul per support (``O(Tb·N²·F)`` FLOPs but a
      single large GEMM), then gather the sampled rows. More FLOPs,
      far fewer bytes moved.

    ``support_dtype`` (e.g. ``jnp.bfloat16``) re-casts dense support
    matrices for bf16 matmuls (precision drops to ``'default'``).
    """
    from sgp.ops.spmm import DenseOperator
    loss_pt = _METRIC_FNS[loss]
    n_nodes = h_temporal.shape[1]
    batch_size = times_per_batch * nodes_per_time
    has_u = u is not None
    if support_dtype is not None:
        support_ops = [
            DenseOperator(op.mat.astype(support_dtype), "default")
            if isinstance(op, DenseOperator) else op
            for op in support_ops]
    # support operators travel INSIDE the jit-arg pytree — closed-over
    # dense [N, N] supports would become jaxpr constants (host transfer
    # + XLA folding stall)
    data = (h_temporal, target, mask, valid_starts, horizon_offsets,
            tuple(support_ops)) + ((u,) if has_u else ())

    def sample_and_loss(params, rng, data):
        from sgp.ops.spmm import DenseOperator
        ht, tgt, msk, valid, h_off, ops = data[:6]
        rng_t, rng_n, rng_d = jax.random.split(rng, 3)
        t = jax.random.choice(rng_t, valid, (times_per_batch,))
        h_sel = take_time_rows(ht, t)          # [Tb, N, Ht]
        n = jax.random.randint(rng_n, (times_per_batch, nodes_per_time),
                               0, n_nodes)
        h_smp = jnp.take_along_axis(h_sel, n[:, :, None], axis=1)
        parts = [h_smp]                        # [Tb, P, Ht]
        for op in ops:
            if isinstance(op, DenseOperator) and assembly == "gather_rows":
                # gather-SpMM: only the sampled destination rows
                rows = op.mat[n]               # [Tb, P, N]
                hop = jnp.einsum("tpn,tnf->tpf", rows, h_sel,
                                 precision=op.precision,
                                 preferred_element_type=jnp.float32
                                 ).astype(h_sel.dtype)
            else:          # full_prop (one square GEMM) + row gather
                hop = jnp.take_along_axis(op @ h_sel, n[:, :, None],
                                          axis=1)
            parts.append(hop)
        if global_attr:
            parts.append(jnp.broadcast_to(
                h_sel.mean(-2, keepdims=True), h_smp.shape))
        x = jnp.concatenate(parts, -1).reshape(batch_size, -1)  # [B, D]
        t_flat = jnp.repeat(t, nodes_per_time)
        n_flat = n.reshape(-1)
        n_h = len(horizon_offsets)

        def gather_tn(arr):
            # arr[t+h, n] for all (sampled t, horizon h, sampled n) as
            # time-slice rows + a within-row node gather (see
            # take_time_rows). -> [B, H, C]
            steps = (t[:, None] + h_off[None, :]).reshape(-1)  # [Tb*H]
            rows = take_time_rows(arr, steps).reshape(
                (times_per_batch, n_h) + arr.shape[1:])  # [Tb, H, N, C]
            sel = jnp.take_along_axis(
                rows, n[:, None, :, None], axis=2)       # [Tb, H, P, C]
            return sel.transpose(0, 2, 1, 3).reshape(
                batch_size, n_h, arr.shape[-1])

        y = gather_tn(tgt)
        m = gather_tn(msk)
        kwargs = {}
        if has_u:
            u_arr = data[6]
            if u_arr.ndim == 3:                # node-level [T, N, F]
                rows = take_time_rows(u_arr, t)          # [Tb, N, F]
                kwargs["u"] = jnp.take_along_axis(
                    rows, n[:, :, None], axis=1).reshape(
                        batch_size, u_arr.shape[-1])
            else:                              # global [T, F]
                kwargs["u"] = take_time_rows(u_arr, t_flat)
        sc = scaler.index_nodes_iid(n_flat)
        y_hat = model.apply(params, x, node_index=n_flat, training=True,
                            iid=True, rngs={"dropout": rng_d}, **kwargs)
        if scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat = sc.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        return v / jnp.maximum(cnt, 1.0)

    @jax.jit
    def _multi(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            loss_val, grads = jax.value_and_grad(sample_and_loss)(
                p, key, data)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s), loss_val
        keys = jax.random.split(rng, max(steps_per_call, 1))
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    return bind_data(_multi, data)


def fused_iid_inputs(dataset: SpatioTemporalDataset, dtype=jnp.float32):
    """Lift the dataset tensors needed by the fused step into HBM.
    Device-resident inputs keep their stored dtype (e.g. bf16 encodings
    are NOT upcast — that would double their HBM footprint)."""
    import jax
    x_arr = dataset.input_array()
    encoded = x_arr if isinstance(x_arr, jax.Array) \
        else jnp.asarray(x_arr, dtype)
    if encoded.ndim == 4:  # [T, N, C] expected; guard
        raise ValueError("input_array must be [T, N, C]")
    target = jnp.asarray(dataset.target, dtype)
    mask = jnp.asarray(dataset.mask)
    u = dataset.exog_array()
    u = None if u is None else jnp.asarray(u, dtype)
    valid = jnp.asarray(dataset.indices())
    h_off = jnp.asarray(dataset.windowing.horizon_offsets())
    return encoded, target, mask, valid, h_off, u
