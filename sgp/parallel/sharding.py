"""Sharding annotations for multi-chip SGP.

Strategy (SURVEY.md §2.7 / §5.8, new capability over the reference):

- **Node-sharded propagation** ("spatial TP"): the dense operator
  ``A [N, N]`` is row-sharded over the ``model`` axis; features stay
  replicated (or node-sharded), so each chip computes its row block of
  ``A @ x`` locally and XLA all-gathers the hop output before the next
  hop — the halo exchange of a 1-D node partition, over the device interconnect.
- **Data-parallel decoder training**: the IID sample batch is sharded
  over ``data``; parameters replicated; XLA psums gradients.
- **Tensor-parallel decoder** (optional): wide Dense kernels sharded on
  the output feature axis over ``model``.
- **Sharded ridge**: per-shard Gram/moment + psum, replicated Cholesky.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sgp.data.scalers import ScalerParams
from sgp.ops.spmm import DenseOperator
from sgp.train.iid import bind_data


def shard_operator(op: DenseOperator, mesh: Mesh,
                   axis: str = "model") -> DenseOperator:
    """Row-shard the dense propagation operator over ``axis`` — each
    chip owns the outgoing rows (destination nodes) of its node shard."""
    sharding = NamedSharding(mesh, P(axis, None))
    return DenseOperator(jax.device_put(op.mat, sharding), op.precision)


def sharded_spmm(op: DenseOperator, x: jnp.ndarray, mesh: Mesh,
                 axis: str = "model") -> jnp.ndarray:
    """One propagation hop with an explicit node-sharded output
    constraint; consecutive hops make XLA insert the all-gather
    (halo exchange) between them."""
    out = op @ x
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P(*([None] * (x.ndim - 2)), axis, None)))


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """Put every batch tensor on the mesh sharded along its leading
    (sample) dimension; scaler params replicated."""
    def put(v):
        if isinstance(v, ScalerParams):
            return jax.tree.map(
                lambda p: jax.device_put(
                    p, NamedSharding(mesh, P(*([None] * p.ndim)))), v)
        arr = jnp.asarray(v)
        spec = P(axis, *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return {k: put(v) for k, v in batch.items()}


def shard_params_tp(params: Any, mesh: Mesh, axis: str = "model",
                    min_size: int = 1024) -> Any:
    """Tensor-parallel parameter placement: shard the output-feature axis
    of large 2-D kernels over ``axis`` (must divide the dim); everything
    else replicated. XLA inserts the matching collectives."""
    axis_size = mesh.shape[axis]

    def place(p):
        if (p.ndim == 2 and p.size >= min_size
                and p.shape[-1] % axis_size == 0):
            spec = P(None, axis)
        else:
            spec = P(*([None] * p.ndim))
        return jax.device_put(p, NamedSharding(mesh, spec))

    return jax.tree.map(place, params)


def replicate(tree: Any, mesh: Mesh) -> Any:
    return jax.tree.map(
        lambda p: jax.device_put(
            jnp.asarray(p), NamedSharding(mesh, P(*([None] * jnp.ndim(p))))),
        tree)


def make_sharded_iid_step(model, optimizer, encoded, target, mask,
                          valid_starts, horizon_offsets, scaler,
                          mesh: Mesh, u=None, batch_size: int = 4096,
                          loss: str = "mae",
                          scale_target: bool = False,
                          axis: str = "data",
                          steps_per_call: int = 1,
                          packed: bool = False):
    """Data-parallel fused IID training with **node-sharded memory**.

    The big HBM-resident arrays (encoded ``[T, N, D]``, target, mask,
    node-level exogenous) are sharded along the NODE dimension over
    ``axis`` — each device holds ``1/n`` of every array, so multi-chip
    scales memory capacity, not just FLOPs. Each device draws
    ``batch_size / n`` (t, local-node) samples from ITS node shard —
    jointly uniform over all (t, node) pairs since shards are equal
    size — gathers locally, and gradients are psum-reduced, keeping
    replicated params bit-identical across devices. The host still only
    ships an RNG key per call; ``steps_per_call > 1`` scans that many
    optimizer steps per dispatch.

    Node counts that don't divide the axis are zero-padded; padded
    samples carry ``mask=False`` and drop out of the masked loss.
    """
    import optax
    from jax import shard_map

    from sgp.parallel.halo import shard_nodes
    from sgp.train.iid import (_packed_dtype_ok, pack_iid_data,
                               unpack_iid_rows)
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    n_shards = mesh.shape[axis]
    assert batch_size % n_shards == 0
    local_bs = batch_size // n_shards
    loss_pt = _METRIC_FNS[loss]
    n_h = int(jnp.asarray(horizon_offsets).shape[0])
    n_c = target.shape[-1]
    prebuilt = None
    if not isinstance(packed, bool):
        # prebuilt packed layout (e.g. streaming_encode's output — the
        # unpacked encoding never existed); shard it directly
        prebuilt = jnp.asarray(packed)
        packed = True
        n_nodes = prebuilt.shape[1]
        feat = prebuilt.shape[-1] - 3 * n_h * n_c
    else:
        packed = packed and _packed_dtype_ok(encoded)
        n_nodes = encoded.shape[1]
        feat = encoded.shape[-1]
    n_local = -(-n_nodes // n_shards)
    has_u = u is not None
    u_node = has_u and u.ndim == 3

    if prebuilt is None:
        encoded = shard_nodes(encoded, mesh, axis, node_axis=1)
        target = shard_nodes(target, mesh, axis, node_axis=1)
        mask = shard_nodes(mask, mesh, axis, node_axis=1)  # pads -> False
    # prebuilt packed rows already carry the shifted targets/masks —
    # sharding target/mask too would device_put full copies the step
    # never reads
    if u_node:
        u = shard_nodes(u, mesh, axis, node_axis=1)
    elif has_u:
        u = jax.device_put(u, NamedSharding(mesh, P()))
    node_spec = P(None, axis, None)
    repl = P()
    if packed:
        # single-chip fast path's wide-row layout (ONE row gather per
        # sample, sgp.train.iid.pack_iid_data). The pack's rolls
        # act on the replicated time axis and the lane concat on the
        # channel axis, so the packed array inherits the node sharding
        # — still 1/n per device, targets bit-exact via bf16 hi/lo.
        big = shard_nodes(prebuilt, mesh, axis, node_axis=1) \
            if prebuilt is not None \
            else pack_iid_data(encoded, target, mask, horizon_offsets)
        # packed rows already carry the horizon-shifted targets/masks
        data = (big, jnp.asarray(valid_starts)) + ((u,) if has_u else ())
        data_specs = (node_spec, repl) \
            + (((node_spec if u_node else repl),) if has_u else ())
    else:
        data = (encoded, target, mask, jnp.asarray(valid_starts),
                jnp.asarray(horizon_offsets)) + ((u,) if has_u else ())
        data_specs = (node_spec, node_spec, node_spec, repl, repl) \
            + (((node_spec if u_node else repl),) if has_u else ())

    def local_loss(params, rng, data):
        if packed:
            pk, valid = data[:2]
        else:
            enc, tgt, msk, valid, h_off = data[:5]
        # decorrelated per-device streams over disjoint node shards
        shard_id = jax.lax.axis_index(axis)
        rng = jax.random.fold_in(rng, shard_id)
        rng_t, rng_n, rng_d = jax.random.split(rng, 3)
        t = jax.random.choice(rng_t, valid, (local_bs,))
        n_loc = jax.random.randint(rng_n, (local_bs,), 0, n_local)
        n_glob = shard_id * n_local + n_loc
        if packed:
            # 2-component gather: the flat reshape is a free bitcast
            # only when the layout allows it — see train/iid.py
            rows = pk[t, n_loc]
            x, y, m = unpack_iid_rows(rows, feat, n_h, n_c)
        else:
            x = enc[t, n_loc]
            y = tgt[t[:, None] + h_off[None, :], n_loc[:, None]]
            m = msk[t[:, None] + h_off[None, :], n_loc[:, None]]
        kwargs = {}
        if has_u:
            u_arr = data[-1]
            kwargs["u"] = (u_arr[t, n_loc] if u_node else u_arr[t])
        sc = scaler.index_nodes_iid(n_glob)
        y_hat = model.apply(params, x, node_index=n_glob, training=True,
                            iid=True, rngs={"dropout": rng_d}, **kwargs)
        if scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat = sc.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        v = jax.lax.psum(v, axis)
        cnt = jax.lax.psum(cnt, axis)
        return v / jnp.maximum(cnt, 1.0)

    def local_step(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            # backward of psum is identity: per-device grads cover only
            # the local samples — psum for the full-batch gradient
            # (keeps replicated params bit-identical across devices)
            loss_val, grads = jax.value_and_grad(local_loss)(p, key, data)
            grads = jax.lax.psum(grads, axis)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s), loss_val
        keys = jax.random.split(rng, max(steps_per_call, 1))
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(repl, repl, repl, data_specs),
        out_specs=(repl, repl, repl),
        check_vma=False)
    jitted = jax.jit(sharded)

    step = bind_data(jitted, data)    # data: node-sharded arrays
    step.n_local = n_local
    step.packed = packed      # data layout marker (runners branch on it)
    return step


def make_sharded_iid_stratified_step(model, optimizer, h_temporal,
                                     target, mask, valid_starts,
                                     horizon_offsets, scaler,
                                     support_ops, mesh: Mesh,
                                     global_attr: bool = True, u=None,
                                     times_per_batch: int = 32,
                                     nodes_per_time: int = 128,
                                     loss: str = "mae",
                                     scale_target: bool = False,
                                     steps_per_call: int = 1,
                                     axis: str = "data"):
    """Multi-chip **beyond-HBM** stratified IID training — composes the
    two scalability axes: series too long for one chip's HBM (only the
    reservoir embedding resident, spatial propagation on the fly —
    ``train.iid.make_fused_iid_stratified_step``) AND node-sharded
    memory (each device holds ``1/n`` of the resident ``[T, N, Ht]``
    embedding/target/mask).

    Per step all devices draw the SAME ``times_per_batch`` window
    starts (shared RNG stream), all-gather only those ``Tb`` time rows
    (``Tb·N·Ht`` bytes over the device interconnect — tiny next to the resident array), and
    each device gather-SpMMs ``nodes_per_time / n`` nodes sampled from
    ITS shard (jointly uniform, per-device ``fold_in`` streams);
    loss numerator/denominator and gradients psum. Dense support
    operators stay replicated (``[N, N]`` ≪ the embedding).
    """
    import optax

    from jax import shard_map
    from sgp.ops.spmm import DenseOperator
    from sgp.parallel.halo import shard_nodes
    from sgp.train.iid import take_time_rows
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    n_shards = mesh.shape[axis]
    assert nodes_per_time % n_shards == 0, \
        f"nodes_per_time {nodes_per_time} % {n_shards} != 0"
    p_local = nodes_per_time // n_shards
    loss_pt = _METRIC_FNS[loss]
    n_nodes = h_temporal.shape[1]
    n_local = -(-n_nodes // n_shards)
    batch_local = times_per_batch * p_local
    has_u = u is not None
    u_node = has_u and u.ndim == 3

    h_temporal = shard_nodes(h_temporal, mesh, axis, node_axis=1)
    target = shard_nodes(target, mesh, axis, node_axis=1)
    mask = shard_nodes(mask, mesh, axis, node_axis=1)   # pads -> False
    if u_node:
        u = shard_nodes(u, mesh, axis, node_axis=1)
    elif has_u:
        u = jax.device_put(u, NamedSharding(mesh, P()))
    repl = P()
    node_spec = P(None, axis, None)
    ops = tuple(support_ops)
    data = (h_temporal, target, mask, jnp.asarray(valid_starts),
            jnp.asarray(horizon_offsets), jax.tree.map(
                lambda a: jax.device_put(a, NamedSharding(mesh, repl)),
                ops)) + ((u,) if has_u else ())
    data_specs = (node_spec, node_spec, node_spec, repl, repl, repl) \
        + (((node_spec if u_node else repl),) if has_u else ())

    def local_loss(params, rng, data):
        ht, tgt, msk, valid, h_off = data[:5]
        ops_d = data[5]
        shard_id = jax.lax.axis_index(axis)
        rng_t, rng_n, rng_d = jax.random.split(rng, 3)
        # times SHARED across devices (no fold_in): every device
        # propagates the same Tb gathered time rows
        t = jax.random.choice(rng_t, valid, (times_per_batch,))
        h_loc = take_time_rows(ht, t)            # [Tb, Nl, Ht]
        # interconnect exchange: ONLY the selected rows, Tb*N*Ht bytes
        h_sel = jax.lax.all_gather(h_loc, axis, axis=1, tiled=True)
        h_sel = h_sel[:, :n_nodes]               # drop node padding
        # nodes: per-device stream over the LOCAL shard
        rng_n = jax.random.fold_in(rng_n, shard_id)
        rng_d = jax.random.fold_in(rng_d, shard_id)
        n_loc = jax.random.randint(rng_n, (times_per_batch, p_local),
                                   0, n_local)
        n_glob = shard_id * n_local + n_loc
        h_smp = jnp.take_along_axis(h_loc, n_loc[:, :, None], axis=1)
        parts = [h_smp]                          # [Tb, Pl, Ht]
        for op in ops_d:
            if isinstance(op, DenseOperator):
                rows = op.mat[n_glob]            # [Tb, Pl, N]
                hop = jnp.einsum("tpn,tnf->tpf", rows, h_sel,
                                 precision=op.precision,
                                 preferred_element_type=jnp.float32
                                 ).astype(h_sel.dtype)
            else:
                hop = jnp.take_along_axis(op @ h_sel,
                                          n_glob[:, :, None], axis=1)
            parts.append(hop)
        if global_attr:
            parts.append(jnp.broadcast_to(
                h_sel.mean(-2, keepdims=True), h_smp.shape))
        x = jnp.concatenate(parts, -1).reshape(batch_local, -1)
        n_h = h_off.shape[0]

        def gather_tn(arr):                      # arr node-LOCAL
            steps = (t[:, None] + h_off[None, :]).reshape(-1)
            rows = take_time_rows(arr, steps).reshape(
                (times_per_batch, n_h) + arr.shape[1:])
            sel = jnp.take_along_axis(
                rows, n_loc[:, None, :, None], axis=2)
            return sel.transpose(0, 2, 1, 3).reshape(
                batch_local, n_h, arr.shape[-1])

        y = gather_tn(tgt)
        m = gather_tn(msk)
        n_flat = n_glob.reshape(-1)
        kwargs = {}
        if has_u:
            u_arr = data[-1]
            if u_node:
                rows = take_time_rows(u_arr, t)
                kwargs["u"] = jnp.take_along_axis(
                    rows, n_loc[:, :, None], axis=1).reshape(
                        batch_local, u_arr.shape[-1])
            else:
                kwargs["u"] = take_time_rows(
                    u_arr, jnp.repeat(t, p_local))
        sc = scaler.index_nodes_iid(n_flat)
        y_hat = model.apply(params, x, node_index=n_flat, training=True,
                            iid=True, rngs={"dropout": rng_d}, **kwargs)
        if scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat = sc.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        v = jax.lax.psum(v, axis)
        cnt = jax.lax.psum(cnt, axis)
        return v / jnp.maximum(cnt, 1.0)

    def local_step(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            loss_val, grads = jax.value_and_grad(local_loss)(p, key, data)
            grads = jax.lax.psum(grads, axis)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s), loss_val
        keys = jax.random.split(rng, max(steps_per_call, 1))
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    sharded = shard_map(local_step, mesh=mesh,
                        in_specs=(repl, repl, repl, data_specs),
                        out_specs=(repl, repl, repl), check_vma=False)
    jitted = jax.jit(sharded)

    step = bind_data(jitted, data)
    step.n_local = n_local
    return step


def make_sharded_window_step(model, optimizer, x_full, target, mask,
                             item_starts, window_offsets, horizon_offsets,
                             scaler, mesh: Mesh, u=None, support_ops=None,
                             batch_size: int = 64, loss: str = "mae",
                             scale_target: bool = False,
                             steps_per_call: int = 1, axis: str = "data"):
    """Data-parallel fused windowed training — the multi-chip variant of
    ``train.fused_window.make_fused_window_step`` (the traffic path, and
    every full-graph baseline model that trains on windows).

    Each device draws ``batch_size / n`` window starts from its own RNG
    stream (``fold_in(shard_id)`` — jointly uniform over items), gathers
    and propagates locally on the replicated series (traffic-scale
    arrays are small; HBM scaling is the IID path's concern — this path
    shards the per-step FLOPs), and the loss numerator/denominator and
    gradients psum over ``axis``, keeping replicated params
    bit-identical across devices. ``steps_per_call > 1`` scans that
    many optimizer steps per dispatch.
    """
    import optax

    from jax import shard_map
    from sgp.train.fused_window import make_offset_gather
    from sgp.train.metrics import _METRIC_FNS, _masked_reduce

    n_shards = mesh.shape[axis]
    assert batch_size % n_shards == 0
    local_bs = batch_size // n_shards
    loss_pt = _METRIC_FNS[loss]
    has_u = u is not None
    repl = P()
    gw = make_offset_gather(window_offsets)   # slice-form time gathers
    gh = make_offset_gather(horizon_offsets)

    def put(a):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, repl))

    data = (put(x_full), put(target), put(mask), put(item_starts)) \
        + ((jax.tree.map(put, tuple(support_ops)),)
           if support_ops is not None else ()) \
        + ((put(u),) if has_u else ())
    # prefix specs: one replicated P() per top-level entry covers the
    # operator pytree subtree too
    data_specs = (repl,) * 4 \
        + ((repl,) if support_ops is not None else ()) \
        + ((repl,) if has_u else ())

    def local_loss(params, rng, data):
        xf, tgt, msk, starts = data[:4]
        ops = data[4] if support_ops is not None else None
        u_arr = data[-1] if has_u else None
        rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        rng_i, rng_d = jax.random.split(rng)
        items = jax.random.choice(rng_i, starts, (local_bs,))
        x = gw(xf, items)                        # [Bl, W, N, Cin]
        if ops is not None:
            parts = [x]
            for op in ops:
                parts.append(op @ x)
            x = jnp.concatenate(parts, -1)
        y = gh(tgt, items)
        m = gh(msk, items)
        kwargs = {}
        if has_u:
            kwargs["u"] = gw(u_arr, items)
        y_hat = model.apply(params, x, training=True,
                            rngs={"dropout": rng_d}, **kwargs)
        if scale_target:
            y_ref = scaler.transform(y)
        else:
            y_hat = scaler.inverse_transform(y_hat)
            y_ref = y
        v, cnt = _masked_reduce(loss_pt, y_hat, y_ref, m)
        v = jax.lax.psum(v, axis)
        cnt = jax.lax.psum(cnt, axis)
        return v / jnp.maximum(cnt, 1.0)

    def local_step(params, opt_state, rng, data):
        def body(carry, key):
            p, s = carry
            loss_val, grads = jax.value_and_grad(local_loss)(p, key, data)
            grads = jax.lax.psum(grads, axis)
            updates, s = optimizer.update(grads, s, p)
            return (optax.apply_updates(p, updates), s), loss_val
        keys = jax.random.split(rng, max(steps_per_call, 1))
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), keys)
        return params, opt_state, losses.mean()

    sharded = shard_map(local_step, mesh=mesh,
                        in_specs=(repl, repl, repl, data_specs),
                        out_specs=(repl, repl, repl), check_vma=False)
    jitted = jax.jit(sharded)

    step = bind_data(jitted, data)
    return step


def make_sharded_iid_eval(model, encoded, target, mask, item_starts,
                          window_offsets, horizon_offsets, scaler,
                          metrics, mesh: Mesh, u=None,
                          axis: str = "data", batch_size: int = 32,
                          x_slice=None, unpack_targets: bool = False,
                          support_ops=None, n_nodes: int = None):
    """Node-sharded fused evaluation — the multi-chip counterpart of
    ``train.fused_window.make_fused_eval`` (same semantics: reference
    eval loop ``tsl/predictors/base_predictor.py:267-303``).

    Each device evaluates every eval window on ITS node slab of the
    encoded/target/mask arrays (1/n of each array per device, matching
    :func:`make_sharded_iid_step`'s placement), accumulates masked
    metric states locally in one ``lax.scan``, and psums the scalar
    states at the end — the full encoding never gathers onto one chip,
    completing the sharded encode -> train -> eval pipeline. Padded
    eval slots and padded nodes carry ``mask=False``.

    ``x_slice`` reads only the first lanes of a packed row layout
    (``train.iid.pack_iid_data``). With ``unpack_targets=True`` (packed
    rows, window of exactly one step) the horizon-shifted targets and
    masks are ALSO read from the packed lanes — ``target``/``mask`` may
    then be ``None`` and no separate copies ever occupy HBM.

    ``support_ops`` propagates the gathered windows on the fly (the
    stratified/beyond-HBM layout): each time batch all-gathers only its
    ``B·W·N·F`` selected rows over the device interconnect, each device contracts its node
    slab's operator ROWS against them (``DenseOperator`` block einsum;
    other operators full-prop + local slice).

    Arrays already node-sharded by ``shard_nodes`` (or produced by
    ``make_sharded_iid_step``) are reused in place — ``device_put`` with
    an identical sharding is a no-op, so passing ``step.data`` arrays
    allocates nothing new.
    """
    from jax import shard_map
    from sgp.ops.spmm import DenseOperator
    from sgp.parallel.halo import shard_nodes
    from sgp.train.fused_window import (make_offset_gather,
                                        pad_eval_items)
    from sgp.train.iid import unpack_iid_rows

    n_shards = mesh.shape[axis]
    # pre-padded/sharded arrays (e.g. step.data) carry the PADDED node
    # count — pass the true n_nodes so operator slices stay aligned
    if n_nodes is None:
        n_nodes = encoded.shape[1]
    n_local = -(-n_nodes // n_shards)
    has_u = u is not None
    u_node = has_u and u.ndim == 3
    n_h = int(np.asarray(horizon_offsets).shape[0])
    if unpack_targets:
        assert x_slice is not None, "unpack_targets requires x_slice"
        assert len(np.asarray(window_offsets)) == 1, \
            "packed-lane targets need a single-step window"
        lanes = encoded.shape[-1] - x_slice
        assert lanes > 0 and lanes % (3 * n_h) == 0, \
            (f"packed lane width {lanes} does not match 3*H*C for "
             f"H={n_h}; x_slice/horizon_offsets disagree with the "
             f"pack_iid_data layout")
        n_c = lanes // (3 * n_h)
        target = mask = None
    else:
        assert target is not None and mask is not None, \
            "target/mask required unless unpack_targets=True"

    encoded = shard_nodes(encoded, mesh, axis, node_axis=1)
    if target is not None:
        target = shard_nodes(target, mesh, axis, node_axis=1)
        mask = shard_nodes(mask, mesh, axis, node_axis=1)  # pads->False
    if u_node:
        u = shard_nodes(u, mesh, axis, node_axis=1)
    elif has_u:
        u = jax.device_put(u, NamedSharding(mesh, P()))

    starts, ok_flags = pad_eval_items(item_starts, batch_size)
    gw = make_offset_gather(window_offsets)
    gh = make_offset_gather(horizon_offsets)

    node_spec = P(None, axis, None)
    repl = P()
    has_tm = target is not None
    has_ops = support_ops is not None
    ops_repl = () if not has_ops else (jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, repl)),
        tuple(support_ops)),)
    data = (encoded,) \
        + ((target, mask) if has_tm else ()) \
        + (starts, ok_flags) + ops_repl \
        + ((u,) if has_u else ())
    data_specs = (node_spec,) \
        + ((node_spec, node_spec) if has_tm else ()) \
        + (repl, repl) + ((repl,) if has_ops else ()) \
        + (((node_spec if u_node else repl),) if has_u else ())

    def local_eval(params, data):
        enc = data[0]
        i = 1
        if has_tm:
            tgt, msk = data[i:i + 2]
            i += 2
        st, okf = data[i:i + 2]
        i += 2
        ops_d = data[i] if has_ops else None
        u_arr = data[-1] if has_u else None
        shard_id = jax.lax.axis_index(axis)
        node_ids = shard_id * n_local + jnp.arange(n_local)
        sc = scaler.index_nodes(node_ids)

        def body(state, inp):
            items, ok = inp                       # [B], [B] bool
            x = gw(enc, items)                    # [B, W, Nl, F]
            if unpack_targets:
                b = x.shape[0]
                _, y, m = unpack_iid_rows(
                    x[:, -1].reshape(b * n_local, -1), x_slice, n_h, n_c)
                y = y.reshape(b, n_local, n_h, n_c).transpose(0, 2, 1, 3)
                m = m.reshape(b, n_local, n_h, n_c).transpose(0, 2, 1, 3)
            else:
                y = gh(tgt, items)
                m = gh(msk, items)
            m = m & ok[:, None, None, None]
            if x_slice is not None:
                x = x[..., :x_slice]              # packed: feature lanes
            if ops_d is not None:
                # on-the-fly propagation on node-sharded features: move
                # only this batch's B*W*N*F rows over the device interconnect, contract each
                # device's operator ROW slab locally
                x_all = jax.lax.all_gather(x, axis, axis=2, tiled=True)
                x_all = x_all[:, :, :n_nodes]
                parts = [x]
                for op in ops_d:
                    if isinstance(op, DenseOperator):
                        block = op.mat[node_ids]          # [Nl, N]
                        hop = jnp.einsum(
                            "ln,bwnf->bwlf", block, x_all,
                            precision=op.precision,
                            preferred_element_type=jnp.float32
                            ).astype(x.dtype)
                    else:      # e.g. GlobalMeanOperator: full + take
                        # (take clamps per index, so the last shard's
                        # real rows stay aligned under node padding)
                        hop = jnp.take(op @ x_all, node_ids, axis=2)
                    parts.append(hop)
                x = jnp.concatenate(parts, -1)
            kwargs = {}
            if has_u:
                kwargs["u"] = gw(u_arr, items)
            y_hat = model.apply(params, x, node_index=node_ids,
                                training=False, **kwargs)
            y_hat = sc.inverse_transform(y_hat)
            return metrics.update(state, y_hat, y, m), None

        state, _ = jax.lax.scan(body, metrics.init(), (st, okf))
        # scalar (value, count) sums -> global metrics
        return jax.lax.psum(state, axis)

    sharded = shard_map(local_eval, mesh=mesh,
                        in_specs=(repl, data_specs), out_specs=repl,
                        check_vma=False)
    jitted = jax.jit(sharded)

    def eval_fn(params):
        state = jax.block_until_ready(jitted(params, data))
        return metrics.compute(state)

    eval_fn.core = jitted
    eval_fn.data = data
    eval_fn.metrics = metrics
    return eval_fn


def sharded_ridge(x_shards, y_shards, alpha: float, mesh: Mesh):
    """Distributed normal-equations ridge: each data shard computes its
    Gram/moment contribution, psum over ``data``, Cholesky replicated
    (SURVEY.md §2.6 sklearn-Ridge row). Implemented with shard_map."""
    from jax import shard_map
    from sgp.train.ridge import solve_ridge_normal

    d = x_shards.shape[-1]
    c = y_shards.shape[-1]

    def local(x, y):
        g = jnp.einsum("nd,ne->de", x, x, precision="highest")
        m = jnp.einsum("nd,nc->dc", x, y, precision="highest")
        g = jax.lax.psum(g, "data")
        m = jax.lax.psum(m, "data")
        return solve_ridge_normal(g, m, alpha)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data", None), P("data", None)),
                   out_specs=P(None, None))
    return fn(x_shards, y_shards)
