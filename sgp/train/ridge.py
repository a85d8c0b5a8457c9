"""Closed-form ridge readout.

Replacement for the sklearn Ridge solve in the DynGESN path
(``experiments/run_closed_form.py:191-228``): normal equations

    (X^T X + lambda I) W = X^T Y

with the Gram matrix accumulated on device in f32 (chunked so X never
needs to be resident at once) and solved by Cholesky. The Gram
accumulation is a pure sum over samples, so the multi-chip version just
``psum``s the per-shard Gram/moment matrices (SURVEY.md §2.6) — see
``sgp.parallel``. Intercept handling matches sklearn's
``fit_intercept=True`` (center X and Y, solve, recover bias).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("fit_intercept",))
def _gram_moments(x, y, fit_intercept: bool = True):
    n = x.shape[0]
    x_mean = x.mean(0) if fit_intercept else jnp.zeros(x.shape[1])
    y_mean = y.mean(0) if fit_intercept else jnp.zeros(y.shape[1])
    xc = x - x_mean
    yc = y - y_mean
    g = jnp.einsum("nd,ne->de", xc, xc, precision="highest")
    m = jnp.einsum("nd,nc->dc", xc, yc, precision="highest")
    return g, m, x_mean, y_mean, jnp.asarray(n, jnp.float32)


def ridge_regression(x: jnp.ndarray, y: jnp.ndarray, alpha: float = 1.0,
                     fit_intercept: bool = True,
                     chunk: Optional[int] = 65536
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fit ``Y ~ X W + b``. Returns ``(W [D, C], b [C])``.

    ``chunk`` streams the Gram accumulation over sample blocks so that
    arbitrarily many samples fit (the CER-En closed-form X is
    (T*N) x D, SURVEY.md §7.4).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    n, d = x.shape
    if chunk is None or n <= chunk:
        g, m, x_mean, y_mean, _ = _gram_moments(x, y, fit_intercept)
    else:
        # two passes: means, then centered Gram/moments per chunk
        x_mean = x.mean(0) if fit_intercept else jnp.zeros(d)
        y_mean = y.mean(0) if fit_intercept else jnp.zeros(y.shape[1])
        g = jnp.zeros((d, d))
        m = jnp.zeros((d, y.shape[1]))
        for s in range(0, n, chunk):
            xc = x[s:s + chunk] - x_mean
            yc = y[s:s + chunk] - y_mean
            g = g + jnp.einsum("nd,ne->de", xc, xc, precision="highest")
            m = m + jnp.einsum("nd,nc->dc", xc, yc, precision="highest")
    w = solve_ridge_normal(g, m, alpha)
    b = y_mean - x_mean @ w if fit_intercept else jnp.zeros(y.shape[1])
    return w, b


@jax.jit
def solve_ridge_normal(gram: jnp.ndarray, moment: jnp.ndarray,
                       alpha: float) -> jnp.ndarray:
    """Solve ``(G + alpha I) W = M`` (jittable core — this is the piece
    that runs replicated after a psum in the sharded path). Cholesky for
    alpha > 0; for alpha <= 0 (or a singular Gram) Cholesky would emit
    silent NaNs, so a least-squares solve is used instead (matching
    sklearn Ridge's robustness at alpha ~ 0)."""
    d = gram.shape[0]
    a = gram + alpha * jnp.eye(d, dtype=gram.dtype)
    chol = jax.scipy.linalg.cho_factor(a)
    sol = jax.scipy.linalg.cho_solve(chol, moment)
    fallback = jnp.linalg.lstsq(a, moment)[0]
    return jnp.where(jnp.isfinite(sol).all(), sol, fallback)


def take_steps(p, steps):
    """Gather time steps from a (possibly multi-GB HBM-resident) array.
    Contiguous runs use ``dynamic_slice`` — the compiled XLA gather on
    huge operands materializes enormous temps. A single step is
    trivially contiguous."""
    steps = np.asarray(steps)
    if len(steps) == 1 or np.all(np.diff(steps) == 1):
        return jax.lax.dynamic_slice_in_dim(p, int(steps[0]),
                                            len(steps), axis=0)
    return p[steps]


def gather_feat_parts(parts, steps):
    """Per-chunk channel concat of feature parts (never materializes a
    full-width copy next to the resident parts), cast to f32."""
    chunks = [take_steps(p, steps).astype(jnp.float32) for p in parts]
    return chunks[0] if len(chunks) == 1         else jnp.concatenate(chunks, -1)


def closed_form_readout_streaming(feats,                   # [T,N,D] or list
                                  targets: jnp.ndarray,    # [T, N, C] dev
                                  train_steps: np.ndarray,
                                  horizon: int,
                                  alpha: float = 1.0,
                                  chunk: int = 256):
    """Device-resident closed-form fit for encodings too large to move
    to the host: Gram and per-lag moments accumulate chunk-by-chunk over
    the training window steps — the flattened ``[T*N, D]`` design matrix
    is never materialized (full-scale DynGESN on one chip; the
    host-array path would ship tens of GB over the device link).

    ``feats`` may be a list of ``[T, N, *]`` parts — they are
    channel-concatenated PER CHUNK, so a full-width copy of the design
    features never materializes alongside the parts (avoids doubling
    HBM when the encoding itself is near capacity).

    Returns ``[(W, b)] * horizon`` like :func:`closed_form_readout`.
    """
    parts = feats if isinstance(feats, (list, tuple)) else [feats]
    train_steps = np.asarray(train_steps)
    t_count = len(train_steps)
    n = parts[0].shape[1]
    d = sum(int(p.shape[2]) for p in parts)
    c = targets.shape[2]
    total = float(t_count * n)

    contiguous = t_count > 1 and np.all(np.diff(train_steps) == 1)

    @functools.partial(jax.jit, static_argnames=("tc", "h"))
    def slice_inputs_jit(start, tc, h, parts_arg, targets_arg):
        """In-jit contiguous slicing of feats parts + per-lag targets —
        everything for one chunk in ONE device dispatch (per-lag eager
        slices otherwise dominate wall time on a high-latency link).
        Big arrays are explicit args, never closure constants."""
        f = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(p, start, tc, axis=0)
             .astype(jnp.float32) for p in parts_arg], -1)
        y_all = jax.lax.dynamic_slice_in_dim(
            targets_arg, start + 1, tc + h - 1, axis=0)
        y_chunks = jnp.stack(
            [jax.lax.dynamic_slice_in_dim(y_all, lag, tc, axis=0)
             for lag in range(h)])
        return f, y_chunks

    def chunk_inputs(s):
        steps = train_steps[s:s + chunk]
        if contiguous and len(steps) == chunk:
            return slice_inputs_jit(int(steps[0]), chunk, horizon,
                                    tuple(parts), targets)
        f = gather_feat_parts(parts, steps)
        y_chunks = jnp.stack([take_steps(targets, steps + lag)
                              for lag in range(1, horizon + 1)])
        return f, y_chunks

    # pass 1: means (cheap sweeps; keeps the Gram accumulation centered
    # — raw-moment centering over millions of samples is cancellation-
    # prone in f32, matching ridge_regression's two-pass chunked branch)
    @jax.jit
    def sums_chunk(f_chunk, y_chunks):
        return (f_chunk.reshape(-1, d).sum(0),
                y_chunks.astype(jnp.float32).sum(axis=(1, 2)))

    sx = jnp.zeros(d)
    sy = jnp.zeros((horizon, c))
    for s in range(0, t_count, chunk):
        f_chunk, y_chunks = chunk_inputs(s)
        dsx, dsy = sums_chunk(f_chunk, y_chunks)
        sx, sy = sx + dsx, sy + dsy
    mu = sx / total
    nus = sy / total                                        # [H, C]

    @jax.jit
    def moments_chunk(f_chunk, y_chunks, mu, nus):
        f2 = f_chunk.reshape(-1, d) - mu
        g = jnp.einsum("nd,ne->de", f2, f2, precision="highest")
        yc = (y_chunks.reshape(horizon, -1, c).astype(jnp.float32)
              - nus[:, None, :])
        m = jnp.einsum("nd,hnc->hdc", f2, yc, precision="highest")
        return g, m

    g = jnp.zeros((d, d))
    m = jnp.zeros((horizon, d, c))
    for s in range(0, t_count, chunk):
        f_chunk, y_chunks = chunk_inputs(s)
        dg, dm = moments_chunk(f_chunk, y_chunks, mu, nus)
        g, m = g + dg, m + dm

    out = []
    for lag in range(horizon):
        w = solve_ridge_normal(g, m[lag], alpha)
        out.append((w, nus[lag] - mu @ w))
    return out


def closed_form_readout(x_train: np.ndarray, targets_by_lag,
                        alpha: float = 1.0):
    """Per-lag ridge fits (``run_closed_form.py:191-196``): one
    independent solve per horizon lag, sharing the same design matrix —
    so the Gram is computed ONCE and reused across all lags (an
    algorithmic win over the reference's per-lag sklearn refits).

    Args:
        x_train: ``[M, D]`` design matrix.
        targets_by_lag: iterable of ``[M, C]`` per-lag targets.

    Returns: list of ``(W, b)`` per lag.
    """
    x = jnp.asarray(x_train, jnp.float32)
    n, d = x.shape
    x_mean = x.mean(0)
    xc = x - x_mean
    g = jnp.einsum("nd,ne->de", xc, xc, precision="highest")
    out = []
    for y in targets_by_lag:
        y = jnp.asarray(y, jnp.float32)
        y_mean = y.mean(0)
        m = jnp.einsum("nd,nc->dc", xc, y - y_mean, precision="highest")
        w = solve_ridge_normal(g, m, alpha)
        out.append((w, y_mean - x_mean @ w))
    return out
