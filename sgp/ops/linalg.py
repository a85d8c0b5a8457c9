"""Dense linear algebra helpers.

Spectral-radius estimation for echo-state init: the reference calls full
``torch.linalg.eigvals`` (``lib/nn/reservoir/reservoir.py:74``); only the
largest |eigenvalue| is needed, so here it's a power iteration on the
doubled real matrix trick — but since complex eigenvalues of a real matrix
come in conjugate pairs with |λ| shared, we run power iteration on
``W`` with periodic two-step normalization which converges to |λ_max| for
generic matrices, and fall back to ``numpy.linalg.eigvals`` on the host for
small matrices (the init-time path, exact parity with the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def spectral_radius_exact(w: np.ndarray) -> float:
    """Host-side exact |λ|max via LAPACK (init-time, small matrices)."""
    return float(np.abs(np.linalg.eigvals(np.asarray(w, np.float64))).max())


def power_iteration_spectral_radius(w: jnp.ndarray, num_iters: int = 1500,
                                    seed: int = 0) -> jnp.ndarray:
    """Estimate |λ|max of a real square matrix on device.

    2-D orthogonal (subspace) iteration: captures a complex-conjugate
    dominant pair (the generic case for random reservoir matrices, where
    plain power iteration oscillates), then reads the pair's modulus off
    the projected 2x2 matrix analytically — ``sqrt(|det|)`` when the
    discriminant is negative, max root modulus otherwise. No complex
    eigensolver needed (not every backend has one).
    """
    n = w.shape[0]
    q = jax.random.normal(jax.random.PRNGKey(seed), (n, 2), w.dtype)

    def body(_, q):
        q, _ = jnp.linalg.qr(w @ q)
        return q

    q = jax.lax.fori_loop(0, num_iters, body, jnp.linalg.qr(q)[0])
    b = q.T @ (w @ q)  # 2x2 projected matrix holding the dominant pair
    tr = b[0, 0] + b[1, 1]
    det = b[0, 0] * b[1, 1] - b[0, 1] * b[1, 0]
    disc = tr * tr - 4.0 * det
    real_mod = jnp.maximum(jnp.abs(tr + jnp.sqrt(jnp.abs(disc))),
                           jnp.abs(tr - jnp.sqrt(jnp.abs(disc)))) / 2.0
    complex_mod = jnp.sqrt(jnp.abs(det))
    return jnp.where(disc >= 0, real_mod, complex_mod)
