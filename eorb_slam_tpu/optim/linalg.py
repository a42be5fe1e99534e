"""Small shared linear-algebra helpers for the solvers.

float32 normal equations in SLAM mix units (pixels^2 information against
meter/radian state), giving condition numbers that break a plain f32
Cholesky solve. Jacobi (diagonal) pre-conditioning fixes the scale
disparity at negligible cost — required for convergence in float32
(float64 is off on the device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_spd_jacobi(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = b for SPD H via Jacobi-preconditioned Cholesky.

    H: (n,n), b: (n,). Returns x (n,)."""
    d = jnp.diagonal(H)
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-20))
    Hs = H * s[:, None] * s[None, :]
    bs = b * s
    x = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(Hs, lower=True), bs
    )
    return x * s
