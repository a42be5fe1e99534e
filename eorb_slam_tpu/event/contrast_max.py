"""Contrast maximization by jitted gradient ascent through the splat.

Replaces the reference's Ceres ``GradientProblemSolver`` machinery
(``EvOptimizer::optimizeFocus_MS_RT2D``, reference src/Event/
EvOptimizer.cpp:46-201: 3-param rotation+translation-2D warp whose cost is
the negative mean square of the warped event image, with hand-written
per-event gradient accumulation): here the warp + Gaussian splat +
contrast objective is one differentiable jitted function and ``jax.grad``
supplies the exact same gradient — no hand-derived Jacobians, and the whole
ascent loop is a single XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eorb_slam_tpu.event import tensorize


def _contrast(params, xy, t_rel, valid, pol, center, H, W, sigma):
    xy_w = tensorize.warp_se2(xy, t_rel, params, center)
    img = tensorize.splat_gauss(xy_w, valid, pol, H, W, sigma=sigma)
    # variance objective (mean-square of the mean-removed image): sharper
    # motion-compensated images concentrate mass -> higher variance
    mu = jnp.mean(img)
    return jnp.mean((img - mu) ** 2)


@functools.partial(jax.jit, static_argnames=("H", "W", "iters", "sigma"))
def maximize_rt2d(
    xy: jnp.ndarray,       # (N,2) event pixel coords
    t_rel: jnp.ndarray,    # (N,) relative time in the window (seconds)
    valid: jnp.ndarray,    # (N,)
    H: int,
    W: int,
    params0: jnp.ndarray = None,   # (3,) [omega, vx, vy] init
    iters: int = 60,
    sigma: float = 1.0,
    lr: float = 1.0,
):
    """Estimate (omega, vx, vy) maximizing the warped-image contrast.

    Returns (params, contrast_final, contrast_initial). Normalized-gradient
    ascent with per-parameter scaling (rotation rad/s vs translation px/s
    differ by ~2 orders) and step-halving on non-improvement."""
    n = xy.shape[0]
    pol = jnp.ones(n, xy.dtype)
    center = jnp.asarray([W / 2.0, H / 2.0], xy.dtype)
    if params0 is None:
        params0 = jnp.zeros(3, xy.dtype)

    f = lambda p: _contrast(p, xy, t_rel, valid, pol, center, H, W, sigma)
    g = jax.grad(f)

    # parameter scales: a rotation of 1 rad/s moves corner pixels ~H/2 px/s
    scale = jnp.asarray([2.0 / max(H, W), 1.0, 1.0], xy.dtype)

    def body(_, state):
        p, step, best = state
        grad = g(p) * scale * scale  # preconditioned ascent direction
        gn = jnp.linalg.norm(grad / scale)
        p_new = p + step * grad / jnp.maximum(gn, 1e-12)
        c_new = f(p_new)
        better = c_new > best
        p = jnp.where(better, p_new, p)
        best = jnp.where(better, c_new, best)
        step = jnp.where(better, step * 1.1, step * 0.5)
        return p, step, best

    c0 = f(params0)
    p, _, c = jax.lax.fori_loop(
        0, iters, body, (params0, jnp.asarray(lr, xy.dtype), c0)
    )
    return p, c, c0


def fit_rt2d_points(
    prev_pts: jnp.ndarray,   # (Np,2) KLT reference corners
    cur_pts: jnp.ndarray,    # (Np,2) tracked positions
    valid: jnp.ndarray,      # (Np,) bool
    dt: jnp.ndarray,         # () time between the two point sets (seconds)
    center: jnp.ndarray,     # (2,) rotation center (image center)
):
    """Closed-form (omega, vx, vy) flow fit from matched points.

    Equivalent of the reference's SE2 fit of matched keypoints
    (MyOptimizer::optimize2D, include/Utils/MyOptimizer.h:78), which feeds
    one of the MCI candidates: small-angle least squares of the model
    flow = dt * [-omega*(y-cy) + vx, omega*(x-cx) + vy] against the
    measured KLT displacements. Returns ((3,) params, () n_used)."""
    w = valid.astype(prev_pts.dtype)
    d = cur_pts - prev_pts                                   # (Np,2)
    rx = prev_pts[:, 0] - center[0]
    ry = prev_pts[:, 1] - center[1]
    dt = jnp.maximum(dt, 1e-9)
    zero = jnp.zeros_like(rx)
    one = jnp.ones_like(rx)
    # rows: [ -ry 1 0 ; rx 0 1 ] * dt, stacked per point
    A = jnp.stack([
        jnp.stack([-ry, one, zero], axis=-1),
        jnp.stack([rx, zero, one], axis=-1),
    ], axis=1) * dt                                          # (Np,2,3)
    Aw = A * w[:, None, None]
    H = jnp.einsum("nij,nik->jk", Aw, A)
    b = jnp.einsum("nij,ni->j", Aw, d)
    H = H + 1e-9 * jnp.eye(3, dtype=H.dtype) * jnp.maximum(
        jnp.trace(H) / 3.0, 1.0
    )
    params = jnp.linalg.solve(H, b)
    params = jnp.where(jnp.isfinite(params).all(), params, jnp.zeros(3, H.dtype))
    return params, jnp.sum(valid.astype(jnp.int32))
