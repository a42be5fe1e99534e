"""Motion-only pose optimization (tracking inner loop).

Equivalent of Optimizer::PoseOptimization (reference
src/Optimizer.cc:880): 4 rounds x 10 Gauss-Newton iterations over the
current frame's map-point matches, Huber(sqrt(5.991)) in the first rounds,
per-round outlier re-classification at chi2 > 5.991, outliers removed from
the normal equations but re-tested every round (they may return).

Everything is fixed-shape: N observation slots with a validity mask.
The whole optimization is ONE jitted call — no host round-trips inside.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.optim import linalg, reprojection, robust


def _gn_step(cam_params, Tcw, pts_w, uv_obs, inv_sigma, weight_mask, use_huber):
    """One Gauss-Newton step on a single pose. Returns (dx, chi2_per_obs)."""
    r, J_pose, _ = reprojection.mono_residual_jac(
        cam_params, Tcw, pts_w, uv_obs, inv_sigma
    )
    chi2 = jnp.sum(r * r, axis=-1)  # (N,)
    w_rob = jnp.where(
        use_huber, robust.huber_weight(chi2, robust.CHI2_MONO), 1.0
    )
    w = w_rob * weight_mask  # (N,)
    # H = sum w J^T J (6x6), b = sum w J^T r
    JW = J_pose * w[:, None, None]
    H = jnp.einsum("nij,nik->jk", JW, J_pose)
    b = -jnp.einsum("nij,ni->j", JW, r)  # -J^T W r
    # Levenberg damping for safety on degenerate geometry
    H = H + 1e-6 * jnp.eye(6, dtype=H.dtype) * jnp.maximum(jnp.trace(H) / 6.0, 1.0)
    dx = linalg.solve_spd_jacobi(H, b)
    # degenerate systems (all weights zero / rank-deficient geometry) must
    # not emit NaN steps — the pose simply stays put
    dx = jnp.where(jnp.isfinite(dx).all(), dx, jnp.zeros_like(dx))
    return dx, chi2


@functools.partial(jax.jit, static_argnames=("rounds", "iters_per_round"))
def pose_optimization(
    cam_params: jnp.ndarray,
    Tcw0: jnp.ndarray,
    pts_w: jnp.ndarray,
    uv_obs: jnp.ndarray,
    inv_sigma: jnp.ndarray,
    valid: jnp.ndarray,
    rounds: int = 4,
    iters_per_round: int = 10,
):
    """Optimize a single pose against fixed 3D points.

    Args:
      cam_params: (9,) pinhole params (linear part used).
      Tcw0: (4,4) initial world->camera pose.
      pts_w: (N,3) matched map points (fixed).
      uv_obs: (N,2) undistorted observations.
      inv_sigma: (N,) per-observation sqrt information (1/sigma_octave).
      valid: (N,) bool — slot has a real match.

    Returns:
      (Tcw, inlier_mask (N,) bool, num_inliers ())
    """
    valid_f = valid.astype(Tcw0.dtype)

    def round_body(ri, state):
        Tcw, inlier = state
        use_huber = ri < rounds - 2  # final rounds: plain least squares

        def gn_body(_, T):
            dx, _ = _gn_step(
                cam_params, T, pts_w, uv_obs, inv_sigma, inlier * valid_f, use_huber
            )
            return lie.se3_exp(dx) @ T

        Tcw = jax.lax.fori_loop(0, iters_per_round, gn_body, Tcw)
        # re-classify ALL valid observations (outliers can come back)
        r = reprojection.mono_residual(cam_params, Tcw, pts_w, uv_obs, inv_sigma)
        chi2 = jnp.sum(r * r, axis=-1)
        pos = reprojection.depth_positive(Tcw, pts_w)
        inlier = ((chi2 <= robust.CHI2_MONO) & pos).astype(Tcw0.dtype)
        return Tcw, inlier

    inlier0 = valid_f
    Tcw, inlier = jax.lax.fori_loop(0, rounds, round_body, (Tcw0, inlier0))
    Tcw = lie.se3_project(Tcw)  # see lie.project_so3: drift is amplified
    inlier_mask = (inlier > 0.5) & valid
    return Tcw, inlier_mask, jnp.sum(inlier_mask.astype(jnp.int32))
