"""Batched two-view triangulation + quality checks.

Replaces the reference's per-point DLT triangulation inside
TwoViewReconstruction::Triangulate and LocalMapping::CreateNewMapPoints
(reference src/TwoViewReconstruction.cc, src/LocalMapping.cc) with a single
vmapped closed-form solve.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie


def triangulate_dlt(T1: jnp.ndarray, T2: jnp.ndarray,
                    ray1: jnp.ndarray, ray2: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation of normalized-ray correspondences.

    Args:
      T1, T2: (...,4,4) world->camera poses.
      ray1, ray2: (...,3) unit-z rays in each camera (x, y, 1).

    Returns world points (...,3). Solves the 4x4 homogeneous system via the
    normal-equations eigenvector (smallest eigenvalue of A^T A), which
    vmaps/compiles cleanly under jit (no per-point SVD)."""
    P1 = T1[..., :3, :]  # (...,3,4)
    P2 = T2[..., :3, :]

    rows = jnp.stack(
        [
            ray1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            ray1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            ray2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            ray2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # (...,4,4)
    AtA = jnp.swapaxes(rows, -1, -2) @ rows
    # smallest eigenvector of symmetric 4x4
    w, v = jnp.linalg.eigh(AtA)
    X = v[..., :, 0]
    w4 = X[..., 3]
    w_safe = jnp.where(jnp.abs(w4) < 1e-12, 1e-12, w4)
    return X[..., :3] / w_safe[..., None]


def triangulation_checks(
    T1, T2, ray1, ray2, pts_w,
    min_parallax_cos: float = 0.9998,
    max_reproj_err2: float = 5.991,
    inv_sigma1=1.0, inv_sigma2=1.0,
):
    """Cheirality + parallax + reprojection gates (normalized-coords reproj
    scaled by focal handled by caller via inv_sigma in pixels).

    Mirrors TwoViewReconstruction::CheckRT's accept criteria
    (reference src/TwoViewReconstruction.cc): positive depth in both views,
    parallax angle above threshold (cos below min_parallax_cos), squared
    reprojection error below chi2."""
    pc1 = lie.se3_apply(T1, pts_w)
    pc2 = lie.se3_apply(T2, pts_w)
    pos = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    c1 = lie.se3_trans(lie.se3_inv(T1))
    c2 = lie.se3_trans(lie.se3_inv(T2))
    d1 = pts_w - c1
    d2 = pts_w - c2
    cos_par = jnp.sum(d1 * d2, axis=-1) / (
        jnp.linalg.norm(d1, axis=-1) * jnp.linalg.norm(d2, axis=-1) + 1e-12
    )
    good_par = cos_par < min_parallax_cos

    z1 = jnp.where(jnp.abs(pc1[..., 2]) < 1e-9, 1e-9, pc1[..., 2])
    z2 = jnp.where(jnp.abs(pc2[..., 2]) < 1e-9, 1e-9, pc2[..., 2])
    inv_sigma1 = jnp.asarray(inv_sigma1)[..., None]
    inv_sigma2 = jnp.asarray(inv_sigma2)[..., None]
    e1 = (pc1[..., :2] / z1[..., None] - ray1[..., :2]) * inv_sigma1
    e2 = (pc2[..., :2] / z2[..., None] - ray2[..., :2]) * inv_sigma2
    err1 = jnp.sum(e1 * e1, axis=-1)
    err2 = jnp.sum(e2 * e2, axis=-1)
    good_err = (err1 < max_reproj_err2) & (err2 < max_reproj_err2)
    return pos & good_par & good_err, cos_par
