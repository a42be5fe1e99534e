"""Relocalization: batched PnP RANSAC + pose refinement.

Replacement for the reference's relocalization path
(src/Tracking.cc:2641-2730: KeyFrameDatabase candidates -> ORBmatcher
SearchByBoW -> MLPnPsolver RANSAC (src/MLPnPsolver.cpp) -> PoseOptimization).

Instead of MLPnP's sequential RANSAC, all hypotheses run at once: minimal
6-point sets are gathered into a batch, each solved by normalized DLT
(null vector of A^T A via eigh — batched symmetric eigendecomposition),
the rotation block re-projected onto SO(3) by SVD, and inliers scored with
one batched reprojection of every correspondence against every hypothesis.
The best hypothesis is refined by the same masked pose-only GN used for
per-frame tracking (optim/pose_only.py), matching the reference's final
PoseOptimization polish.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import lie
from ..optim import pose_only


def _dlt_pose(pts3d: jnp.ndarray, xy_norm: jnp.ndarray) -> jnp.ndarray:
    """6+ point DLT on normalized image coords -> Tcw (4,4).

    Solves min |A p| over the 12 entries of [R|t] (smallest eigenvector of
    A^T A), then projects onto SE(3): R <- U diag(1,1,det(UV^T)) V^T with the
    translation rescaled by the mean singular value."""
    n = pts3d.shape[0]
    X = jnp.concatenate([pts3d, jnp.ones((n, 1), pts3d.dtype)], axis=1)
    zeros = jnp.zeros_like(X)
    u, v = xy_norm[:, 0:1], xy_norm[:, 1:2]
    rows_u = jnp.concatenate([X, zeros, -u * X], axis=1)   # (n,12)
    rows_v = jnp.concatenate([zeros, X, -v * X], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)          # (2n,12)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    p = vecs[:, 0]
    P = p.reshape(3, 4)
    # cheirality: points must have positive depth on average
    depth_sign = jnp.sign(jnp.mean(X @ P[2, :]))
    P = P * jnp.where(depth_sign == 0, 1.0, depth_sign)
    M = P[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    R = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0]) + jnp.array([0.0, 0.0, 1.0]) * d) @ Vt
    scale = jnp.mean(S) * d
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1.0, scale)
    return lie.se3(R, t)


class RelocResult(NamedTuple):
    Tcw: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_hyp", "min_inliers"))
def pnp_ransac(
    cam_params: jnp.ndarray,
    pts3d: jnp.ndarray,     # (N,3) world points of candidate matches
    uv: jnp.ndarray,        # (N,2) observed (undistorted) pixels
    valid: jnp.ndarray,     # (N,) bool
    key: jax.Array,
    px_threshold: float = 5.991,
    n_hyp: int = 256,
    min_inliers: int = 15,
) -> RelocResult:
    N = pts3d.shape[0]
    xy_norm = cam_mod.pinhole_unproject_linear(cam_params, uv)[:, :2]
    probs = valid.astype(jnp.float32) / jnp.maximum(valid.sum(), 1)
    idx = jax.random.choice(key, N, (n_hyp, 6), replace=True, p=probs)

    Th = jax.vmap(lambda s: _dlt_pose(pts3d[s], xy_norm[s]))(idx)  # (H,4,4)

    def score(T):
        pc = (T[:3, :3] @ pts3d.T).T + T[:3, 3]
        uv_p = cam_mod.pinhole_project_linear(cam_params, pc)
        e2 = jnp.sum((uv_p - uv) ** 2, axis=-1)
        return valid & (e2 < px_threshold) & (pc[:, 2] > 0.05)

    inls = jax.vmap(score)(Th)
    counts = inls.sum(axis=1)
    best = jnp.argmax(counts)
    T0, inl0 = Th[best], inls[best]
    # GN polish on inliers (reference: Optimizer::PoseOptimization after PnP)
    T_ref, _, _ = pose_only.pose_optimization(
        cam_params, lie.se3_project(T0), pts3d, uv,
        jnp.ones(N, jnp.float32), inl0,
    )
    inl_ref = score(T_ref)
    better = inl_ref.sum() >= inl0.sum()
    Tcw = jnp.where(better, T_ref, T0)
    inl = jnp.where(better, inl_ref, inl0)
    n = inl.sum().astype(jnp.int32)
    return RelocResult(Tcw=Tcw, inliers=inl, n_inliers=n, ok=n >= min_inliers)
