"""Closed-form Sim3/SE3 alignment + vmapped RANSAC.

Replacement for the reference's Sim3Solver (src/Sim3Solver.cc:
Horn's quaternion method on 3-point minimal sets inside a sequential RANSAC
loop with reprojection-error inlier checks, used by loop/merge detection at
src/LoopClosing.cc:690). Here all hypotheses are evaluated at once: minimal
sets are gathered into a (H,3,3) batch, Horn's closed form runs under vmap
(the 4x4 N-matrix eigendecomposition maps to batched eigh), and inlier
scoring is one batched projection of all correspondences against all
hypotheses — no data-dependent loop, everything jit-compiled.

Also provides `umeyama` (all-point weighted closed form) used both for
inlier refinement and for trajectory alignment in evaluation (the
reference's evaluation/evaluate_ate_scale.py `align`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie


def _horn_rotation(P: jnp.ndarray, Q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Horn's closed-form rotation: R such that Q ~ R P (centered inputs).
    P, Q: (N,3) centered, w: (N,) weights. Returns (3,3)."""
    M = (w[:, None] * P).T @ Q  # (3,3)
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    _, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]  # max eigenvalue; q = (w,x,y,z)
    return lie.quat_to_mat(q)


def umeyama(
    P: jnp.ndarray, Q: jnp.ndarray, w: jnp.ndarray | None = None,
    with_scale: bool = True
):
    """Weighted closed-form Sim3 (R, t, s) minimizing sum w |Q - (sRP+t)|^2.

    Equivalent of Sim3Solver::ComputeSim3 (reference src/Sim3Solver.cc) and
    of the evaluation-side Horn alignment (evaluation/evaluate_ate_scale.py).
    """
    if w is None:
        w = jnp.ones(P.shape[0], P.dtype)
    wsum = jnp.maximum(w.sum(), 1e-9)
    cp = (w[:, None] * P).sum(0) / wsum
    cq = (w[:, None] * Q).sum(0) / wsum
    P0, Q0 = P - cp, Q - cq
    R = _horn_rotation(P0, Q0, w)
    num = (w * jnp.einsum("ni,ni->n", Q0, (R @ P0.T).T)).sum()
    den = jnp.maximum((w * jnp.einsum("ni,ni->n", P0, P0)).sum(), 1e-12)
    s = jnp.where(jnp.asarray(with_scale), num / den, 1.0)
    t = cq - s * R @ cp
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: jnp.ndarray        # (3,3) best hypothesis, refined on inliers
    t: jnp.ndarray        # (3,)
    s: jnp.ndarray        # ()
    inliers: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("n_hyp", "with_scale")
)
def sim3_ransac(
    pts1: jnp.ndarray,       # (N,3) points in KF1 camera frame
    pts2: jnp.ndarray,       # (N,3) matched points in KF2 camera frame
    valid: jnp.ndarray,      # (N,) bool
    key: jax.Array,
    px_threshold: jnp.ndarray,  # (N,) per-match pixel threshold (9.21*sigma2)
    cam_params1: jnp.ndarray,
    cam_params2: jnp.ndarray,
    n_hyp: int = 128,
    with_scale: bool = True,
) -> Sim3RansacResult:
    """Batched-hypothesis Sim3 RANSAC between two matched 3D point sets,
    scored by symmetric reprojection error in both cameras (reference
    src/Sim3Solver.cc:152-221 `iterate` + `CheckInliers`)."""
    from . import camera as cam_mod

    N = pts1.shape[0]
    nv = jnp.maximum(valid.sum(), 3)
    # random minimal triples, biased to valid entries
    probs = valid.astype(jnp.float32) / jnp.maximum(valid.sum(), 1)
    idx = jax.random.choice(key, N, (n_hyp, 3), replace=True, p=probs)

    def fit(tri):
        P, Q = pts1[tri], pts2[tri]
        return umeyama(P, Q, with_scale=with_scale)

    Rh, th, sh = jax.vmap(fit)(idx)  # (H,3,3),(H,3),(H,)

    # score: project pts1 through hypothesis into cam2 and vice versa
    def score(R, t, s):
        p2 = s * (R @ pts1.T).T + t
        uv2 = cam_mod.pinhole_project_linear(cam_params2, p2)
        Ri, ti, si = lie.sim3_inv(R, t, s)
        p1 = si * (Ri @ pts2.T).T + ti
        uv1 = cam_mod.pinhole_project_linear(cam_params1, p1)
        uv1_obs = cam_mod.pinhole_project_linear(cam_params1, pts1)
        uv2_obs = cam_mod.pinhole_project_linear(cam_params2, pts2)
        e1 = jnp.sum((uv1 - uv1_obs) ** 2, -1)
        e2 = jnp.sum((uv2 - uv2_obs) ** 2, -1)
        inl = valid & (e1 < px_threshold) & (e2 < px_threshold) \
            & (p2[:, 2] > 0) & (p1[:, 2] > 0)
        return inl

    inls = jax.vmap(score)(Rh, th, sh)  # (H,N)
    counts = inls.sum(axis=1)
    best = jnp.argmax(counts)
    inl = inls[best]
    # refine on inliers with the weighted closed form
    w = inl.astype(jnp.float32)
    R, t, s = umeyama(pts1, pts2, w, with_scale=with_scale)
    inl_ref = score(R, t, s)
    better = inl_ref.sum() >= inl.sum()
    R = jnp.where(better, R, Rh[best])
    t = jnp.where(better, t, th[best])
    s = jnp.where(better, s, sh[best])
    inl = jnp.where(better, inl_ref, inl)
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inl,
                            n_inliers=inl.sum().astype(jnp.int32))
