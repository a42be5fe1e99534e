"""Monocular two-view initialization: vmapped H/F RANSAC + model selection
+ motion recovery, all inside one jit.

Re-design of the reference TwoViewReconstruction
(src/TwoViewReconstruction.cc): instead of two host threads racing H vs F
with early-exit RANSAC (:131-132), all `iters` hypotheses of BOTH models
are scored as one batched computation (vmapped minimal solvers + dense
residual matrices), the H-vs-F choice follows the same SH/(SH+SF) > 0.40
rule, and motion recovery checks the 4 essential / 8 homography motions in
parallel with batched triangulation.

Coordinates: inputs are undistorted PIXELS + the linear camera; internally
everything is camera-normalized (so the fitted "F" is the essential matrix
E), while scoring applies the focal factor to keep the reference's
pixel-unit chi2 thresholds (3.841 / 5.991) meaningful.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie, triangulation

CHI2_F = 3.841
CHI2_H = 5.991
TH_SCORE = 5.991  # per-point score cap, same for both models (reference)


class TwoViewResult(NamedTuple):
    success: jnp.ndarray      # () bool
    Tcw2: jnp.ndarray         # (4,4) pose of view 2 (view 1 = identity)
    pts3d: jnp.ndarray        # (N,3) triangulated points (view-1/world frame)
    is_triangulated: jnp.ndarray  # (N,) bool
    used_homography: jnp.ndarray  # () bool
    n_good: jnp.ndarray       # () int32


def _normalize(cam_params, uv):
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)


def _sample_minimal_sets(key, valid, iters: int, k: int):
    """(iters, k) indices drawn from valid slots (approx. without replacement:
    per-hypothesis Gumbel top-k over the valid mask — fully batched)."""
    n = valid.shape[0]
    g = jax.random.gumbel(key, (iters, n))
    scores = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, k)
    return idx


def _fit_E_batch(x1, x2):
    """8-point algorithm on camera-normalized coords.

    x1, x2: (S, 8, 2) -> E (S, 3, 3), rank-2 enforced."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = jnp.ones_like(u1)
    # rows of the constraint x2^T E x1 = 0
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1
    )  # (S,8,9)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, V = jnp.linalg.eigh(AtA)
    e = V[..., :, 0]
    E = e.reshape(e.shape[:-1] + (3, 3))
    # rank-2 projection with equal singular values (essential constraint)
    U, s, Vt = jnp.linalg.svd(E)
    s_mean = (s[..., 0] + s[..., 1]) / 2.0
    s_new = jnp.stack([s_mean, s_mean, jnp.zeros_like(s_mean)], axis=-1)
    return U @ (s_new[..., None] * Vt)


def _fit_H_batch(x1, x2):
    """4-point DLT: x1, x2 (S, 4, 2) -> H (S, 3, 3) with x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zeros = jnp.zeros_like(u1)
    ones = jnp.ones_like(u1)
    rows1 = jnp.stack(
        [zeros, zeros, zeros, -u1, -v1, -ones, v2 * u1, v2 * v1, v2], axis=-1
    )
    rows2 = jnp.stack(
        [u1, v1, ones, zeros, zeros, zeros, -u2 * u1, -u2 * v1, -u2], axis=-1
    )
    A = jnp.concatenate([rows1, rows2], axis=-2)  # (S,8,9)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, V = jnp.linalg.eigh(AtA)
    h = V[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _score_E(E, x1, x2, valid, f2):
    """Symmetric epipolar chi2 score (pixel units via focal^2 factor f2).

    Returns (score (S,), inliers (S,N))."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)  # (N,3)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    l2 = jnp.einsum("sij,nj->sni", E, x1h)      # line in image 2
    l1 = jnp.einsum("sji,nj->sni", E, x2h)      # line in image 1
    num = jnp.einsum("ni,sni->sn", x2h, l2)
    d2_2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12) * f2
    d2_1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12) * f2
    in1 = d2_1 < CHI2_F
    in2 = d2_2 < CHI2_F
    sc = jnp.where(in1, TH_SCORE - d2_1, 0.0) + jnp.where(in2, TH_SCORE - d2_2, 0.0)
    sc = sc * valid[None, :]
    return jnp.sum(sc, axis=-1), in1 & in2 & (valid[None, :] > 0)


def _score_H(H, x1, x2, valid, f2):
    """Symmetric transfer error score for homographies."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Hx1 = jnp.einsum("sij,nj->sni", H, x1h)
    Hinv = jnp.linalg.inv(H)
    Hx2 = jnp.einsum("sij,nj->sni", Hinv, x2h)
    p21 = Hx1[..., :2] / jnp.where(
        jnp.abs(Hx1[..., 2:3]) < 1e-12, 1e-12, Hx1[..., 2:3]
    )
    p12 = Hx2[..., :2] / jnp.where(
        jnp.abs(Hx2[..., 2:3]) < 1e-12, 1e-12, Hx2[..., 2:3]
    )
    d2_2 = jnp.sum((p21 - x2[None]) ** 2, axis=-1) * f2
    d2_1 = jnp.sum((p12 - x1[None]) ** 2, axis=-1) * f2
    in1 = d2_1 < CHI2_H
    in2 = d2_2 < CHI2_H
    sc = jnp.where(in1, TH_SCORE - d2_1, 0.0) + jnp.where(in2, TH_SCORE - d2_2, 0.0)
    sc = sc * valid[None, :]
    return jnp.sum(sc, axis=-1), in1 & in2 & (valid[None, :] > 0)


def _decompose_E(E):
    """4 candidate (R, t) from an essential matrix."""
    U, s, Vt = jnp.linalg.svd(E)
    # keep proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None] if Vt.ndim > 2 else Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    t = t / (jnp.linalg.norm(t, axis=-1, keepdims=True) + 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_H(H):
    """8 candidate (R, t, n) via Faugeras-Lustman SVD decomposition
    (same method as reference TwoViewReconstruction::ReconstructH)."""
    U, s, Vt = jnp.linalg.svd(H)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    V = Vt.T

    d2s = jnp.maximum(d2, 1e-9)
    x1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    e1 = jnp.asarray([1.0, -1.0, 1.0, -1.0], H.dtype)
    e3 = jnp.asarray([1.0, 1.0, -1.0, -1.0], H.dtype)

    # case d' > 0
    st_pos = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 + d3) * d2s)
    ct_pos = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2s)

    def make_pos(i):
        stheta = e1[i] * e3[i] * st_pos
        Rp = jnp.asarray(
            [[ct_pos, 0.0, -stheta], [0.0, 1.0, 0.0], [stheta, 0.0, ct_pos]]
        )
        tp = (d1 - d3) * jnp.asarray([x1 * e1[i], 0.0, -x3 * e3[i]])
        npp = jnp.asarray([x1 * e1[i], 0.0, x3 * e3[i]])
        return Rp, tp, npp

    # case d' < 0
    sphi = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 - d3) * d2s + 1e-12)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2s + 1e-12)

    def make_neg(i):
        sp = e1[i] * e3[i] * sphi
        Rp = jnp.asarray(
            [[cphi, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cphi]]
        )
        tp = (d1 + d3) * jnp.asarray([x1 * e1[i], 0.0, x3 * e3[i]])
        npp = jnp.asarray([x1 * e1[i], 0.0, x3 * e3[i]])
        return Rp, tp, npp

    Rs, ts = [], []
    for i in range(4):
        Rp, tp, _ = make_pos(i)
        R = detUV * (U @ Rp @ Vt)
        t = (U @ tp[:, None])[:, 0]
        Rs.append(R)
        ts.append(t / (jnp.linalg.norm(t) + 1e-12))
    for i in range(4):
        Rp, tp, _ = make_neg(i)
        R = detUV * (U @ Rp @ Vt)
        t = (U @ tp[:, None])[:, 0]
        Rs.append(R)
        ts.append(t / (jnp.linalg.norm(t) + 1e-12))
    return jnp.stack(Rs), jnp.stack(ts)


def _check_motion(R, t, x1, x2, valid, f2):
    """Triangulate all points under (R,t) and count accepted ones.

    Returns (n_good, pts3d (N,3), good (N,))."""
    T1 = jnp.eye(4, dtype=R.dtype)
    T2 = lie.se3(R, t)
    ray1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    ray2 = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    pts = triangulation.triangulate_dlt(
        T1[None], T2[None], ray1, ray2
    )
    inv_sigma = jnp.sqrt(f2)
    ok, cos_par = triangulation.triangulation_checks(
        T1[None], T2[None], ray1, ray2, pts,
        min_parallax_cos=0.9998,  # ~1.15 deg, reference CheckRT gate
        max_reproj_err2=4.0 * CHI2_H,
        inv_sigma1=inv_sigma, inv_sigma2=inv_sigma,
    )
    ok = ok & valid
    return jnp.sum(ok.astype(jnp.int32)), pts, ok


@functools.partial(jax.jit, static_argnames=("iters", "min_triangulated"))
def reconstruct_two_views(
    cam_params: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    iters: int = 200,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full monocular initialization from matched undistorted pixel pairs.

    Mirrors GeometricCamera::ReconstructWithTwoViews →
    TwoViewReconstruction::Reconstruct semantics; returns view-2 pose with
    unit-norm translation and triangulated points in the view-1 frame."""
    x1 = _normalize(cam_params, uv1)
    x2 = _normalize(cam_params, uv2)
    f2 = cam_params[0] * cam_params[1]  # fx*fy ~ focal^2 scale for chi2
    validf = valid.astype(x1.dtype)

    kE, kH = jax.random.split(key)
    idxE = _sample_minimal_sets(kE, valid, iters, 8)
    idxH = _sample_minimal_sets(kH, valid, iters, 4)

    E_all = _fit_E_batch(x1[idxE], x2[idxE])
    H_all = _fit_H_batch(x1[idxH], x2[idxH])

    scE, inE = _score_E(E_all, x1, x2, validf, f2)
    scH, inH = _score_H(H_all, x1, x2, validf, f2)

    bestE = jnp.argmax(scE)
    bestH = jnp.argmax(scH)
    SF = scE[bestE]
    SH = scH[bestH]
    use_H = SH / jnp.maximum(SH + SF, 1e-9) > 0.40

    RsE, tsE = _decompose_E(E_all[bestE])
    RsH, tsH = _decompose_H(H_all[bestH])
    Rs = jnp.concatenate([RsE, RsH])   # (12,3,3)
    ts = jnp.concatenate([tsE, tsH])   # (12,3)
    # mask motions of the unselected model
    motion_ok = jnp.concatenate(
        [jnp.full(4, ~use_H), jnp.full(8, use_H)]
    )

    n_good, pts_all, good_all = jax.vmap(
        lambda R, t: _check_motion(R, t, x1, x2, valid, f2)
    )(Rs, ts)
    n_good = jnp.where(motion_ok, n_good, -1)

    best = jnp.argmax(n_good)
    n_best = n_good[best]
    # winner must dominate: second-best below 75% (reference's clear-winner
    # rule in ReconstructF/H) and enough points
    n_sorted = jnp.sort(n_good)
    n_second = n_sorted[-2]
    success = (n_best >= min_triangulated) & (
        n_second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32)
    )

    Tcw2 = lie.se3(Rs[best], ts[best])
    return TwoViewResult(
        success=success,
        Tcw2=Tcw2,
        pts3d=pts_all[best],
        is_triangulated=good_all[best],
        used_homography=use_H,
        n_good=n_best,
    )
