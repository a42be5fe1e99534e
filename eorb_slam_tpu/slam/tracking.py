"""Per-frame tracking: project-match-optimize as one jitted call.

Replaces Tracking::TrackWithMotionModel + TrackLocalMap (reference
src/Tracking.cc:1816,:1924): the local-map point selection via covisibility
sets becomes a frustum + window mask over ALL landmarks — at SLAM-scale
capacities the full (N_feat x M_landmarks) Hamming matrix is a single int8
matmul, cheaper than host-side set bookkeeping.

Stages inside one jit:
 1. project all landmarks with the predicted pose,
 2. admissibility mask (valid, in front, in image, search window, octave),
 3. masked NN-ratio descriptor matching,
 4. motion-only pose optimization (4x10 GN with outlier reclassification),
 5. inlier count for the keyframe policy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.geometry import camera as cam_mod, lie
from eorb_slam_tpu.ops import frontend, matching
from eorb_slam_tpu.optim import pose_only
from eorb_slam_tpu.slam.map_state import MapState


class TrackResult(NamedTuple):
    Tcw: jnp.ndarray        # (4,4) optimized pose
    feat_lm: jnp.ndarray    # (N,) int32 landmark id per feature (-1 = none)
    inlier: jnp.ndarray     # (N,) bool — survived pose optimization
    n_matched: jnp.ndarray  # () int32 matches fed to the optimizer
    n_inliers: jnp.ndarray  # () int32


@functools.partial(jax.jit, static_argnames=("img_w", "img_h"))
def track_frame(
    m: MapState,
    cam_params: jnp.ndarray,
    xy_ud: jnp.ndarray,        # (N,2) undistorted feature coords
    octave: jnp.ndarray,       # (N,)
    desc_pm1: jnp.ndarray,     # (N,256) int8
    feat_valid: jnp.ndarray,   # (N,)
    T_pred: jnp.ndarray,       # (4,4) motion-model / predicted pose
    img_w: int = 752,
    img_h: int = 480,
    search_radius: float = 15.0,
    max_dist: int = matching.TH_HIGH,
    nn_ratio: float = 0.9,
) -> TrackResult:
    # 1. project landmarks
    pc = lie.se3_apply(T_pred, m.lm_pos)                   # (M,3)
    uv = cam_mod.pinhole_project_linear(cam_params, pc)    # (M,2)
    vis = (
        m.lm_valid
        & (pc[..., 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    )

    # 1b. landmark quality attributes ON THE FLY from the observation table
    # (MapPoint::UpdateNormalAndDepth + PredictScale + Frame::isInFrustum,
    # reference src/MapPoint.cc, src/Frame.cc): mean viewing direction,
    # scale-corrected distance-of-observation bounds, predicted pyramid
    # level. Derived per call instead of stored — never stale, no schema.
    Rk = m.kf_T[:, :3, :3]
    kf_C = -jnp.einsum("kij,kj->ki", Rk.transpose(0, 2, 1), m.kf_T[:, :3, 3])
    obs_ok = m.obs_valid & m.kf_valid[m.obs_kf]            # (M,P)
    d_obs = m.lm_pos[:, None, :] - kf_C[m.obs_kf]          # (M,P,3)
    dist_obs = jnp.linalg.norm(d_obs, axis=-1)
    oct_obs = m.kf_octave[m.obs_kf, m.obs_feat]
    level_dist = dist_obs * 1.2 ** oct_obs.astype(jnp.float32)
    dmax = jnp.max(jnp.where(obs_ok, level_dist, 0.0), axis=1)
    dmin = dmax / 1.2**7
    normal = jnp.sum(
        jnp.where(obs_ok[..., None], d_obs / (dist_obs[..., None] + 1e-9),
                  0.0), axis=1)
    normal = normal / (jnp.linalg.norm(normal, axis=-1, keepdims=True) + 1e-9)
    has_obs = obs_ok.any(axis=1) & (dmax > 1e-6)

    C_pred = -T_pred[:3, :3].T @ T_pred[:3, 3]
    v = m.lm_pos - C_pred
    dist = jnp.linalg.norm(v, axis=-1)
    cos_view = jnp.sum(v / (dist[:, None] + 1e-9) * normal, axis=-1)
    in_range = (dist >= 0.8 * dmin) & (dist <= 1.3 * dmax) & (cos_view > 0.5)
    vis = vis & (~has_obs | in_range)
    # predicted level at the current distance (PredictScale)
    pred_level = jnp.clip(
        jnp.floor(jnp.log(jnp.maximum(dmax, 1e-6) / jnp.maximum(dist, 1e-6))
                  / np.log(1.2) + 0.5), 0, 7).astype(jnp.int32)

    # 2. admissible pairs: window scaled by feature octave (coarser level ->
    # larger window, reference ORBmatcher::SearchByProjection radius*scale),
    # and the feature's pyramid level must match the predicted one +-1
    scale = 1.2 ** octave.astype(jnp.float32)
    r = search_radius * scale                               # (N,)
    d2 = jnp.sum((xy_ud[:, None, :] - uv[None, :, :]) ** 2, axis=-1)
    level_ok = (
        jnp.abs(octave[:, None] - pred_level[None, :]) <= 1
    ) | ~has_obs[None, :]
    pair = (d2 <= (r[:, None] ** 2)) & vis[None, :] & level_ok

    # 3. matching
    feat_lm, dist = matching.match_nnratio(
        desc_pm1,
        feat_valid,
        m.lm_desc_pm1,
        vis,
        pair_mask=pair,
        max_dist=max_dist,
        nn_ratio=nn_ratio,
        mutual=False,
    )
    matched = feat_lm >= 0

    # drop duplicate matches to the same landmark (keep best distance):
    # compute per-landmark min distance and keep only the argmin feature
    lm_safe = jnp.where(matched, feat_lm, 0)
    INF = jnp.asarray(matching.BIG, dist.dtype)
    per_lm_best = jnp.full((m.M,), INF).at[lm_safe].min(
        jnp.where(matched, dist, INF)
    )
    keep = matched & (dist <= per_lm_best[lm_safe])
    feat_lm = jnp.where(keep, feat_lm, -1)
    matched = keep

    # 4. pose optimization over the matched subset
    pts_w = m.lm_pos[jnp.where(matched, feat_lm, 0)]
    inv_sigma = frontend.inv_sigma(octave)
    Tcw, inlier, n_inl = pose_only.pose_optimization(
        cam_params, T_pred, pts_w, xy_ud, inv_sigma, matched
    )

    feat_lm = jnp.where(inlier, feat_lm, -1)
    return TrackResult(
        Tcw=Tcw,
        feat_lm=feat_lm,
        inlier=inlier,
        n_matched=jnp.sum(matched.astype(jnp.int32)),
        n_inliers=n_inl,
    )


@functools.partial(
    jax.jit, static_argnames=("max_kp", "img_w", "img_h")
)
def track_image_frame(
    img: jnp.ndarray,          # (H,W) uint8/float
    cam_params: jnp.ndarray,
    m: MapState,
    velocity: jnp.ndarray,     # (4,4) motion model
    T_last: jnp.ndarray,       # (4,4)
    ref_T: jnp.ndarray,        # (4,4) reference KF pose (trajectory entry)
    max_kp: int = 512,
    img_w: int = 752,
    img_h: int = 480,
):
    """The FULL per-frame image step as ONE dispatch: extract -> undistort
    -> motion-model predict -> project/match/pose-optimize -> packed host
    flags + relative-pose trajectory entry.

    The per-frame cost is one H2D (uint8 image), one fused program, one
    small result pull."""
    from eorb_slam_tpu.ops import frontend as fe

    feats = fe.extract(img, max_kp=max_kp)
    xy_ud = cam_mod.undistort_points(cam_params, feats.xy)
    T_pred = velocity @ T_last
    res = track_frame(
        m, cam_params, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
        T_pred, img_w=img_w, img_h=img_h,
    )
    flags = jnp.stack([
        res.n_inliers.astype(jnp.float32),
        jnp.isfinite(res.Tcw).all().astype(jnp.float32),
    ])
    vel_new = res.Tcw @ lie.se3_inv(T_last)
    T_rel = res.Tcw @ lie.se3_inv(ref_T)
    return res, feats, xy_ud, flags, vel_new, T_rel


@jax.jit
def match_for_initialization(
    desc1_pm1, valid1, xy1, desc2_pm1, valid2, xy2,
    window: float = 100.0,
):
    """Frame-to-frame matching for monocular init: spatial window + NN ratio
    0.9 + mutual check (reference ORBmatcher::SearchForInitialization)."""
    pair = matching.window_mask(xy1, xy2, window)
    return matching.match_nnratio(
        desc1_pm1, valid1, desc2_pm1, valid2,
        pair_mask=pair, max_dist=matching.TH_LOW, nn_ratio=0.9, mutual=True,
    )
