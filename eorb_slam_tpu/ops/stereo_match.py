"""Rectified stereo feature matching → per-feature metric depth.

Equivalent of ``Frame::ComputeStereoMatches`` (reference
src/Frame.cc: per-left-keypoint row-band search in the right image,
descriptor distance + SAD subpixel refinement, depth = fx·b/disparity).
Here the row-band + disparity-band admissibility is a dense (Nl,Nr) pair
mask over the descriptor Hamming matrix — one int8 matmul — and the
subpixel stage is folded into the descriptor NN choice (no image patches at
this level; descriptor NN over FAST corners localizes to ~the same cell).

RGB-D "virtual right coordinate" (reference ``Frame::ComputeStereoFromRGBD``)
is synthesized the same way the reference does: u_right = u − fx·b/d.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eorb_slam_tpu.ops import matching


@functools.partial(jax.jit, static_argnames=())
def stereo_match(
    xy_l: jnp.ndarray,       # (Nl,2) undistorted left keypoints
    oct_l: jnp.ndarray,      # (Nl,)
    desc_l: jnp.ndarray,     # (Nl,256) int8 ±1
    valid_l: jnp.ndarray,    # (Nl,)
    xy_r: jnp.ndarray,       # (Nr,2) undistorted right keypoints
    oct_r: jnp.ndarray,
    desc_r: jnp.ndarray,
    valid_r: jnp.ndarray,
    fx,
    baseline,
    min_depth: float = 0.3,
    max_depth: float = 60.0,
):
    """Returns (depth (Nl,), u_right (Nl,), matched (Nl,) bool).

    depth < 0 where unmatched. Admissible pairs: same pyramid level ±1,
    |row difference| ≤ 2·1.2^octave px, disparity within the depth band.
    """
    bf = fx * baseline
    min_disp = bf / max_depth
    max_disp = bf / min_depth

    row_tol = 2.0 * 1.2 ** oct_l.astype(jnp.float32)             # (Nl,)
    d_row = jnp.abs(xy_l[:, None, 1] - xy_r[None, :, 1])          # (Nl,Nr)
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]                    # (Nl,Nr)
    oct_ok = jnp.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    pair = (
        (d_row <= row_tol[:, None])
        & (disp >= min_disp)
        & (disp <= max_disp)
        & oct_ok
    )

    m_lr, dist = matching.match_nnratio(
        desc_l, valid_l, desc_r, valid_r,
        pair_mask=pair, max_dist=matching.TH_HIGH, nn_ratio=0.9, mutual=True,
    )
    matched = m_lr >= 0

    # distance-statistic pruning (reference ComputeStereoMatches' final
    # pass: discard matches with dist > 1.5*1.4*median over the matched
    # set, src/Frame.cc) — kills epipolar aliases on repetitive texture
    d_sorted = jnp.sort(jnp.where(matched, dist, matching.BIG))
    n_m = jnp.sum(matched)
    med = d_sorted[jnp.clip(n_m // 2, 0, dist.shape[0] - 1)]
    matched = matched & (dist <= 1.5 * 1.4 * jnp.maximum(med, 1))

    idx_r = jnp.where(matched, m_lr, 0)
    disp_m = xy_l[:, 0] - xy_r[idx_r, 0]
    ok = matched & (disp_m > 1e-3)
    depth = jnp.where(ok, bf / jnp.maximum(disp_m, 1e-3), -1.0)
    u_right = jnp.where(ok, xy_r[idx_r, 0], -1.0)
    return depth, u_right, ok


def depth_from_depthmap(
    xy: jnp.ndarray,          # (N,2) keypoint coords (pixel)
    depth_map: jnp.ndarray,   # (H,W) metric depth, <=0 = invalid
    valid: jnp.ndarray,       # (N,)
):
    """RGB-D depth lookup at keypoint locations (reference
    Frame::ComputeStereoFromRGBD reads mImDepth at the keypoint)."""
    H, W = depth_map.shape
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_map[yi, xi]
    ok = valid & (d > 0) & jnp.isfinite(d)
    return jnp.where(ok, d, -1.0), ok
