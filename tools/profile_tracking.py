"""Stage-level timing of the per-frame tracking chain on the current device.

Each stage is jitted separately and timed steady-state
(block_until_ready); a no-op jit gives the per-call dispatch and sync floor
that every stage time includes. Host-clock times: run it on the card.

Run: python tools/profile_tracking.py
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from eorb_slam_tpu.geometry import camera as cam_mod
from eorb_slam_tpu.ops import fast, frontend, orb, pyramid
from eorb_slam_tpu.slam import tracking


def timeit(fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1000.0


def main():
    dev = jax.devices()[0]
    cam, img8, m = bench.make_tracking_inputs()
    cam = jax.device_put(cam, dev)
    img8 = jax.device_put(img8, dev)
    m = jax.device_put(m, dev)
    T0 = jax.device_put(jnp.eye(4), dev)

    noop = jax.jit(lambda x: x + 1)
    print(f"dispatch_floor_ms {timeit(noop, jnp.zeros(()), reps=50):.2f}")

    # full chain (the bench number)
    @jax.jit
    def chain(img, m, T):
        feats = frontend.extract(img, max_kp=512)
        xy_ud = cam_mod.undistort_points(cam, feats.xy)
        res = tracking.track_frame(
            m, cam, xy_ud, feats.octave, feats.desc_pm1, feats.valid, T,
            img_w=752, img_h=480)
        return res.Tcw, res.n_inliers
    print(f"full_chain_ms {timeit(chain, img8, m, T0):.2f}")

    # extract alone
    ext = jax.jit(lambda img: frontend.extract(img, max_kp=512))
    print(f"extract_ms {timeit(ext, img8):.2f}")

    feats = jax.block_until_ready(ext(img8))
    xy_ud = cam_mod.undistort_points(cam, feats.xy)

    # track_frame alone
    tf = jax.jit(functools.partial(tracking.track_frame, img_w=752, img_h=480))
    print(f"track_frame_ms {timeit(tf, m, cam, xy_ud, feats.octave, feats.desc_pm1, feats.valid, T0):.2f}")

    # extract internals
    imgf = img8.astype(jnp.float32)
    pyr = jax.jit(lambda im: pyramid.build_pyramid(im.astype(jnp.float32), 8))
    print(f"pyramid_ms {timeit(pyr, img8):.2f}")

    levels = jax.block_until_ready(pyr(img8))
    quotas = frontend.level_quotas(512, 8)

    def det_all(levels):
        outs = []
        for l, (im, q) in enumerate(zip(levels, quotas)):
            if q <= 0:
                continue
            outs.append(fast.detect_grid(im, max_kp=q, border=orb.PATCH_R + 1))
        return outs
    det = jax.jit(det_all)
    print(f"fast_all_levels_ms {timeit(det, levels):.2f}")

    def score_only(levels):
        return [fast.nms3x3(fast.fast_score(im, 20.0)) for im in levels]
    print(f"fast_score_all_ms {timeit(jax.jit(score_only), levels):.2f}")

    def orient_desc(levels, dets):
        outs = []
        for im, (xy, r, v) in zip(levels, dets):
            ang = orb.orientations(im, xy)
            blur = pyramid.gaussian_blur(im)
            outs.append(orb.describe(blur, xy, ang))
        return outs
    dets = jax.block_until_ready(det(levels))
    print(f"orient_desc_all_ms {timeit(jax.jit(orient_desc), levels, dets):.2f}")

    def blur_all(levels):
        return [pyramid.gaussian_blur(im) for im in levels]
    print(f"blur_all_ms {timeit(jax.jit(blur_all), levels):.2f}")

    # track_frame internals: projection+masks vs matching vs pose opt
    from eorb_slam_tpu.ops import matching
    from eorb_slam_tpu.optim import pose_only

    @jax.jit
    def match_only(m, xy_ud, desc, valid):
        dist = matching.hamming_matrix(desc, m.lm_desc_pm1)
        return dist.sum()
    print(f"hamming_512x4096_ms {timeit(match_only, m, xy_ud, feats.desc_pm1, feats.valid):.2f}")

    res = jax.block_until_ready(tf(m, cam, xy_ud, feats.octave,
                                   feats.desc_pm1, feats.valid, T0))
    matched = res.feat_lm >= 0
    pts_w = m.lm_pos[jnp.where(matched, res.feat_lm, 0)]

    po = jax.jit(lambda T, p, uv, s, v: pose_only.pose_optimization(
        cam, T, p, uv, s, v))
    print(f"pose_opt_ms {timeit(po, T0, pts_w, xy_ud, frontend.inv_sigma(feats.octave), matched):.2f}")


if __name__ == "__main__":
    main()
