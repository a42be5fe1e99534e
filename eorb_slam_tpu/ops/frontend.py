"""Full ORB feature extraction: pyramid -> FAST -> orientation -> descriptors.

Equivalent of ORBextractor::operator() (reference src/ORBextractor.cc,
include/ORBextractor.h:75-81): one jitted call per image producing
fixed-capacity keypoint arrays with octave bookkeeping. Per-level keypoint
budgets follow the reference's geometric distribution (N per level
proportional to 1/scale^level).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.ops import fast, orb, pyramid


class Features(NamedTuple):
    xy: jnp.ndarray        # (K,2) float32 — level-0 pixel coords (distorted)
    angle: jnp.ndarray     # (K,) float32 radians
    octave: jnp.ndarray    # (K,) int32 pyramid level
    response: jnp.ndarray  # (K,) float32 FAST score
    desc: jnp.ndarray      # (K,8) uint32 packed rBRIEF
    desc_pm1: jnp.ndarray  # (K,256) int8 {-1,+1} for matmul matching
    valid: jnp.ndarray     # (K,) bool

    @property
    def capacity(self):
        return self.xy.shape[0]


def level_quotas(max_kp: int, n_levels: int = pyramid.N_LEVELS,
                 scale: float = pyramid.SCALE_FACTOR):
    """Per-level keypoint budgets, geometric in 1/scale (reference
    ORBextractor ctor mnFeaturesPerLevel computation)."""
    inv = 1.0 / scale
    total = (1 - inv**n_levels) / (1 - inv)
    quotas = [int(round(max_kp * inv**l / total)) for l in range(n_levels)]
    quotas[-1] = max_kp - sum(quotas[:-1])
    return quotas


# per-octave sigma^2 used for measurement information in the optimizers
def inv_sigma(octave: jnp.ndarray, scale: float = pyramid.SCALE_FACTOR):
    return (1.0 / scale) ** octave.astype(jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("max_kp", "n_levels", "cell", "per_cell")
)
def extract(
    img: jnp.ndarray,
    max_kp: int = 1024,
    n_levels: int = pyramid.N_LEVELS,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 32,
    per_cell: int = 5,
) -> Features:
    """img (H,W) [0,255] -> Features with capacity max_kp.

    Accepts uint8 or float32; cast happens ON DEVICE so callers can ship
    uint8 frames (4x less host->device traffic)."""
    img = img.astype(jnp.float32)
    levels = pyramid.build_pyramid(img, n_levels)
    quotas = level_quotas(max_kp, n_levels)
    scales = pyramid.scale_factors(n_levels)

    parts = []
    for l, (img_l, quota) in enumerate(zip(levels, quotas)):
        if quota <= 0:
            continue
        xy, resp, valid = fast.detect_grid(
            img_l,
            threshold=threshold,
            min_threshold=min_threshold,
            cell=cell,
            per_cell=per_cell,
            max_kp=quota,
            border=orb.PATCH_R + 1,
        )
        ang = orb.orientations(img_l, xy)
        blur = pyramid.gaussian_blur(img_l)
        desc = orb.describe(blur, xy, ang)
        parts.append(
            dict(
                xy=xy * scales[l],
                angle=ang,
                octave=jnp.full(quota, l, jnp.int32),
                response=resp,
                desc=desc,
                valid=valid,
            )
        )

    xy = jnp.concatenate([p["xy"] for p in parts])
    angle = jnp.concatenate([p["angle"] for p in parts])
    octave = jnp.concatenate([p["octave"] for p in parts])
    response = jnp.concatenate([p["response"] for p in parts])
    desc = jnp.concatenate([p["desc"] for p in parts])
    valid = jnp.concatenate([p["valid"] for p in parts])
    desc_pm1 = orb.unpack_pm1(desc)
    # zero invalid descriptors so matmul matching can't pick them up via
    # accidental agreement (their distance is forced by the valid mask too)
    desc_pm1 = desc_pm1 * valid[:, None].astype(jnp.int8)
    return Features(xy, angle, octave, response, desc, desc_pm1, valid)


def extract_mixed(
    img: jnp.ndarray,
    max_kp: int = 1024,
    orb_frac: float = 0.5,
    **akaze_kw,
):
    """Mixed ORB + AKAZE extraction (reference MixedFrame, Features.mode 2,
    include/MixedFrame.h:60-209): one fixed-capacity Features whose first
    ``round(orb_frac*max_kp)`` slots are ORB keypoints and the rest AKAZE
    (MLDB-256), plus a (K,) int32 channel array (0=ORB, 1=AKAZE).

    Slot-partitioning replaces the reference's per-point descriptor-type
    dispatch: channels are index-determined, and cross-channel descriptor
    confusion is statistically nil (random 256-bit Hamming ~ N(128, 8), ten
    sigma from any match threshold) — the reference separates them only
    because ORB (32 B) and MLDB (61 B) buffers differ mechanically."""
    from eorb_slam_tpu.ops import akaze

    n_orb = int(round(max_kp * orb_frac))
    n_ak = max_kp - n_orb
    f_orb = extract(img, max_kp=n_orb)
    f_ak = akaze.extract_akaze(img, max_kp=n_ak, **akaze_kw)
    cat = Features(*[
        jnp.concatenate([a, b]) for a, b in zip(f_orb, f_ak)
    ])
    channel = jnp.concatenate([
        jnp.zeros(n_orb, jnp.int32), jnp.ones(n_ak, jnp.int32)
    ])
    return cat, channel
