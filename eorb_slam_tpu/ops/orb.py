"""Oriented BRIEF descriptors: intensity-centroid orientation + steered
binary tests, bit-packed to 8x uint32 per keypoint.

Re-design of the reference ORBextractor's IC_Angle + computeOrbDescriptor
(src/ORBextractor.cc): everything is a batched gather + vector ops over all
keypoints at once, no per-keypoint loops.

The 256-pair sampling pattern is generated deterministically from a fixed
seed following the ORB paper's recipe (Gaussian-distributed test locations
within the 31x31 patch). It intentionally does NOT reproduce OpenCV's
learned bit pattern — descriptors are internally consistent across this
framework (extractor, matcher, vocabulary), which is the property the
pipeline needs; cross-library descriptor equality is not.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH_R = 15          # orientation patch radius (31x31), as in the reference
DESC_BITS = 256
DESC_WORDS = 8        # uint32 words


@functools.lru_cache(maxsize=None)
def _orientation_mask():
    """Circular mask + coordinate grids for the 31x31 orientation patch.

    Cached as NUMPY arrays: jnp array creation inside a jit trace yields
    tracers in this JAX version, and caching those leaks them across traces."""
    r = PATCH_R
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (ys**2 + xs**2 <= r**2).astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234):
    """(256,4) int32 test pairs (x1,y1,x2,y2), Gaussian sigma=patch/5, clipped."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_R + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(DESC_BITS, 4))
    pts = np.clip(np.round(pts), -PATCH_R + 2, PATCH_R - 2).astype(np.int32)
    # avoid degenerate identical pairs
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts  # numpy on purpose: see _orientation_mask


def gather_patches(img: jnp.ndarray, xy: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Gather (N, 2r+1, 2r+1) patches centered at integer keypoints xy (N,2).

    Out-of-bounds reads clamp to the image edge (keypoints are kept inside
    a border margin by the detector, so this only affects invalid slots)."""
    h, w = img.shape
    x = jnp.clip(xy[:, 0].astype(jnp.int32), radius, w - 1 - radius)
    y = jnp.clip(xy[:, 1].astype(jnp.int32), radius, h - 1 - radius)
    dy = jnp.arange(-radius, radius + 1)
    dx = jnp.arange(-radius, radius + 1)
    yy = y[:, None, None] + dy[None, :, None]
    xx = x[:, None, None] + dx[None, None, :]
    return img[yy, xx]


def orientations(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle (radians) per keypoint (N,)."""
    mask, mx, my = _orientation_mask()
    patches = gather_patches(img, xy, PATCH_R)          # (N,31,31)
    m10 = jnp.sum(patches * mx, axis=(-2, -1))
    m01 = jnp.sum(patches * my, axis=(-2, -1))
    return jnp.arctan2(m01, m10)


def describe(
    img_blur: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """Steered-BRIEF descriptors (N, 8) uint32 from a blurred image level.

    Pattern points are rotated by each keypoint's angle and sampled with
    nearest-neighbor reads (same as the reference's integer rounding)."""
    pat = brief_pattern().astype(jnp.float32)            # (256,4)
    ca, sa = jnp.cos(angle), jnp.sin(angle)              # (N,)

    def rot(px, py):
        # (N,256) rotated offsets
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return jnp.round(rx).astype(jnp.int32), jnp.round(ry).astype(jnp.int32)

    h, w = img_blur.shape
    x0 = xy[:, 0].astype(jnp.int32)[:, None]
    y0 = xy[:, 1].astype(jnp.int32)[:, None]

    def sample(dx, dy):
        xx = jnp.clip(x0 + dx, 0, w - 1)
        yy = jnp.clip(y0 + dy, 0, h - 1)
        return img_blur[yy, xx]                          # (N,256)

    rx1, ry1 = rot(pat[:, 0], pat[:, 1])
    rx2, ry2 = rot(pat[:, 2], pat[:, 3])
    bits = (sample(rx1, ry1) < sample(rx2, ry2)).astype(jnp.uint32)  # (N,256)

    # pack 256 bits -> 8 uint32 (little-endian within each word)
    bits = bits.reshape(-1, DESC_WORDS, 32)
    weights = (1 << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights[None, None, :], axis=-1, dtype=jnp.uint32)


def unpack_pm1(desc: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """(N,8) uint32 -> (N,256) in {-1,+1}: Hamming distance becomes a matmul.

    d_ham(a,b) = (256 - a_pm1 . b_pm1) / 2 — this is how the matcher runs
    as one int8 matmul instead of XOR+popcount scalar loops."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (bits.astype(jnp.int32) * 2 - 1).astype(dtype)
