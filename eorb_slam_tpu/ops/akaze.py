"""AKAZE features as fixed-shape JAX: nonlinear diffusion scale space, Hessian
detection, and MLDB binary descriptors.

Capability equivalent of the reference's AKAZE channel (``AKAZEextractor``
wrapping ``cv::AKAZE``, src/MixedFrame.cpp, include/MixedFrame.h:27-58) used
by the "mixed" feature mode (``Features.mode: 2``,
Examples/Event/EvETHZ.yaml:110). Not a port of OpenCV: each stage is chosen
for XLA —

- the nonlinear scale space runs a fixed number of explicit Perona-Malik
  (g2 conductivity) diffusion steps per pyramid level: static iteration
  counts instead of OpenCV's data-dependent FED cycles, every step a fused
  stencil (conv + elementwise) that XLA pipelines in VMEM;
- the contrast parameter k is a gradient-energy statistic of the image
  (fixed-point formula, no histogram percentile — no dynamic shapes);
- detection is the scale-normalized determinant-of-Hessian with 3x3 NMS +
  the shared grid-uniform selector (ops/fast.select_grid);
- MLDB samples a rotated 24x24 patch per keypoint (one gather), mean-pools
  it into 2x2 / 3x3 / 4x4 grids over three channels (intensity, rotated
  gradient dx', dy'), and compares all intra-grid cell pairs: 486 bits,
  subsampled to 256 with a fixed seed — exactly OpenCV's
  ``descriptor_size`` random-bit-subset mechanism — so descriptors pack
  into the same (K,8) uint32 / ±1-int8 layout the matmul Hamming matcher uses.

Levels are mapped onto the ORB pyramid-level convention (1.2^l), the same
normalization the reference's MixedFrame does for octave bookkeeping
(include/MixedFrame.h:126-155).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.ops import fast, orb, pyramid


# --------------------------------------------------------- derivatives


def _scharr(img: jnp.ndarray):
    """Scharr x/y first derivatives (AKAZE's derivative filter)."""
    kx = np.asarray([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32.0
    ky = kx.T
    return _conv2(img, kx), _conv2(img, ky)


def _conv2(img: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Small 2-D correlation as static-slice shift-and-fma instead of a
    C=1 lax.conv (see pyramid.gaussian_blur)."""
    k = np.asarray(k)  # kernels must be host constants (see _scharr)
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    x = jnp.pad(img, ((ph, ph), (pw, pw)))
    out = jnp.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            kv = float(k[i, j])
            if kv == 0.0:
                continue
            out = out + kv * jax.lax.dynamic_slice(x, (i, j), (h, w))
    return out


# ------------------------------------------------- nonlinear scale space


def contrast_k(img: jnp.ndarray) -> jnp.ndarray:
    """Contrast factor for the g2 conductivity. AKAZE uses the 70th
    percentile of gradient magnitudes; a percentile is a dynamic-shape sort,
    so use the equivalent-scale statistic sqrt(2 E[|grad|^2]) over
    significant gradients — a fixed-shape reduction."""
    gx, gy = _scharr(pyramid.gaussian_blur(img, ksize=5, sigma=1.0))
    m2 = gx * gx + gy * gy
    w = (m2 > 1e-6).astype(jnp.float32)
    mean = jnp.sum(m2 * w) / jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sqrt(2.0 * mean) + 1e-6


def diffuse(img: jnp.ndarray, k: jnp.ndarray, steps: int,
            dt: float = 0.2) -> jnp.ndarray:
    """`steps` explicit Perona-Malik steps with g2 conductivity
    (dt <= 0.25 for stability). One lax.scan, each step a fused stencil."""

    def step(L, _):
        gx, gy = _scharr(L)
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))
        # divergence of g * grad(L) with axis-aligned half-point fluxes
        gl = jnp.pad(L, ((0, 0), (1, 1)), mode="edge")
        gu = jnp.pad(L, ((1, 1), (0, 0)), mode="edge")
        gpx = jnp.pad(g, ((0, 0), (1, 1)), mode="edge")
        gpy = jnp.pad(g, ((1, 1), (0, 0)), mode="edge")
        flux_e = 0.5 * (gpx[:, 2:] + g) * (gl[:, 2:] - L)
        flux_w = 0.5 * (gpx[:, :-2] + g) * (gl[:, :-2] - L)
        flux_s = 0.5 * (gpy[2:, :] + g) * (gu[2:, :] - L)
        flux_n = 0.5 * (gpy[:-2, :] + g) * (gu[:-2, :] - L)
        return L + dt * (flux_e + flux_w + flux_s + flux_n), None

    L, _ = jax.lax.scan(step, img, None, length=steps)
    return L


def nonlinear_scale_space(
    img: jnp.ndarray, n_levels: int = pyramid.N_LEVELS,
    steps_per_level: int = 6,
) -> list[jnp.ndarray]:
    """Per-pyramid-level nonlinearly-diffused images: level l is the 1.2^l
    downscale diffused `steps_per_level` more steps than level l-1 (edges
    survive, flat regions smooth — the AKAZE property the linear Gaussian
    pyramid lacks)."""
    levels = pyramid.build_pyramid(img, n_levels)
    k = contrast_k(img)
    out = []
    L = None
    for l, base in enumerate(levels):
        if L is None:
            L = diffuse(base, k, steps_per_level)
        else:
            # seed from the previous diffused level, downscaled
            seed = jax.image.resize(L, base.shape, "linear")
            L = diffuse(seed, k, steps_per_level)
        out.append(L)
    return out


# -------------------------------------------------------------- detection


def hessian_response(L: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Scale-normalized determinant of Hessian (AKAZE's detector)."""
    gx, gy = _scharr(L)
    Lxx, Lxy = _scharr(gx)
    _, Lyy = _scharr(gy)
    return (sigma**4) * (Lxx * Lyy - Lxy * Lxy)


# ------------------------------------------------------------ descriptors

_PATCH = 24           # sampled patch side (level pixels)
_GRIDS = (2, 3, 4)    # MLDB subdivision grids
_N_RAW_BITS = sum(3 * g * g * (g * g - 1) // 2 for g in _GRIDS)  # 486


@functools.lru_cache()
def _mldb_layout():
    """Static sampling offsets + cell ids per grid, and the fixed random
    256-bit subset (OpenCV AKAZE_MLDB descriptor_size semantics)."""
    half = _PATCH / 2.0
    ys, xs = np.mgrid[0:_PATCH, 0:_PATCH]
    offs = np.stack([xs - half + 0.5, ys - half + 0.5], axis=-1).reshape(-1, 2)
    cells = []
    for g in _GRIDS:
        cell = np.minimum((offs + half) // (_PATCH / g), g - 1)
        cells.append((cell[:, 1] * g + cell[:, 0]).astype(np.int32))
    pairs = []
    for g in _GRIDS:
        n = g * g
        pairs.append(np.asarray(
            [(i, j) for i in range(n) for j in range(i + 1, n)], np.int32
        ))
    rng = np.random.default_rng(42)
    subset = np.sort(rng.choice(_N_RAW_BITS, 256, replace=False)).astype(
        np.int32
    )
    return offs.astype(np.float32), cells, pairs, subset


def mldb_describe(
    L: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """(N,8) uint32 MLDB-256 descriptors from one diffused level."""
    offs, cells, pairs, subset = _mldb_layout()
    offs = jnp.asarray(offs)                           # (S,2)
    ca, sa = jnp.cos(angle), jnp.sin(angle)            # (N,)

    rx = ca[:, None] * offs[None, :, 0] - sa[:, None] * offs[None, :, 1]
    ry = sa[:, None] * offs[None, :, 0] + ca[:, None] * offs[None, :, 1]
    h, w = L.shape
    xx = jnp.clip(jnp.round(xy[:, 0:1] + rx).astype(jnp.int32), 0, w - 1)
    yy = jnp.clip(jnp.round(xy[:, 1:2] + ry).astype(jnp.int32), 0, h - 1)
    val = L[yy, xx]                                    # (N,S) intensity
    gx_im, gy_im = _scharr(L)
    gx = gx_im[yy, xx]
    gy = gy_im[yy, xx]
    # rotate gradients into the keypoint frame
    dx = ca[:, None] * gx + sa[:, None] * gy
    dy = -sa[:, None] * gx + ca[:, None] * gy
    chans = jnp.stack([val, dx, dy], axis=1)           # (N,3,S)

    bits = []
    for g, cell_id, pr in zip(_GRIDS, cells, pairs):
        n_cells = g * g
        cid = jnp.asarray(cell_id)                     # (S,)
        one_hot = jax.nn.one_hot(cid, n_cells, dtype=L.dtype)   # (S,C)
        counts = one_hot.sum(axis=0)                   # (C,)
        means = jnp.einsum("nks,sc->nkc", chans, one_hot) / counts  # (N,3,C)
        pi = jnp.asarray(pr)                           # (P,2)
        cmp = means[..., pi[:, 0]] > means[..., pi[:, 1]]           # (N,3,P)
        bits.append(cmp.reshape(cmp.shape[0], -1))
    raw = jnp.concatenate(bits, axis=1)                # (N,486)
    sel = raw[:, jnp.asarray(subset)].astype(jnp.uint32)            # (N,256)

    packed = sel.reshape(-1, orb.DESC_WORDS, 32)
    weights = 1 << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(packed * weights[None, None, :], axis=-1,
                   dtype=jnp.uint32)


def gradient_orientation(L: jnp.ndarray, xy: jnp.ndarray,
                         radius: int = 6) -> jnp.ndarray:
    """Dominant gradient direction in a disk window (AKAZE's main
    orientation, simplified from the sliding-wedge vote to the
    Gaussian-weighted gradient mean — same first moment)."""
    gx_im, gy_im = _scharr(L)
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    keep = (xs**2 + ys**2) <= radius * radius
    w_np = np.exp(-(xs**2 + ys**2) / (2.0 * (0.5 * radius) ** 2)) * keep
    offs = np.stack([xs[keep], ys[keep]], axis=-1)
    wv = jnp.asarray(w_np[keep], jnp.float32)
    h, w = L.shape
    xx = jnp.clip(xy[:, 0:1].astype(jnp.int32) + offs[None, :, 0], 0, w - 1)
    yy = jnp.clip(xy[:, 1:2].astype(jnp.int32) + offs[None, :, 1], 0, h - 1)
    mx = jnp.sum(gx_im[yy, xx] * wv[None, :], axis=1)
    my = jnp.sum(gy_im[yy, xx] * wv[None, :], axis=1)
    return jnp.arctan2(my, mx)


# ------------------------------------------------------------- extraction


@functools.partial(
    jax.jit,
    static_argnames=("max_kp", "n_levels", "cell", "per_cell",
                     "steps_per_level"),
)
def extract_akaze(
    img: jnp.ndarray,
    max_kp: int = 512,
    n_levels: int = pyramid.N_LEVELS,
    threshold: float = 1e-4,
    cell: int = 32,
    per_cell: int = 5,
    steps_per_level: int = 6,
):
    """img (H,W) float32 [0,255] -> frontend.Features with MLDB-256
    descriptors (same fixed-capacity layout as ORB extraction)."""
    from eorb_slam_tpu.ops import frontend

    img = img / 255.0  # diffusion stability + threshold scale
    space = nonlinear_scale_space(img, n_levels, steps_per_level)
    quotas = frontend.level_quotas(max_kp, n_levels)
    scales = pyramid.scale_factors(n_levels)

    parts = []
    for l, (L, quota) in enumerate(zip(space, quotas)):
        if quota <= 0:
            continue
        resp = hessian_response(L, sigma=1.0 + 0.4 * l)
        resp = fast.nms3x3(jnp.where(resp > threshold, resp, 0.0))
        xy, r, valid = fast.select_grid(
            resp, None, cell=cell, per_cell=per_cell, max_kp=quota,
            border=_PATCH // 2 + 2,
        )
        ang = gradient_orientation(L, xy)
        desc = mldb_describe(L, xy, ang)
        parts.append(dict(
            xy=xy * scales[l], angle=ang,
            octave=jnp.full(quota, l, jnp.int32),
            response=r, desc=desc, valid=valid,
        ))

    cat = {k: jnp.concatenate([p[k] for p in parts]) for k in parts[0]}
    desc_pm1 = orb.unpack_pm1(cat["desc"])
    desc_pm1 = desc_pm1 * cat["valid"][:, None].astype(jnp.int8)
    return frontend.Features(
        cat["xy"], cat["angle"], cat["octave"], cat["response"],
        cat["desc"], desc_pm1, cat["valid"],
    )
