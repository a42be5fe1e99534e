"""Image pyramid + separable Gaussian blur (batched, jit-static shapes).

Replaces the reference ORBextractor's ComputePyramid (src/ORBextractor.cc):
8 levels, scale factor 1.2, bilinear downsampling, 7x7 sigma=2 Gaussian blur
before descriptor sampling.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

N_LEVELS = 8
SCALE_FACTOR = 1.2


def level_shapes(h: int, w: int, n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    """Static per-level (h, w)."""
    return [
        (max(int(round(h / scale**l)), 16), max(int(round(w / scale**l)), 16))
        for l in range(n_levels)
    ]


def scale_factors(n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    return np.asarray([scale**l for l in range(n_levels)], dtype=np.float32)


def build_pyramid(img: jnp.ndarray, n_levels: int = N_LEVELS,
                  scale: float = SCALE_FACTOR) -> list[jnp.ndarray]:
    """img (H,W) float32 in [0,255] -> list of (h_l, w_l) levels."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(
            jax.image.resize(levels[-1], shapes[l], method="bilinear")
        )
    return levels


@functools.lru_cache(maxsize=None)
def _gauss_kernel(ksize: int, sigma: float):
    # cached as numpy: jnp constants created inside a trace are tracers here
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur, replicate padding (matches cv2 BORDER_REFLECT_101
    closely enough for descriptor sampling).

    Implemented as static-slice shift-and-fma, NOT a C=1 lax.conv, which
    XLA fuses into one elementwise kernel per pass. Whether a cuDNN
    convolution beats it on the GPU is not measured yet."""
    k = _gauss_kernel(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    x = sum(k[i] * jax.lax.dynamic_slice_in_dim(x, i, h, 0)
            for i in range(ksize))
    x = jnp.pad(x, ((0, 0), (pad, pad)), mode="edge")
    x = sum(k[i] * jax.lax.dynamic_slice_in_dim(x, i, w, 1)
            for i in range(ksize))
    return x
