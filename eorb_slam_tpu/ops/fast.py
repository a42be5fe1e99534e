"""Dense vectorized FAST-9/16 corner detection + grid-uniform selection.

Re-design of the reference's per-cell OpenCV FAST calls and
quad-tree keypoint distribution (reference src/ORBextractor.cc
ComputeKeyPointsOctTree / DistributeOctTree): instead of dynamic trees,
we compute a dense corner-score map with whole-image vector ops, apply
3x3 NMS, then take the top-K response per fixed grid cell — which yields
the same spatially-uniform distribution the quad-tree is for, with fully
static shapes.

FAST semantics follow the standard definition (segment test, 16-pixel
Bresenham circle of radius 3, arc length >= 9). The score is OpenCV's:
max threshold for which the pixel stays a corner (computed in closed form
from arc min/max rather than by binary search).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle radius 3 (dy, dx), OpenCV pixel order (starting top, clockwise)
CIRCLE = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
ARC = 9
BORDER = 3


def _circle_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(H,W,16): the 16 circle neighbors of every pixel (zero border junk)."""
    shifts = []
    for dy, dx in CIRCLE:
        shifts.append(jnp.roll(img, (-dy, -dx), axis=(0, 1)))
    return jnp.stack(shifts, axis=-1)


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9 score map (H,W). 0 where not a corner.

    Score = max over valid 9-arcs of (min over arc of |neighbor-center|) - 1
    clamped at threshold — equivalent to OpenCV's "max t that keeps the
    corner" definition.
    """
    h, w = img.shape
    c = _circle_stack(img)                       # (H,W,16)
    d = c - img[..., None]                       # (H,W,16)

    # min of each 9-long circular window, via iterative pairwise min on rolls
    def arc_reduce(x, op):
        # reduce window length 9 => combine rolls 0..8
        acc = x
        for k in range(1, ARC):
            acc = op(acc, jnp.roll(x, -k, axis=-1))
        return acc

    arc_min = arc_reduce(d, jnp.minimum)         # (H,W,16) min over window starting at idx
    arc_max = arc_reduce(d, jnp.maximum)

    # bright corner: exists arc with all d > t  -> score_b = max_arc (min over arc d)
    score_bright = jnp.max(arc_min, axis=-1)
    # dark corner: exists arc with all d < -t -> score_d = max_arc (-max over arc d)
    score_dark = jnp.max(-arc_max, axis=-1)
    score = jnp.maximum(score_bright, score_dark)
    score = jnp.where(score > threshold, score, 0.0)

    # kill the border (circle reads wrapped junk there)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    return jnp.where(inb, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only local maxima in 3x3 windows."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= m, score, 0.0)


@functools.partial(
    jax.jit, static_argnames=("cell", "per_cell", "max_kp", "border")
)
def detect_grid(
    img: jnp.ndarray,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell: int = 32,
    per_cell: int = 4,
    max_kp: int = 1024,
    border: int = 16,
):
    """FAST + NMS + per-cell top-K + global top-max_kp.

    Mirrors the reference's ini/min threshold fallback (src/ORBextractor.cc:
    cells retry with minThFAST when the high threshold finds nothing):
    scores from the low threshold are used wherever the high threshold
    found nothing in a cell.

    Returns (xy (max_kp,2) float32, resp (max_kp,), valid (max_kp,) bool).
    Coordinates are (x, y) at this level's scale.
    """
    h, w = img.shape
    s_hi = nms3x3(fast_score(img, threshold))
    s_lo = nms3x3(fast_score(img, min_threshold))
    return select_grid(s_hi, s_lo, cell=cell, per_cell=per_cell,
                       max_kp=max_kp, border=border)


def select_grid(
    s_hi: jnp.ndarray,
    s_lo: jnp.ndarray | None = None,
    cell: int = 32,
    per_cell: int = 4,
    max_kp: int = 1024,
    border: int = 16,
):
    """Grid-uniform top-K selection from a response map (the quad-tree
    distribution equivalent): per-cell top-`per_cell`, then global
    top-`max_kp`. ``s_lo`` is the low-threshold fallback used in cells where
    ``s_hi`` is empty. Shared by FAST (ORB) and Hessian (AKAZE) detectors."""
    h, w = s_hi.shape

    # static grid
    gh, gw = h // cell, w // cell
    hh, ww = gh * cell, gw * cell

    def cellify(s):
        return s[:hh, :ww].reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(
            gh, gw, cell * cell
        )

    c_hi = cellify(s_hi)
    if s_lo is not None:
        c_lo = cellify(s_lo)
        has_hi = jnp.any(c_hi > 0, axis=-1, keepdims=True)
        c = jnp.where(has_hi, c_hi, c_lo)
    else:
        c = c_hi

    # mask image border margin (keypoints too close to the edge are useless
    # for descriptors; reference uses EDGE_THRESHOLD=19)
    ys = (jnp.arange(gh * cell) // cell)[:, None]
    idx_in_cell = jnp.arange(cell * cell)
    cy = idx_in_cell // cell
    cx = idx_in_cell % cell
    gy = jnp.arange(gh)[:, None, None]
    gx = jnp.arange(gw)[None, :, None]
    abs_y = gy * cell + cy[None, None, :]
    abs_x = gx * cell + cx[None, None, :]
    inb = (
        (abs_y >= border) & (abs_y < h - border)
        & (abs_x >= border) & (abs_x < w - border)
    )
    c = jnp.where(inb, c, 0.0)

    # top-k per cell
    v, i = jax.lax.top_k(c, per_cell)                       # (gh,gw,per_cell)
    kp_y = (gy * cell + (i // cell)).reshape(-1)
    kp_x = (gx * cell + (i % cell)).reshape(-1)
    resp = v.reshape(-1)

    # global top max_kp by response
    n = resp.shape[0]
    if n < max_kp:
        pad = max_kp - n
        resp = jnp.concatenate([resp, jnp.zeros(pad)])
        kp_x = jnp.concatenate([kp_x, jnp.zeros(pad, kp_x.dtype)])
        kp_y = jnp.concatenate([kp_y, jnp.zeros(pad, kp_y.dtype)])
    rv, ri = jax.lax.top_k(resp, max_kp)
    xy = jnp.stack([kp_x[ri], kp_y[ri]], axis=-1).astype(jnp.float32)
    return xy, rv, rv > 0.0
