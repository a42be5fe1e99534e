"""Event tensorization: Gaussian-splat histograms, motion-compensated
images (MCI), and contrast/focus metrics.

Replacement for ``EvImConverter`` (reference
src/Event/EventConversion.cc:215-269 ev2im_gauss, :280-534 ev2mci_gg_f
overloads, :74-119 focus metrics). Events are fixed-shape ``(N,4)`` float
tensors ``[ts, x, y, p]`` with validity masks; each event adds a truncated
2D Gaussian to the accumulator, computed as one separable contraction
(no data-dependent shapes, fully jittable).

The splat is DIFFERENTIABLE w.r.t. the warped event coordinates, which is
what makes contrast maximization a plain jitted gradient ascent instead of
the reference's Ceres ``GradientProblemSolver`` (reference
src/Event/EvOptimizer.cpp:46-201).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.geometry import lie


def _splat_gauss_separable(
    xy: jnp.ndarray, w_ev: jnp.ndarray, H: int, W: int,
    sigma: float, trunc: float,
) -> jnp.ndarray:
    """Separable-Gaussian splat as two weight matrices + ONE matmul.

    G(dx,dy) = gx(dx)·gy(dy), so the accumulated image is exactly
    ``A^T B`` with A[n,h] = w_n·gy(h−y_n), B[n,w] = gx(w−x_n) — a single
    (H,N)×(N,W) contraction instead of N·S² scatter-adds. Out-of-image
    events contribute nothing because their row/col windows are empty.
    """
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    dy = jnp.arange(H, dtype=xy.dtype)[None, :] - xy[:, 1:2]      # (N,H)
    dx = jnp.arange(W, dtype=xy.dtype)[None, :] - xy[:, 0:1]      # (N,W)
    A = jnp.exp(-dy * dy * inv2s2) * (jnp.abs(dy) <= trunc)
    A = A * w_ev[:, None]
    B = jnp.exp(-dx * dx * inv2s2) * (jnp.abs(dx) <= trunc)
    return jax.lax.dot_general(
        A, B, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    ).astype(xy.dtype)


@functools.partial(
    jax.jit, static_argnames=("H", "W", "sigma", "stencil", "use_polarity")
)
def splat_gauss(
    xy: jnp.ndarray,        # (N,2) continuous pixel coords of the events
    valid: jnp.ndarray,     # (N,) bool
    pol: jnp.ndarray,       # (N,) +-1 polarity
    H: int,
    W: int,
    sigma: float = 1.0,
    stencil: int = 5,
    use_polarity: bool = False,
) -> jnp.ndarray:
    """Accumulate each event as a truncated 2D Gaussian.

    Equivalent of ``EvImConverter::ev2im_gauss`` (reference
    src/Event/EventConversion.cc:215-269), computed as a separable rank-1
    accumulation (see ``_splat_gauss_separable``). Returns (H,W) float.
    Differentiable w.r.t. ``xy`` (contrast maximization backpropagates
    through the splat).
    """
    w_ev = jnp.where(use_polarity, pol, 1.0) * valid.astype(xy.dtype)
    trunc = stencil / 2.0  # matches the reference's truncated 3-sigma window
    return _splat_gauss_separable(xy, w_ev, H, W, sigma, trunc)


def splat_gauss_reference(xy, valid, pol, H: int, W: int, sigma: float = 1.0,
                          stencil: int = 5,
                          use_polarity: bool = False) -> np.ndarray:
    """float64 numpy per-event stencil form of :func:`splat_gauss`: each
    event adds ``w·exp(-(dx²+dy²)/2σ²)`` to every in-image pixel within
    ``stencil/2`` of it on both axes. The plain reference the splat is
    checked against."""
    xy = np.asarray(xy, np.float64)
    w = np.asarray(valid, np.float64)
    if use_polarity:
        w = w * np.asarray(pol, np.float64)
    trunc = stencil / 2.0
    img = np.zeros((H, W), np.float64)
    h0 = np.ceil(xy[:, 1] - trunc)
    w0 = np.ceil(xy[:, 0] - trunc)
    for oy in range(int(np.floor(2 * trunc)) + 1):
        hh = h0 + oy
        dy = hh - xy[:, 1]
        for ox in range(int(np.floor(2 * trunc)) + 1):
            ww = w0 + ox
            dx = ww - xy[:, 0]
            ok = ((np.abs(dy) <= trunc) & (np.abs(dx) <= trunc)
                  & (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W) & (w != 0))
            val = w * np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
            np.add.at(img, (hh[ok].astype(np.int64), ww[ok].astype(np.int64)),
                      val[ok])
    return img


def normalize_to_image(acc: jnp.ndarray) -> jnp.ndarray:
    """Scale accumulator to [0,1] (the reference normalizes to 8-bit)."""
    lo = jnp.min(acc)
    hi = jnp.max(acc)
    return (acc - lo) / jnp.maximum(hi - lo, 1e-12)


# ------------------------------------------------------------------- warps


def warp_se2(xy: jnp.ndarray, t_rel: jnp.ndarray, params: jnp.ndarray,
             center: jnp.ndarray):
    """2D rotation+translation flow warp: each event is rotated by
    ``omega * t_rel`` about ``center`` and shifted by ``v * t_rel``
    (the reference's 3-param EvFocus_MS_RT2D warp, src/Event/
    EvOptimizer.cpp:46-161). params = [omega, vx, vy]."""
    w, vx, vy = params[0], params[1], params[2]
    a = w * t_rel
    ca, sa = jnp.cos(a), jnp.sin(a)
    rel = xy - center
    x = ca * rel[:, 0] - sa * rel[:, 1] + center[0] - vx * t_rel
    y = sa * rel[:, 0] + ca * rel[:, 1] + center[1] - vy * t_rel
    return jnp.stack([x, y], axis=1)


def warp_se3_depth(
    xy: jnp.ndarray,          # (N,2) undistorted pixel coords
    t_rel: jnp.ndarray,       # (N,) in [0,1] relative timestamp in window
    T0: jnp.ndarray,          # (4,4) Tcw at window start
    T1: jnp.ndarray,          # (4,4) Tcw at window end
    cam_params: jnp.ndarray,
    depth,                    # scalar median depth OR (N,) per-event depth
):
    """Warp events to the window-END frame through an SE3 interpolation
    and a constant/median scene depth (reference ev2mci_gg_f SE3 overload,
    src/Event/EventConversion.cc:280-360: axis-angle slerp by relative
    timestamp + median depth unprojection). End-alignment matters: the
    resulting MCI is stamped with the window-end timestamp (PoseImage.ts)
    and, in inertial modes, IMU windows end there too — the image content
    must correspond to that instant (getSynchMCI builds the MCI at the
    image timestamp, src/Event/EvImBuilder.cpp:1249)."""
    from eorb_slam_tpu.geometry import camera as cam_mod

    rays = cam_mod.pinhole_unproject_linear(cam_params, xy)   # (N,3)
    depth = jnp.broadcast_to(jnp.asarray(depth, xy.dtype), (xy.shape[0],))
    pts_c = rays * depth[:, None]

    # interpolate camera pose at each event time, take point to world
    T_t = jax.vmap(lambda a: lie.interpolate_se3(T0, T1, a))(t_rel)  # (N,4,4)
    Twc = jax.vmap(lie.se3_inv)(T_t)
    pts_w = jax.vmap(lie.se3_apply)(Twc, pts_c)
    # reproject into the window-end camera
    pts_1 = lie.se3_apply(T1, pts_w)
    return cam_mod.pinhole_project_linear(cam_params, pts_1), pts_1[..., 2]


def warp_se3_depthmap(
    xy: jnp.ndarray,          # (N,2) undistorted pixel coords
    t_rel: jnp.ndarray,       # (N,) in [0,1]
    T0: jnp.ndarray,
    T1: jnp.ndarray,
    cam_params: jnp.ndarray,
    depth_map: jnp.ndarray,   # (H,W) per-pixel depth, <=0 marks holes
    default_depth,            # scalar fallback for holes (median scene depth)
):
    """Per-pixel-depth variant of :func:`warp_se3_depth` (reference
    ev2mci_gg_f MyDepthMap overload, src/Event/EventConversion.cc:451;
    MyDepthMap nearest lookup, include/Utils/MyDataTypes.h:518-545): each
    event unprojects through the depth sampled at its own pixel (nearest
    neighbour), holes fall back to the median scene depth."""
    H, W = depth_map.shape
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, H - 1)
    d = depth_map[yi, xi]
    d = jnp.where(d > 0, d, jnp.asarray(default_depth, d.dtype))
    return warp_se3_depth(xy, t_rel, T0, T1, cam_params, d)


# ------------------------------------------------------------- focus metrics


def image_std(img: jnp.ndarray, valid_mask=None) -> jnp.ndarray:
    """Global contrast: STD of the (optionally masked) image
    (reference measureImageFocus, src/Event/EventConversion.cc:74)."""
    if valid_mask is None:
        return jnp.std(img)
    w = valid_mask.astype(img.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(img * w) / n
    return jnp.sqrt(jnp.sum(w * (img - mu) ** 2) / n)


@functools.partial(jax.jit, static_argnames=("patch",))
def patch_std_mean(img: jnp.ndarray, patch: int = 30) -> jnp.ndarray:
    """Mean of patchwise STDs — the reference's MCI selection score
    (src/Event/EventConversion.cc:74-119, 30 px patches; selection at
    src/Event/EvImBuilder.cpp:1205-1221). Computed with two average pools
    (E[x^2] - E[x]^2 per patch), which XLA lowers to fast reduce-windows."""
    H, W = img.shape
    ph = H // patch
    pw = W // patch
    crop = img[: ph * patch, : pw * patch]
    tiles = crop.reshape(ph, patch, pw, patch)
    mu = jnp.mean(tiles, axis=(1, 3))
    mu2 = jnp.mean(tiles * tiles, axis=(1, 3))
    var = jnp.maximum(mu2 - mu * mu, 0.0)
    return jnp.mean(jnp.sqrt(var))


def event_gen_rate(n_events, t_span, n_pixels) -> jnp.ndarray:
    """Events per pixel per second (reference calcEventGenRate,
    src/Event/EventData.cpp; gate at src/Event/EvImBuilder.cpp:1327-1342)."""
    return n_events / (jnp.maximum(t_span, 1e-9) * n_pixels)
