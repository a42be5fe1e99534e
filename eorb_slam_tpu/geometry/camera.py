"""Batched camera models: radial-tangential pinhole and Kannala-Brandt-8 fisheye.

Re-design of the reference's GeometricCamera hierarchy
(reference include/CameraModels/GeometricCamera.h:94-140,
src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp):
instead of virtual per-point calls, every op is a pure function over
``(...,3)`` / ``(...,2)`` arrays, vmap/jit-safe, with analytic Jacobians.

A camera is a pytree-friendly parameter vector:
- pinhole: ``[fx, fy, cx, cy, k1, k2, p1, p2, k3]`` (9,)
- KB8 fisheye: ``[fx, fy, cx, cy, k1, k2, k3, k4]`` (8,)

Model dispatch is static (separate functions), matching the reference's
compile-time camera type choice per run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PINHOLE = 0
FISHEYE_KB8 = 1


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0):
    return jnp.asarray([fx, fy, cx, cy, k1, k2, p1, p2, k3], dtype=jnp.float32)


def make_kb8(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, k4=0.0):
    return jnp.asarray([fx, fy, cx, cy, k1, k2, k3, k4], dtype=jnp.float32)


def K_matrix(params: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=params.dtype)


# --------------------------------------------------------------------- pinhole


def pinhole_distort_normalized(params, xy):
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def pinhole_undistort_normalized(params, xy_d, iters: int = 20):
    """Invert distortion by fixed-point Newton iteration (fixed iters for jit).

    Mirrors OpenCV's undistortPoints semantics used by the reference for
    keypoint undistortion (reference src/Frame.cc UndistortKeyPoints,
    src/Utils/MyCalibrator.cpp)."""

    # classic fixed point: x_{n+1} = (x_d - tangential(x_n)) / radial(x_n)
    def step(_, xy):
        k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xy_d[..., 0] - dx) / radial
        yn = (xy_d[..., 1] - dy) / radial
        return jnp.stack([xn, yn], axis=-1)

    return jax.lax.fori_loop(0, iters, step, xy_d)


def pinhole_project(params, pts3d):
    """Project camera-frame 3D points (...,3) to distorted pixels (...,2).

    Points behind the camera produce garbage coords; callers mask with
    ``pts3d[...,2] > 0`` (same contract as the reference's isInFrustum)."""
    z = pts3d[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    xy = pts3d[..., :2] / z_safe[..., None]
    xyd = pinhole_distort_normalized(params, xy)
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return jnp.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], axis=-1)


def pinhole_project_linear(params, pts3d):
    """Project with K only (no distortion) — for pre-undistorted keypoints.

    The reference undistorts keypoints once at Frame construction and then
    uses the linear model in all optimizers (src/Frame.cc, src/Optimizer.cc);
    we keep that convention: map state stores undistorted observations."""
    z = pts3d[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    x = pts3d[..., 0] / z_safe
    y = pts3d[..., 1] / z_safe
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return jnp.stack([fx * x + cx, fy * y + cy], axis=-1)


def pinhole_unproject(params, uv):
    """Distorted pixel (...,2) -> unit-z ray (...,3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xn = (uv[..., 0] - cx) / fx
    yn = (uv[..., 1] - cy) / fy
    xy = pinhole_undistort_normalized(params, jnp.stack([xn, yn], axis=-1))
    return jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)


def pinhole_unproject_linear(params, uv):
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xn = (uv[..., 0] - cx) / fx
    yn = (uv[..., 1] - cy) / fy
    return jnp.stack([xn, yn, jnp.ones_like(xn)], axis=-1)


def pinhole_project_jac_point(params, pts3d):
    """d(pixel)/d(point) for the linear model: (...,2,3).

    Matches reference Pinhole::projectJac (src/CameraModels/Pinhole.cpp)."""
    fx, fy = params[0], params[1]
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1)
    row1 = jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


@jax.jit
def undistort_points(params, uv):
    """Distorted observed pixels -> undistorted pixels (linear model).

    Equivalent of Frame::UndistortKeyPoints / MyCalibrator::undistPoint.
    Jitted at top level: it is called eagerly once per frame, and the
    20-step fixed-point loop would otherwise dispatch ~100 tiny eager
    ops."""
    ray = pinhole_unproject(params, uv)
    return pinhole_project_linear(params, ray)


def build_rectify_map(params, w: int, h: int, model: int = 0):
    """Per-pixel undistortion lookup (H,W,2): raw sensor pixel -> undistorted
    pixel in the SAME linear intrinsics. The event loaders apply it per
    event at load (reference MyCalibrator's precomputed cv::remap maps +
    EventDataStore's rectify-at-load path, include/Utils/MyCalibrator.h:
    23-97, include/Event/EventLoader.h:15-50).

    model: PINHOLE (radial-tangential) or FISHEYE_KB8. Returned as a jitted
    batch over the pixel grid — one device call per calibration, cached by
    the caller."""
    import numpy as np

    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    uv = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    if model == FISHEYE_KB8:
        ray = kb8_unproject(params, uv)
        out = pinhole_project_linear(params, ray)
    else:
        out = undistort_points(params, uv)
    return np.asarray(out).reshape(h, w, 2)


# ------------------------------------------------------------------------ KB8


def kb8_project(params, pts3d):
    """KB8 fisheye projection (reference src/CameraModels/KannalaBrandt8.cpp)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    r = jnp.sqrt(x * x + y * y)
    r_safe = jnp.where(r < 1e-9, 1e-9, r)
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r_safe
    return jnp.stack(
        [fx * x * scale + cx, fy * y * scale + cy], axis=-1
    )


def kb8_unproject(params, uv, iters: int = 10):
    """Pixel -> unit-z ray via Newton inversion of the theta polynomial.

    Same approach as reference KannalaBrandt8::unproject (Newton on theta)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d_c = jnp.clip(theta_d, 0.0, jnp.pi / 2.0 + 0.4)

    def newton(_, theta):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d_c
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        return theta - f / jnp.where(jnp.abs(df) < 1e-9, 1e-9, df)

    theta = jax.lax.fori_loop(0, iters, newton, theta_d_c)
    scale = jnp.where(theta_d > 1e-9, jnp.tan(theta) / jnp.where(theta_d > 1e-9, theta_d, 1.0), 1.0)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def kb8_project_jac_point(params, pts3d):
    """d(pixel)/d(point) for KB8 via jax.jacfwd (vmapped by caller)."""
    return jax.jacfwd(lambda p: kb8_project(params, p))(pts3d)


# ------------------------------------------------------------------- dispatch


def project(model: int, params, pts3d):
    if model == PINHOLE:
        return pinhole_project(params, pts3d)
    return kb8_project(params, pts3d)


def unproject(model: int, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def kb8_triangulate_matches(
    params1, params2, Trl, uv1, uv2, valid,
    max_reproj_px: float = 2.0, min_parallax_cos: float = 0.9998,
):
    """Stereo-fisheye triangulation of matched keypoints between two
    NON-rectified KB8 cameras (reference KannalaBrandt8::TriangulateMatches,
    src/CameraModels/KannalaBrandt8.cpp:416: unproject both rays, DLT-
    triangulate with the extrinsic Trl, gate by parallax + per-view
    reprojection error; stereo-fisheye pairs cannot be rectified so the
    pinhole disparity path does not apply).

    Trl: (4,4) pose of the LEFT camera in the RIGHT camera's frame
    (x_r = Trl x_l). Returns (pts3d in LEFT cam frame (N,3), depth (N,),
    ok (N,)). Batched + jittable.
    """
    import jax
    from eorb_slam_tpu.geometry import triangulation

    rays1 = kb8_unproject(params1, uv1)                     # (N,3) unit-z
    rays2 = kb8_unproject(params2, uv2)
    T1 = jnp.eye(4, dtype=uv1.dtype)
    pts = triangulation.triangulate_dlt(
        T1[None], Trl[None], rays1, rays2
    )                                                       # left-cam frame
    z1 = pts[:, 2]
    pc2 = pts @ Trl[:3, :3].T + Trl[:3, 3]
    z2 = pc2[:, 2]
    uv1_hat = kb8_project(params1, pts)
    uv2_hat = kb8_project(params2, pc2)
    e1 = jnp.linalg.norm(uv1_hat - uv1, axis=-1)
    e2 = jnp.linalg.norm(uv2_hat - uv2, axis=-1)
    # parallax between the two rays expressed in one frame
    r2_in_1 = rays2 @ Trl[:3, :3]
    cosp = jnp.sum(rays1 * r2_in_1, axis=-1) / (
        jnp.linalg.norm(rays1, axis=-1) * jnp.linalg.norm(r2_in_1, axis=-1)
        + 1e-12
    )
    ok = (
        valid & (z1 > 1e-3) & (z2 > 1e-3)
        & (e1 <= max_reproj_px) & (e2 <= max_reproj_px)
        & (cosp < min_parallax_cos)
        & jnp.isfinite(pts).all(axis=-1)
    )
    return pts, z1, ok
