"""Schur marginalization tools and the marginalized pose-IMU prior.

Reference parity: ``Optimizer::Marginalize`` (reference src/Optimizer.cc:6229),
``Optimizer::Condition`` (:6311), ``Optimizer::Sparsify`` (:6331), and the
``ConstraintPoseImu`` / ``EdgePriorPoseImu`` 15-dim marginalized prior used by
``Optimizer::PoseInertialOptimizationLastFrame`` (src/Optimizer.cc:9006,
include/G2oTypes.h:600-670).

Shape: all three Schur tools are pure jittable functions on a dense
(N,N) Hessian with *static* block bounds (the reference also works on small
dense Eigen matrices — 30x30 for the two-frame VI problem — so a dense SVD
pseudo-inverse is the right tool on both platforms). The prior is a NamedTuple
of (state, 15x15 information) carried frame-to-frame by the host tracker, and
``pose_inertial_optimization_last_frame`` re-creates the reference's two-frame
sliding-window estimator: optimize [last frame 15-dof | current frame 15-dof]
with the prior anchored on the last frame, then Schur-marginalize the last
frame out of the final Hessian to produce the next frame's prior.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.imu import preintegration as pre_mod
from eorb_slam_tpu.optim import inertial, robust


def _pinv_psd(A: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """SVD pseudo-inverse with the reference's 1e-6 singular-value floor
    (src/Optimizer.cc:6270-6277)."""
    U, s, Vt = jnp.linalg.svd(A, full_matrices=False)
    s_inv = jnp.where(s > eps, 1.0 / jnp.maximum(s, eps), 0.0)
    return (Vt.T * s_inv) @ U.T


@functools.partial(jax.jit, static_argnames=("start", "end"))
def marginalize(H: jnp.ndarray, start: int, end: int) -> jnp.ndarray:
    """Marginalize block [start, end] (inclusive) out of information matrix H,
    returning a matrix of the same shape with the marginalized rows/cols
    zeroed — layout-compatible with reference src/Optimizer.cc:6229-6309."""
    n = H.shape[0]
    keep = [i for i in range(n) if i < start or i > end]
    marg = list(range(start, end + 1))
    ki = jnp.asarray(keep, jnp.int32)
    mi = jnp.asarray(marg, jnp.int32)
    Hkk = H[jnp.ix_(ki, ki)]
    Hkm = H[jnp.ix_(ki, mi)]
    Hmm = H[jnp.ix_(mi, mi)]
    Hs = Hkk - Hkm @ _pinv_psd(Hmm) @ Hkm.T
    out = jnp.zeros_like(H)
    return out.at[jnp.ix_(ki, ki)].set(Hs)


@functools.partial(jax.jit, static_argnames=("start", "end"))
def condition(H: jnp.ndarray, start: int, end: int) -> jnp.ndarray:
    """Zero rows/cols of block [start, end] (condition on its current value;
    reference src/Optimizer.cc:6311-6329)."""
    n = H.shape[0]
    on = jnp.asarray([1.0 if (i < start or i > end) else 0.0 for i in range(n)],
                     H.dtype)
    return H * on[:, None] * on[None, :]


@functools.partial(jax.jit, static_argnames=("start1", "end1", "start2", "end2"))
def sparsify(H: jnp.ndarray, start1: int, end1: int,
             start2: int, end2: int) -> jnp.ndarray:
    """Remove the information link between blocks 1 and 2:
    H' = Hac + Hbc - Hc (reference src/Optimizer.cc:6331-6343)."""
    Hac = marginalize(H, start2, end2)
    Hbc = marginalize(H, start1, end1)
    Hc = marginalize(Hac, start1, end1)
    return Hac + Hbc - Hc


class PoseImuPrior(NamedTuple):
    """Marginal prior on one frame's 15-dof VI state (ConstraintPoseImu,
    include/G2oTypes.h:600-621): linearization point + information matrix.
    State order matches the optimizer theta: [se3(6), vel(3), bg(3), ba(3)]."""

    Tcw: jnp.ndarray   # (4,4)
    vel: jnp.ndarray   # (3,)
    bg: jnp.ndarray    # (3,)
    ba: jnp.ndarray    # (3,)
    H: jnp.ndarray     # (15,15) information


def _sqrt_info(H: jnp.ndarray) -> jnp.ndarray:
    """Symmetric PSD square root via eigh (information matrices out of a
    marginalization can be rank-deficient; eigh handles that where Cholesky
    cannot — mirrors the reference's spectral clamp in EdgePriorPoseImu)."""
    w, V = jnp.linalg.eigh(0.5 * (H + H.T))
    w = jnp.maximum(w, 0.0)
    return (V * jnp.sqrt(w)) @ V.T


def prior_residual(prior: PoseImuPrior, Tcw: jnp.ndarray, vel: jnp.ndarray,
                   bg: jnp.ndarray, ba: jnp.ndarray) -> jnp.ndarray:
    """Whitened 15-dim prior residual sqrt(H) @ [log(T Tcw_prior^-1), dv, dbg,
    dba] (EdgePriorPoseImu::computeError, include/G2oTypes.h:623-651)."""
    dT = Tcw @ lie.se3_inv(prior.Tcw)
    r = jnp.concatenate([
        lie.se3_log(dT), vel - prior.vel, bg - prior.bg, ba - prior.ba,
    ])
    return _sqrt_info(prior.H) @ r


def identity_prior(Tcw: jnp.ndarray, vel: jnp.ndarray, bg: jnp.ndarray,
                   ba: jnp.ndarray, weight: float = 1e2) -> PoseImuPrior:
    """Initial prior for the first tracked frame after a keyframe (the
    reference seeds ConstraintPoseImu from the last KF optimization's
    recovered Hessian; a scaled identity is the cold-start equivalent)."""
    dtype = Tcw.dtype
    return PoseImuPrior(Tcw, vel, bg, ba,
                        jnp.eye(15, dtype=dtype) * jnp.asarray(weight, dtype))


@functools.partial(jax.jit, static_argnames=("iters",))
def pose_inertial_optimization_last_frame(
    cam_params: jnp.ndarray,
    Tcw0: jnp.ndarray, vel0: jnp.ndarray,
    bg0: jnp.ndarray, ba0: jnp.ndarray,
    pts_w: jnp.ndarray, uv_obs: jnp.ndarray,
    inv_sigma: jnp.ndarray, obs_valid: jnp.ndarray,
    prior: PoseImuPrior,
    pre: pre_mod.Preintegrated,
    Tbc: jnp.ndarray,
    g: jnp.ndarray = pre_mod.GRAVITY_W,
    iters: int = 10,
):
    """Motion-only VI optimization of [last frame | current frame] with a
    marginalized prior on the last frame; the last frame is then Schur-
    marginalized out of the final Hessian to produce the next prior
    (reference Optimizer::PoseInertialOptimizationLastFrame,
    src/Optimizer.cc:9006 + Marginalize at :9390).

    Returns (Tcw, vel, bg, ba, inlier, n_inliers, next_prior).
    """
    from eorb_slam_tpu.geometry import camera as cam_mod

    dtype = Tcw0.dtype

    def residuals(theta, TcwL, velL, bgL, baL, Tcw, vel, bg, ba, w_obs):
        # theta: [last 15 | current 15]
        TL = lie.se3_exp(theta[:6]) @ TcwL
        vL = velL + theta[6:9]
        bgL2 = bgL + theta[9:12]
        baL2 = baL + theta[12:15]
        T = lie.se3_exp(theta[15:21]) @ Tcw
        v = vel + theta[21:24]
        bgc = bg + theta[24:27]
        bac = ba + theta[27:30]
        pc = lie.se3_apply(T, pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r_vis = (uv_obs - uv_hat) * inv_sigma[..., None] * w_obs[..., None]
        TwbL = pre_mod.Twb_from_Tcw(TL, Tbc)
        Twb = pre_mod.Twb_from_Tcw(T, Tbc)
        r_in = inertial.whitened_inertial_residual(
            TwbL[:3, :3], TwbL[:3, 3], vL, bgL2, baL2,
            Twb[:3, :3], Twb[:3, 3], v, pre, g,
        )
        # gyro/acc bias random walk between the two frames
        # (EdgeGyroRW/EdgeAccRW, include/G2oTypes.h:746-800)
        r_rw = jnp.concatenate([(bgc - bgL2) * 1e2, (bac - baL2) * 1e1])
        r_pr = prior_residual(prior, TL, vL, bgL2, baL2)
        return jnp.concatenate([r_vis.reshape(-1), r_in, r_rw, r_pr])

    def gn_round(carry, chi2_th):
        TcwL, velL, bgL, baL, Tcw, vel, bg, ba = carry
        pc = lie.se3_apply(Tcw, pts_w)
        uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
        r = (uv_obs - uv_hat) * inv_sigma[..., None]
        chi2 = jnp.sum(r * r, axis=-1)
        w_rob = jnp.sqrt(robust.huber_weight(chi2, chi2_th))
        w_obs = w_rob * (obs_valid & (pc[..., 2] > 0)).astype(dtype)

        def body(_, st):
            TcwL, velL, bgL, baL, Tcw, vel, bg, ba = st
            z = jnp.zeros(30, dtype)
            r0 = residuals(z, TcwL, velL, bgL, baL, Tcw, vel, bg, ba, w_obs)
            J = jax.jacfwd(residuals)(z, TcwL, velL, bgL, baL, Tcw, vel, bg,
                                      ba, w_obs)
            H = J.T @ J + jnp.eye(30, dtype=dtype) * 1e-6
            dx = jnp.linalg.solve(H, -J.T @ r0)
            TcwL = lie.se3_project(lie.se3_exp(dx[:6]) @ TcwL)
            Tcw = lie.se3_project(lie.se3_exp(dx[15:21]) @ Tcw)
            return (TcwL, velL + dx[6:9], bgL + dx[9:12], baL + dx[12:15],
                    Tcw, vel + dx[21:24], bg + dx[24:27], ba + dx[27:30])

        st = jax.lax.fori_loop(0, iters // 4 + 1, body, carry)
        return st, None

    gates = jnp.asarray([robust.CHI2_MONO * 4, robust.CHI2_MONO * 2,
                         robust.CHI2_MONO, robust.CHI2_MONO], dtype)
    init = (prior.Tcw, prior.vel, prior.bg, prior.ba, Tcw0, vel0, bg0, ba0)
    (TcwL, velL, bgL, baL, Tcw, vel, bg, ba), _ = jax.lax.scan(
        gn_round, init, gates
    )

    # Final Hessian at the solution, last frame marginalized out -> new prior
    pc = lie.se3_apply(Tcw, pts_w)
    uv_hat = cam_mod.pinhole_project_linear(cam_params, pc)
    chi2 = jnp.sum(((uv_obs - uv_hat) * inv_sigma[..., None]) ** 2, axis=-1)
    inlier = obs_valid & (pc[..., 2] > 0) & (chi2 <= robust.CHI2_MONO)
    w_obs = jnp.sqrt(robust.huber_weight(chi2, robust.CHI2_MONO)) * \
        inlier.astype(dtype)
    z = jnp.zeros(30, dtype)
    J = jax.jacfwd(residuals)(z, TcwL, velL, bgL, baL, Tcw, vel, bg, ba, w_obs)
    H30 = J.T @ J
    Hm = marginalize(H30, 0, 14)
    next_prior = PoseImuPrior(Tcw, vel, bg, ba, Hm[15:, 15:])
    return Tcw, vel, bg, ba, inlier, jnp.sum(inlier.astype(jnp.int32)), \
        next_prior
