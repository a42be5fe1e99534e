"""Inertial residuals + inertial-only initialization optimization.

Replacement for the reference's inertial g2o machinery:
- ``inertial_residual`` = ``EdgeInertial`` (9-dim preintegration residual,
  reference include/G2oTypes.h:60-822, src/G2oTypes.cc)
- ``inertial_init`` = ``Optimizer::InertialOptimization`` (gravity
  direction, scale, biases, velocities with poses fixed — reference
  src/Optimizer.cc:6345,:6544) solved as one damped GN over a small packed
  parameter vector with autodiff Jacobians (jacfwd — the parameter count is
  3K+9, tiny next to the residual work, so forward-mode is the right shape).

All poses here are **body-in-world** (Rwb, pwb); conversion from camera
poses is imu.preintegration.Twb_from_Tcw.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.imu import preintegration as pre_mod
from eorb_slam_tpu.optim import linalg


# Measurement-noise floor added to the 9x9 preintegration covariance before
# whitening: the inertial residual contains VISUALLY-estimated poses whose
# errors (~1 mrad rotation, ~1 cm position, ~2 cm/s velocity) dwarf the raw
# IMU noise. Without the floor, the near-singular information matrix lets
# its er/ev/ep cross-terms dominate the objective and the optimizer distorts
# scale/velocity to cancel visual pose noise — observed as the whitened cost
# minimizing at ~4x wrong metric scale while the unwhitened cost minimizes
# at the true one. (g2o in the reference has the same issue in principle but
# runs f64 with more accurate poses; the floor makes the model honest.)
COV_FLOOR_9 = jnp.diag(
    jnp.asarray([1e-6] * 3 + [4e-4] * 3 + [1e-4] * 3, jnp.float32)
)


def floored_info_chol(C9: jnp.ndarray) -> jnp.ndarray:
    """Cholesky factor L of inv(C + floor); whitening is r -> L^T r."""
    Cs = 0.5 * (C9 + C9.T) + COV_FLOOR_9
    return jnp.linalg.cholesky(jnp.linalg.inv(Cs))


def gravity_from_dir(rwg: jnp.ndarray) -> jnp.ndarray:
    """2-dof gravity direction: g = Rwg @ (0,0,-9.81), Rwg = Exp([a,b,0])
    (reference ``VertexGDir``)."""
    Rwg = lie.so3_exp(jnp.concatenate([rwg, jnp.zeros(1, rwg.dtype)]))
    return Rwg @ jnp.asarray([0.0, 0.0, -pre_mod.GRAVITY], rwg.dtype)


def inertial_residual(
    Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2,
    pre: pre_mod.Preintegrated, g: jnp.ndarray, scale=1.0,
):
    """9-dim (er, ev, ep) residual of one preintegrated IMU factor.

    With ``scale`` != 1 this is ``EdgeInertialGS`` (positions/velocities
    multiplied by the global scale during initialization)."""
    dR, dV, dP = pre_mod.delta_corrected(pre, bg, ba)
    t = pre.dt
    er = lie.so3_log(dR.T @ Rwb1.T @ Rwb2)
    ev = Rwb1.T @ (scale * (vwb2 - vwb1) - g * t) - dV
    ep = Rwb1.T @ (scale * (pwb2 - pwb1 - vwb1 * t) - 0.5 * g * t * t) - dP
    return jnp.concatenate([er, ev, ep])


def whitened_inertial_residual(
    Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2, pre, g, scale=1.0
):
    r = inertial_residual(Rwb1, pwb1, vwb1, bg, ba, Rwb2, pwb2, vwb2,
                          pre, g, scale)
    return floored_info_chol(pre.C[:9, :9]).T @ r


@jax.jit
def linear_alignment(
    Twb: jnp.ndarray,                   # (K,4,4) body poses in vision frame
    pre_stack: pre_mod.Preintegrated,   # batched (K,...)
    edge_valid: jnp.ndarray,            # (K,) bool
    prev=None,                          # (K,) int32 temporal predecessor slot
):
    """Closed-form visual-inertial alignment (Martinelli-style).

    With w_k := s * v_k the constraints from the preintegrated deltas are
    LINEAR in (s, g, w_0..w_{K-1}):

      ev: Ra^T w_b - Ra^T w_a - t Ra^T g            = dV
      ep: s Ra^T (p_b - p_a) - t Ra^T w_a - t^2/2 Ra^T g = dP

    Solved as masked normal equations; seeds the nonlinear refinement
    (``inertial_init``) far from its s=1 basin — mono maps are routinely
    5-20x off metric scale and the GN alone falls into local minima.
    Returns (s, g (3,), vel (K,3))."""
    K = Twb.shape[0]
    dtype = Twb.dtype
    R = Twb[:, :3, :3]
    p = Twb[:, :3, 3]
    n_var = 4 + 3 * K
    if prev is None:
        prev = jnp.arange(K, dtype=jnp.int32) - 1
    edge_valid = edge_valid & (prev >= 0)

    def edge_rows(k):
        a = jnp.maximum(prev[k], 0)
        Ra_T = R[a].T
        t = pre_stack.dt[k]
        dV = pre_stack.dV[k]
        dP = pre_stack.dP[k]
        dp = p[k] - p[a]

        # one-hot selectors for w_a, w_b
        sel = jax.nn.one_hot(jnp.stack([a, k]), K, dtype=dtype)  # (2,K)
        A_ev = jnp.zeros((3, n_var), dtype)
        A_ev = A_ev.at[:, 1:4].set(-t * Ra_T)
        # w blocks: columns 4+3*idx : 4+3*idx+3
        w_block_a = jnp.einsum("ij,k->ikj", Ra_T, sel[0])        # (3,K,3)
        w_block_b = jnp.einsum("ij,k->ikj", Ra_T, sel[1])
        A_ev = A_ev.at[:, 4:].set((w_block_b - w_block_a).reshape(3, 3 * K))
        b_ev = dV

        A_ep = jnp.zeros((3, n_var), dtype)
        A_ep = A_ep.at[:, 0].set(Ra_T @ dp)
        A_ep = A_ep.at[:, 1:4].set(-0.5 * t * t * Ra_T)
        A_ep = A_ep.at[:, 4:].set((-t * w_block_a).reshape(3, 3 * K))
        b_ep = dP

        Ae = jnp.concatenate([A_ev, A_ep], axis=0)               # (6,n_var)
        be = jnp.concatenate([b_ev, b_ep])
        w = edge_valid[k].astype(dtype)
        return Ae * w, be * w

    A, b = jax.vmap(edge_rows)(jnp.arange(K))                    # (K,6,nv)

    def solve(Aw, bw):
        Af = Aw.reshape(-1, n_var)
        bf = bw.reshape(-1)
        H = Af.T @ Af
        # tiny Tikhonov keeps unconstrained w_k (invalid slots) at zero
        H = H + jnp.eye(n_var, dtype=dtype) * 1e-6
        # f32 normal equations with mixed column scales (s vs g vs w) need
        # Jacobi equilibration or the solve returns garbage (optim/linalg.py)
        return linalg.solve_spd_jacobi(H, Af.T @ bf)

    # IRLS: a single corrupted visual edge (tracking glitch, scale-drifted
    # segment) otherwise dominates the fit through its |dp|^2 weight — the
    # reference is insulated from this by per-edge robust kernels in g2o
    x = solve(A, b)
    for _ in range(2):
        r = jnp.einsum("kij,j->ki", A, x) - b                    # (K,6)
        rn = jnp.linalg.norm(r, axis=1)                          # (K,)
        # nanmedian: edge_valid never spans the full K capacity (chain heads /
        # unused slots are False), so a plain median over the NaN-masked vector
        # would itself be NaN and the robust kernel would silently disable
        med = jnp.nanmedian(jnp.where(edge_valid, rn, jnp.nan))
        delta = 2.0 * jnp.nan_to_num(med, nan=1.0) + 1e-6
        w = jnp.sqrt(jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-12)))
        x = solve(A * w[:, None, None], b * w[:, None])
    s = x[0]
    g = x[1:4]
    vel = x[4:].reshape(K, 3) / jnp.maximum(jnp.abs(s), 1e-6) * jnp.sign(s)
    return s, g, vel


class InertialInitResult(NamedTuple):
    vel: jnp.ndarray     # (K,3) body velocities
    bg: jnp.ndarray      # (3,)
    ba: jnp.ndarray      # (3,)
    rwg: jnp.ndarray     # (2,) gravity direction params
    g: jnp.ndarray       # (3,) gravity in world
    scale: jnp.ndarray   # ()
    cost0: jnp.ndarray
    cost: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
def inertial_init(
    Twb: jnp.ndarray,          # (K,4,4) body poses (fixed)
    pre_stack: pre_mod.Preintegrated,  # batched (K,...); slot k = KF k-1 -> k
    edge_valid: jnp.ndarray,   # (K,) bool (slot 0 unused)
    prior_gyro: float = 1e2,
    prior_acc: float = 1e10,
    iters: int = 40,
    fix_scale: bool = False,
    prev=None,             # (K,) int32 temporal predecessor slot per edge
) -> InertialInitResult:
    """Estimate (velocities, biases, gravity dir, scale) with poses fixed.

    Staged priors: the reference calls this at t={0,5,15}s with
    priorG/priorA = {1e2,1e10} -> {1.f,1e5} -> {0,0} (reference
    src/LocalMapping.cc:198-241); pass those through ``prior_gyro``/
    ``prior_acc``."""
    K = Twb.shape[0]
    dtype = Twb.dtype
    Rwb = Twb[:, :3, :3]
    pwb = Twb[:, :3, 3]
    if prev is None:
        prev = jnp.arange(K, dtype=jnp.int32) - 1
    edge_valid = edge_valid & (prev >= 0)

    # closed-form seed: without it the GN falls into an s~1 local minimum
    # whenever the mono map is far off metric scale
    s_lin, g_lin, v0 = linear_alignment(Twb, pre_stack, edge_valid, prev)
    s_lin = jnp.clip(jnp.abs(s_lin), 1e-3, 1e4)
    # gravity direction params from the linear g estimate: rwg such that
    # Exp([a,b,0]) @ (0,0,-G) ~ g_lin
    g_dir = g_lin / jnp.maximum(jnp.linalg.norm(g_lin), 1e-8)
    ez = jnp.asarray([0.0, 0.0, -1.0], dtype)
    axis = jnp.cross(ez, g_dir)
    sin_a = jnp.linalg.norm(axis)
    cos_a = jnp.dot(ez, g_dir)
    ang = jnp.arctan2(sin_a, cos_a)
    axis = axis / jnp.maximum(sin_a, 1e-8)
    rwg0 = jnp.where(sin_a > 1e-6, (axis * ang)[:2], jnp.zeros(2, dtype))

    def unpack(theta):
        vel = theta[: 3 * K].reshape(K, 3)
        bg = theta[3 * K : 3 * K + 3]
        ba = theta[3 * K + 3 : 3 * K + 6]
        rwg = theta[3 * K + 6 : 3 * K + 8]
        log_s = theta[3 * K + 8]
        s = jnp.where(fix_scale, 1.0, jnp.exp(log_s))
        return vel, bg, ba, rwg, s

    info_L = jax.vmap(lambda C: floored_info_chol(C[:9, :9]))(pre_stack.C)

    def residuals(theta):
        vel, bg, ba, rwg, s = unpack(theta)
        g = gravity_from_dir(rwg)

        def edge(k):
            a = jnp.maximum(prev[k], 0)
            pre_k = jax.tree_util.tree_map(lambda x: x[k], pre_stack)
            r = inertial_residual(
                Rwb[a], pwb[a], vel[a], bg, ba,
                Rwb[k], pwb[k], vel[k], pre_k, g, scale=s,
            )
            return info_L[k].T @ r

        r_edges = jax.vmap(edge)(jnp.arange(K))               # (K,9)
        r_edges = r_edges * edge_valid[:, None]
        # robust kernel per edge, thresholded RELATIVE to the median edge
        # chi2: far from convergence every residual is large (an absolute
        # gate would freeze the solve), but a single inconsistent visual
        # edge still sits orders of magnitude above its peers and must not
        # drag scale/gravity
        chi2 = jnp.sum(r_edges * r_edges, axis=1)
        med = jnp.nanmedian(jnp.where(edge_valid, chi2, jnp.nan))
        gate = 9.0 * jnp.nan_to_num(med, nan=1e6) + 1e-6
        w_rob = jnp.sqrt(jnp.minimum(1.0, gate / jnp.maximum(chi2, 1e-12)))
        r_edges = r_edges * w_rob[:, None]
        r_prior = jnp.concatenate([
            jnp.sqrt(jnp.asarray(prior_gyro, dtype)) * bg,
            jnp.sqrt(jnp.asarray(prior_acc, dtype)) * ba,
        ])
        return jnp.concatenate([r_edges.reshape(-1), r_prior])

    theta0 = jnp.concatenate([
        v0.reshape(-1), jnp.zeros(6, dtype), rwg0,
        jnp.log(s_lin)[None],
    ])

    def cost(theta):
        r = residuals(theta)
        return jnp.sum(r * r)

    def body(_, state):
        theta, lam, c = state
        r = residuals(theta)
        J = jax.jacfwd(residuals)(theta)
        H = J.T @ J
        b = -J.T @ r
        d = jnp.diag(H)
        H_d = H + jnp.diag(lam * jnp.maximum(d, 1e-8))
        dx = linalg.solve_spd_jacobi(H_d, b)
        theta_new = theta + dx
        c_new = cost(theta_new)
        accept = c_new < c
        theta = jnp.where(accept, theta_new, theta)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 10.0, 1e6))
        c = jnp.where(accept, c_new, c)
        return theta, lam, c

    c0 = cost(theta0)
    theta, _, c = jax.lax.fori_loop(
        0, iters, body, (theta0, jnp.asarray(1e-2, dtype), c0)
    )
    vel, bg, ba, rwg, s = unpack(theta)
    return InertialInitResult(
        vel=vel, bg=bg, ba=ba, rwg=rwg, g=gravity_from_dir(rwg),
        scale=s, cost0=c0, cost=c,
    )


def apply_scaled_rotation(
    Twb: jnp.ndarray, lm_pos: jnp.ndarray, vel: jnp.ndarray,
    Ryw: jnp.ndarray, scale,
):
    """Gravity-align + rescale the map after IMU init (reference
    Map::ApplyScaledRotation, include/Map.h:122-123): world' = Ryw @ world,
    positions scaled by ``scale``; body orientations rotated."""
    R = Twb[:, :3, :3]
    p = Twb[:, :3, 3]
    R2 = jnp.einsum("ij,kjl->kil", Ryw, R)
    p2 = scale * jnp.einsum("ij,kj->ki", Ryw, p)
    Twb2 = jnp.tile(jnp.eye(4, dtype=Twb.dtype), (Twb.shape[0], 1, 1))
    Twb2 = Twb2.at[:, :3, :3].set(jax.vmap(lie.project_so3)(R2))
    Twb2 = Twb2.at[:, :3, 3].set(p2)
    lm2 = scale * jnp.einsum("ij,mj->mi", Ryw, lm_pos)
    vel2 = scale * jnp.einsum("ij,kj->ki", Ryw, vel)
    return Twb2, lm2, vel2
