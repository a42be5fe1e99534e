"""Essential-graph (pose-graph) optimization over Sim3 / SE3 / 4-DoF.

Replacement for the reference's loop-closing back-ends
(src/Optimizer.cc OptimizeEssentialGraph :2873, 6-DoF merge variant :3638,
OptimizeEssentialGraph4DoF :9442 — all g2o LM over relative-pose edges).

Design: fixed-capacity edge arrays (edge_i, edge_j, measured relative Sim3,
validity mask) + a single masked Gauss-Newton engine. Vertices are Sim3
world->camera (R,t,s); the update is a left-multiplicative tangent step
exp(xi) . S, with three charts selected statically:
  - 'sim3': xi in R^7 (rho, phi, sigma)              — mono loop closing
  - 'se3' : xi in R^7 with sigma rows masked to zero — stereo/RGBD/merges
  - '4dof': xi = (tx,ty,tz,yaw) world-frame yaw only — visual-inertial
The residual chart per edge is [t_err, so3_log(R_err), log(s_err)] of
S_err = S_meas_ji * S_i * S_j^-1 (identity when consistent).

K is small (<= a few hundred KFs), so the normal equations are one dense
(7K,7K) solve; Jacobians come from jax.jacfwd of the
whole stacked residual, traced once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


class PoseGraph(NamedTuple):
    # vertices: world->camera Sim3 per KF slot
    R: jnp.ndarray        # (K,3,3)
    t: jnp.ndarray        # (K,3)
    s: jnp.ndarray        # (K,)
    kf_valid: jnp.ndarray # (K,) bool
    fixed: jnp.ndarray    # (K,) bool — held constant (loop origin KF)
    # edges: measured S_ji (maps cam_i -> cam_j), fixed capacity E
    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    edge_R: jnp.ndarray   # (E,3,3)
    edge_t: jnp.ndarray   # (E,3)
    edge_s: jnp.ndarray   # (E,)
    edge_w: jnp.ndarray   # (E,) weight (0 = invalid)


def relative_sim3(Ri, ti, si, Rj, tj, sj):
    """S_ji = S_j * S_i^-1 for world->cam Sim3s."""
    Rii, tii, sii = lie.sim3_inv(Ri, ti, si)
    return lie.sim3_mul(Rj, tj, sj, Rii, tii, sii)


def _edge_residuals(g: PoseGraph, R, t, s):
    Ri, ti, si = R[g.edge_i], t[g.edge_i], s[g.edge_i]
    Rj, tj, sj = R[g.edge_j], t[g.edge_j], s[g.edge_j]
    Rji, tji, sji = relative_sim3(Ri, ti, si, Rj, tj, sj)
    # S_err = S_meas * S_ji^-1  (identity when estimate matches measurement)
    Rinv, tinv, sinv = lie.sim3_inv(Rji, tji, sji)
    Re, te, se = lie.sim3_mul(g.edge_R, g.edge_t, g.edge_s, Rinv, tinv, sinv)
    r = jnp.concatenate(
        [te, lie.so3_log(Re), jnp.log(se)[..., None]], axis=-1
    )  # (E,7)
    return r * g.edge_w[:, None]


@functools.partial(jax.jit, static_argnames=("iters", "chart"))
def optimize_pose_graph(
    g: PoseGraph, iters: int = 20, chart: str = "sim3", damping: float = 1e-6
) -> PoseGraph:
    """Masked GN over the whole graph. Returns the graph with updated
    vertices (edges unchanged)."""
    K = g.R.shape[0]

    def apply_delta(xi, R0, t0, s0):
        # xi: (K,7) tangent; charts restrict columns
        if chart == "se3":
            xi = xi.at[:, 6].set(0.0)
        elif chart == "4dof":
            # (tx,ty,tz, yaw): rotate about world z only, no scale
            yaw = xi[:, 3]
            zeros = jnp.zeros_like(yaw)
            phi = jnp.stack([zeros, zeros, yaw], axis=-1)
            xi = jnp.concatenate(
                [xi[:, :3], phi, zeros[:, None]], axis=-1
            )
        dR, dt, ds = lie.sim3_exp(xi)
        return lie.sim3_mul(dR, dt, ds, R0, t0, s0)

    free = g.kf_valid & ~g.fixed  # (K,)
    n_param = 7 if chart != "4dof" else 4

    def gn_step(_, state):
        R, t, s = state

        def res_of(xi_flat):
            xi = xi_flat.reshape(K, n_param)
            if chart == "4dof":
                pass  # handled in apply_delta
            Rn, tn, sn = apply_delta(
                xi if n_param == 7 else xi, R, t, s
            )
            return _edge_residuals(g, Rn, tn, sn).reshape(-1)

        xi0 = jnp.zeros(K * n_param, jnp.float32)
        J = jax.jacfwd(res_of)(xi0)           # (7E, K*n)
        r = res_of(xi0)                        # (7E,)
        free_cols = jnp.repeat(free, n_param)  # (K*n,)
        J = J * free_cols[None, :]
        H = J.T @ J + damping * jnp.eye(K * n_param, dtype=J.dtype)
        # pin fixed/invalid rows to identity so the solve stays well-posed
        H = jnp.where(
            (free_cols[:, None] & free_cols[None, :]),
            H,
            jnp.eye(K * n_param, dtype=J.dtype),
        )
        b = -(J.T @ r) * free_cols
        dx = jnp.linalg.solve(H, b).reshape(K, n_param)
        Rn, tn, sn = apply_delta(dx, R, t, s)
        Rn = lie.project_so3(Rn)
        keep = free[:, None, None]
        return (
            jnp.where(keep, Rn, R),
            jnp.where(free[:, None], tn, t),
            jnp.where(free, sn, s),
        )

    R, t, s = jax.lax.fori_loop(0, iters, gn_step, (g.R, g.t, g.s))
    return g._replace(R=R, t=t, s=s)


def correct_landmarks(
    lm_pos: jnp.ndarray,      # (M,3) world positions
    lm_ref_kf: jnp.ndarray,   # (M,) reference KF per landmark
    lm_valid: jnp.ndarray,
    R_old, t_old, s_old,      # (K,...) pre-correction Scw
    R_new, t_new, s_new,      # (K,...) post-correction Scw
) -> jnp.ndarray:
    """Propagate pose-graph corrections to landmarks through their reference
    keyframe: x' = S_new_wc( S_old_cw(x) ) (reference src/LoopClosing.cc:
    CorrectLoop map-point update, and Optimizer::OptimizeEssentialGraph's
    final landmark correction)."""
    Ro, to, so = R_old[lm_ref_kf], t_old[lm_ref_kf], s_old[lm_ref_kf]
    Rn, tn, sn = R_new[lm_ref_kf], t_new[lm_ref_kf], s_new[lm_ref_kf]
    p_cam = lie.sim3_apply(Ro, to, so, lm_pos)
    Rni, tni, sni = lie.sim3_inv(Rn, tn, sn)
    p_new = lie.sim3_apply(Rni, tni, sni, p_cam)
    return jnp.where(lm_valid[:, None], p_new, lm_pos)
