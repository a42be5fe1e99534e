"""Masked Levenberg-Marquardt bundle adjustment with Schur landmark elimination.

This single engine replaces the reference's g2o recipe zoo — Optimizer::
{BundleAdjustment, GlobalBundleAdjustemnt, LocalBundleAdjustment} and the
visual parts of MyOptimizer/EvOptimizer (reference src/Optimizer.cc:53,
:2353; src/Utils/MyOptimizer.cpp; src/Event/EvOptimizer.cpp). Pose-only,
local-window, and global BA are all *configurations* (which poses are
masked fixed) of the same jitted function.

Data layout
-----------
Observations are **landmark-major**: a fixed-shape table ``(M, P)`` where
``M`` = landmark capacity and ``P`` = max observations per landmark. This
makes the Schur products dense einsums:

  V_m     = sum_p  Jl^T W Jl                      (M,3,3)
  U_k     = scatter-add_p Jp^T W Jp               (K,6,6)
  W_mp    = Jp^T W Jl                             (M,P,6,3)
  Y_mp    = W_mp V_m^-1                           (M,P,6,3)
  S      -= Y_mp W_mq^T  scattered at (k_p,k_q)   (K,K,6,6)

The reduced camera system S is solved **dense** — for the local-BA window
sizes of ORB-SLAM-class problems (K <= a few hundred) a dense 6Kx6K solve
is a few dense matrix kernels instead of sparse scalar code. Landmark back-substitution is a closed-form batched 3x3 solve.

Fixed-shape everything: validity masks instead of dynamic graphs. Invalid
slots carry zero weight and point at index 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.optim import linalg, reprojection, robust


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. All arrays are device arrays.

    K = pose slots, M = landmark slots, P = obs slots per landmark.
    """

    cam_params: jnp.ndarray   # (9,) shared pinhole intrinsics (linear part)
    kf_T: jnp.ndarray         # (K,4,4) Tcw
    kf_fixed: jnp.ndarray     # (K,) bool — pose held constant
    kf_valid: jnp.ndarray     # (K,) bool — slot in use
    lm_pos: jnp.ndarray       # (M,3) world points
    lm_valid: jnp.ndarray     # (M,) bool
    obs_kf: jnp.ndarray       # (M,P) int32 pose index per observation
    obs_uv: jnp.ndarray       # (M,P,2) undistorted pixel observations
    obs_inv_sigma: jnp.ndarray  # (M,P) sqrt information (1/sigma_octave)
    obs_valid: jnp.ndarray    # (M,P) bool


class BAResult(NamedTuple):
    kf_T: jnp.ndarray
    lm_pos: jnp.ndarray
    obs_inlier: jnp.ndarray   # (M,P) bool — chi2 gate after optimization
    cost0: jnp.ndarray        # robust cost before
    cost: jnp.ndarray         # robust cost after


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate), safe for masked blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det_safe = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    inv = adj / det_safe[..., None, None]
    return jnp.where((jnp.abs(det) < 1e-12)[..., None, None], 0.0, inv)


def _inv3x3_cols(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a (3,3,N) stack — column layout (the batch
    axis stays last and contiguous)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    bad = jnp.abs(det) < 1e-12
    inv_det = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, det))
    adj = jnp.stack([
        jnp.stack([A11, A12, A13]),
        jnp.stack([A21, A22, A23]),
        jnp.stack([A31, A32, A33]),
    ])
    return adj * inv_det[None, None, :]


def _residuals_and_weights(p: BAProblem, kf_T, lm_pos, use_huber):
    """Per-observation residual, robust weight, chi2. Shapes (M,P,...)."""
    T_obs = kf_T[p.obs_kf]                      # (M,P,4,4)
    pts = jnp.broadcast_to(lm_pos[:, None, :], p.obs_uv.shape[:2] + (3,))
    pc = lie.se3_apply(T_obs, pts)              # (M,P,3)
    from eorb_slam_tpu.geometry import camera as cam

    uv_hat = cam.pinhole_project_linear(p.cam_params, pc)
    r = (p.obs_uv - uv_hat) * p.obs_inv_sigma[..., None]
    chi2 = jnp.sum(r * r, axis=-1)
    valid = (
        p.obs_valid
        & p.lm_valid[:, None]
        & p.kf_valid[p.obs_kf]
        & (pc[..., 2] > 0.0)
    )
    w_rob = jnp.where(use_huber, robust.huber_weight(chi2, robust.CHI2_MONO), 1.0)
    w = w_rob * valid.astype(r.dtype)
    return r, w, chi2, valid, pc


def _robust_cost(chi2, valid, use_huber):
    c = jnp.where(use_huber, robust.huber_cost(chi2, robust.CHI2_MONO), chi2)
    return jnp.sum(c * valid)


def _schur_pieces(p: BAProblem, kf_T, lm_pos, lam, use_huber):
    """Local (per-landmark-shard) Schur pieces — lane-layout path.

    Returns (S, b_s, Wf, Vinv, b_l) where S (K,K,6,6) carries U on the
    diagonal and -Y W^T off it, b_s (K,6) is the reduced RHS, and Wf
    (K*6, M, 3) is the pose-landmark cross block used by back-substitution.
    Under landmark sharding S/b_s are partial sums — psum them over the
    shard axis before `_solve_cameras`; (Wf, Vinv, b_l) stay local.

    The pose/point Jacobians are written as closed-form elementwise stacks
    (the standard ORB-SLAM pinhole forms, reference src/OptimizableTypes.h
    EdgeSE3ProjectXYZ::linearizeOplus) instead of per-observation 2x3 @ 3x6
    matmuls: 16k tiny matmuls lower to padded VPU loops, while one fused
    elementwise stack is a single kernel.

    Layout rule: every per-observation quantity here is a flat
    ``(coeff, M*P)`` array — small coefficient axes (6, 3, 36...) first,
    the long observation axis last and contiguous, so no trailing dim of 3
    or 6 is padded. The reductions are then three GEMMs:

      U   = Up36 (36,MP) @ onehot (MP,K)          block-diag camera system
      Wf  = per-landmark P-contraction (batched over M)
      S  -= Y (K6,3M) @ Wf (K6,3M)^T              Schur off-diagonal
    """
    K = kf_T.shape[0]
    M, P = p.obs_uv.shape[:2]
    MP = M * P
    dtype = kf_T.dtype

    # gather pose rows as flat 12-vectors [R row-major | t] — a (MP,12)
    # gather instead of (M,P,4,4) whose trailing (4,4) tile pads 32x
    kf_flat = jnp.concatenate(
        [kf_T[:, :3, :3].reshape(K, 9), kf_T[:, :3, 3]], axis=1
    )                                            # (K,12)
    obs_kf_f = p.obs_kf.reshape(MP)
    Tg = kf_flat[obs_kf_f]                       # (MP,12)
    R = [Tg[:, i] for i in range(9)]             # R[3*r+c]
    t0, t1, t2 = Tg[:, 9], Tg[:, 10], Tg[:, 11]

    X0 = jnp.repeat(lm_pos[:, 0], P)             # (MP,) world point coords
    Y0 = jnp.repeat(lm_pos[:, 1], P)
    Z0 = jnp.repeat(lm_pos[:, 2], P)
    x = R[0] * X0 + R[1] * Y0 + R[2] * Z0 + t0
    y = R[3] * X0 + R[4] * Y0 + R[5] * Z0 + t1
    z = R[6] * X0 + R[7] * Y0 + R[8] * Z0 + t2

    fx, fy, cx, cy = (p.cam_params[0], p.cam_params[1],
                      p.cam_params[2], p.cam_params[3])
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    xz = x * iz
    yz = y * iz
    s = p.obs_inv_sigma.reshape(MP)
    rA = (p.obs_uv[..., 0].reshape(MP) - (fx * xz + cx)) * s
    rB = (p.obs_uv[..., 1].reshape(MP) - (fy * yz + cy)) * s
    chi2 = rA * rA + rB * rB
    valid = (
        p.obs_valid.reshape(MP)
        & p.lm_valid.repeat(P)
        & p.kf_valid[obs_kf_f]
        & (z > 0)
    )
    w_rob = jnp.where(use_huber, robust.huber_weight(chi2, robust.CHI2_MONO), 1.0)
    w = w_rob * valid.astype(dtype)              # (MP,)

    # residual Jacobians J = -d(uv_hat)/d(state) * inv_sigma, elementwise.
    # Pose convention: xi = [t, omega], T <- exp(xi) T, so d pc/d xi = [I | -hat(pc)].
    a = fx * iz
    b = fy * iz
    ns = -s
    one = jnp.ones_like(xz)
    zero = jnp.zeros_like(xz)
    # zero pose Jacobian for fixed cameras: they contribute only to V, b_l
    cf = (~p.kf_fixed)[obs_kf_f].astype(dtype)
    nsc = ns * cf
    JpA = jnp.stack([                            # (6,MP) residual row u
        nsc * a, zero, nsc * a * -xz,
        nsc * -fx * xz * yz, nsc * fx * (one + xz * xz), nsc * -fx * yz,
    ])
    JpB = jnp.stack([                            # (6,MP) residual row v
        zero, nsc * b, nsc * b * -yz,
        nsc * -fy * (one + yz * yz), nsc * fy * xz * yz, nsc * fy * xz,
    ])
    JlA = jnp.stack([(ns * a) * (R[j] - xz * R[6 + j]) for j in range(3)])
    JlB = jnp.stack([(ns * b) * (R[3 + j] - yz * R[6 + j]) for j in range(3)])

    # landmark blocks: V (3,3,M), b_l (3,M) — contraction over p only
    V9 = (w * (JlA[:, None] * JlA[None] + JlB[:, None] * JlB[None]))  # (3,3,MP)
    V = V9.reshape(3, 3, M, P).sum(-1)
    b_l = -(w * (JlA * rA + JlB * rB)).reshape(3, M, P).sum(-1)       # (3,M)
    trV = V[0, 0] + V[1, 1] + V[2, 2]
    V_d = V + (lam * jnp.maximum(trV / 3.0, 1e-6)) * jnp.eye(3, dtype=dtype)[
        :, :, None
    ]
    lm_free = p.lm_valid.astype(dtype)
    Vinv = _inv3x3_cols(V_d) * lm_free[None, None, :]                 # (3,3,M)

    # camera blocks: one GEMM against the one-hot assignment.  Each residual
    # row has support on exactly one 6-wide pose block, so this IS the
    # block-diagonal U — no scatter-add.
    O2 = jax.nn.one_hot(obs_kf_f, K, dtype=dtype)                     # (MP,K)
    Up = (w * (JpA[:, None] * JpA[None] + JpB[:, None] * JpB[None]))  # (6,6,MP)
    U = (Up.reshape(36, MP) @ O2).T.reshape(K, 6, 6)
    bj = -(w * (JpA * rA + JpB * rB))                                 # (6,MP)
    b_c = (bj @ O2).T                                                 # (K,6)

    # cross block Wf[(k,j),l,m] = sum_p onehot * (w Jp^T Jl): contraction
    # over p batched per landmark, M stays in lanes
    WB = (w * (JpA[:, None] * JlA[None] + JpB[:, None] * JlB[None]))  # (6,3,MP)
    Wf = jnp.einsum(
        "wmp,mpk->kwm", WB.reshape(18, M, P), O2.reshape(M, P, K)
    ).reshape(K * 6, 3, M)
    Y = jnp.einsum("axm,xym->aym", Wf, Vinv)                          # (K6,3,M)

    Yf = Y.reshape(K * 6, 3 * M)
    S_flat = -(Yf @ Wf.reshape(K * 6, 3 * M).T)                       # (K6,K6)
    S = S_flat.reshape(K, 6, K, 6).transpose(0, 2, 1, 3)
    S = S.at[jnp.arange(K), jnp.arange(K)].add(U)

    # reduced rhs: b_s = b_c - Y b_l
    b_s = b_c - (Yf @ b_l.reshape(3 * M)).reshape(K, 6)
    return S, b_s, Wf, Vinv, b_l


def _schur_pieces_ref(p: BAProblem, kf_T, lm_pos, lam, use_huber):
    """Reference einsum formulation of `_schur_pieces` (kept for parity
    tests of the layout-tuned path)."""
    K = kf_T.shape[0]
    M, P = p.obs_uv.shape[:2]
    dtype = kf_T.dtype

    T_obs = kf_T[p.obs_kf]
    pts = jnp.broadcast_to(lm_pos[:, None, :], (M, P, 3))
    pc = lie.se3_apply(T_obs, pts)
    from eorb_slam_tpu.geometry import camera as cam

    uv_hat = cam.pinhole_project_linear(p.cam_params, pc)
    r = (p.obs_uv - uv_hat) * p.obs_inv_sigma[..., None]
    chi2 = jnp.sum(r * r, axis=-1)
    valid = (
        p.obs_valid & p.lm_valid[:, None] & p.kf_valid[p.obs_kf] & (pc[..., 2] > 0)
    )
    w_rob = jnp.where(use_huber, robust.huber_weight(chi2, robust.CHI2_MONO), 1.0)
    w = w_rob * valid.astype(dtype)  # (M,P)

    # Jacobians (of the residual): J_pose (M,P,2,6), J_point (M,P,2,3)
    Jproj = cam.pinhole_project_jac_point(p.cam_params, pc)  # (M,P,2,3)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (M, P, 3, 3))
    dpc_dx = jnp.concatenate([I3, -lie.hat(pc)], axis=-1)    # (M,P,3,6)
    Jp = -(Jproj @ dpc_dx) * p.obs_inv_sigma[..., None, None]
    R_obs = lie.se3_rot(T_obs)
    Jl = -(Jproj @ R_obs) * p.obs_inv_sigma[..., None, None]

    # zero pose Jacobian for fixed cameras: they contribute only to V, b_l
    cam_free = (~p.kf_fixed)[p.obs_kf].astype(dtype)[..., None, None]  # (M,P,1,1)
    Jp = Jp * cam_free

    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]

    # landmark blocks
    V = jnp.einsum("mpij,mpik->mjk", wJl, Jl)                 # (M,3,3)
    b_l = -jnp.einsum("mpij,mpi->mj", wJl, r)                 # (M,3)
    V_d = V + lam * jnp.eye(3, dtype=dtype)[None] * jnp.maximum(
        jnp.trace(V, axis1=-2, axis2=-1)[..., None, None] / 3.0, 1e-6
    )
    lm_free = p.lm_valid.astype(dtype)
    Vinv = _inv3x3(V_d) * lm_free[:, None, None]

    # camera blocks — one-hot contractions instead of scatter-add (a
    # choice to re-measure against scatter-add on the GPU)
    O = jax.nn.one_hot(p.obs_kf, K, dtype=dtype)              # (M,P,K)
    U_obs = jnp.einsum("mpij,mpik->mpjk", wJp, Jp)            # (M,P,6,6)
    b_c_obs = -jnp.einsum("mpij,mpi->mpj", wJp, r)            # (M,P,6)
    U = jnp.einsum("mpk,mpij->kij", O, U_obs)                 # (K,6,6)
    b_c = jnp.einsum("mpk,mpi->ki", O, b_c_obs)               # (K,6)

    # cross blocks + Schur pieces
    W_blk = jnp.einsum("mpij,mpik->mpjk", wJp, Jl)            # (M,P,6,3)
    Y = W_blk @ Vinv[:, None]                                 # (M,P,6,3)

    # S_off[a,b] = sum_m sum_pq O[m,p,a] Y_mp W_mq^T O[m,q,b]
    #            = sum_m G[m,a] H[m,b]^T  — never materializes (M,P,P,...)
    G = jnp.einsum("mpa,mpij->maij", O, Y)                    # (M,K,6,3)
    Hm = jnp.einsum("mpa,mpij->maij", O, W_blk)               # (M,K,6,3)
    S_off = jnp.einsum("maij,mbkj->abik", G, Hm)              # (K,K,6,6)

    S = -S_off
    S = S.at[jnp.arange(K), jnp.arange(K)].add(U)

    # reduced rhs: b_s = b_c - sum_m G[m,k] b_l_m
    b_s = b_c - jnp.einsum("maij,mj->ai", G, b_l)
    # repack into the column layouts of the fast path for parity
    Wf = Hm.transpose(1, 2, 3, 0).reshape(K * 6, 3, M)        # (K6,3,M)
    return S, b_s, Wf, Vinv.transpose(1, 2, 0), b_l.T


def _solve_cameras(p: BAProblem, S, b_s, lam):
    """Damp + gauge-mask the (already psum'd) reduced system, dense solve."""
    K = S.shape[0]
    dtype = S.dtype
    # damping on camera diagonal (from the assembled Schur diagonal)
    diag_scale = jnp.maximum(
        jnp.trace(S[jnp.arange(K), jnp.arange(K)], axis1=-2, axis2=-1)[
            :, None, None
        ]
        / 6.0,
        1e-6,
    )
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        lam * jnp.eye(6, dtype=dtype)[None] * diag_scale
    )

    # mask fixed/invalid cameras: identity row/col, zero rhs
    free = (p.kf_valid & ~p.kf_fixed).astype(dtype)           # (K,)
    mask2 = free[:, None] * free[None, :]
    S = S * mask2[:, :, None, None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        jnp.eye(6, dtype=dtype)[None] * (1.0 - free)[:, None, None]
    )
    b_s = b_s * free[:, None]

    S_dense = S.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    # Jacobi-preconditioned Cholesky: f32 + pixel^2 information needs the
    # unit-scale fix (see optim/linalg.py)
    dx_c = linalg.solve_spd_jacobi(S_dense, b_s.reshape(-1)).reshape(K, 6)
    return dx_c * free[:, None]


def _backsub_landmarks(p: BAProblem, Wf, Vinv, b_l, dx_c):
    """Landmark update (local to the shard): dx_l = Vinv (b_l - W^T dx_c).

    ``Wf`` (K*6,3,M), ``Vinv`` (3,3,M), ``b_l`` (3,M) are the column-layout
    cross/landmark blocks from `_schur_pieces` — the correction is one
    contraction against the flattened pose update, no per-observation
    gather. Returns (M,3)."""
    corr = jnp.einsum("alm,a->lm", Wf, dx_c.reshape(-1))      # (3,M)
    lm_free = p.lm_valid.astype(dx_c.dtype)
    dx_l = jnp.einsum("ijm,jm->mi", Vinv, b_l - corr)         # (M,3)
    return dx_l * lm_free[:, None]


def _build_and_solve(p: BAProblem, kf_T, lm_pos, lam, use_huber, axis_name=None):
    """One damped GN step: returns (dx_cam (K,6), dx_lm (M,3)).

    With ``axis_name`` set (inside shard_map over a landmark shard), the
    reduced camera system is psum'd over the mesh axis so every device
    solves the identical global system; back-substitution stays local."""
    S, b_s, W_blk, Vinv, b_l = _schur_pieces(p, kf_T, lm_pos, lam, use_huber)
    if axis_name is not None:
        S = jax.lax.psum(S, axis_name)
        b_s = jax.lax.psum(b_s, axis_name)
    dx_c = _solve_cameras(p, S, b_s, lam)
    dx_l = _backsub_landmarks(p, W_blk, Vinv, b_l, dx_c)
    return dx_c, dx_l


def _lm_loop(p: BAProblem, iters: int, lam0: float, axis_name=None) -> BAResult:
    """Levenberg-Marquardt loop. Accept/reject per iteration with lambda control.

    g2o's OptimizationAlgorithmLevenberg equivalence: lambda shrinks by 2 on
    success, grows by 10 on failure (bounded), state reverts on failure.
    With ``axis_name``, runs inside shard_map over a landmark shard: the cost
    and the reduced camera system are psum'd, so the accept/reject decision
    and the pose update are bit-identical across devices."""
    dtype = p.kf_T.dtype
    use_huber = jnp.asarray(True)

    # cost accounting uses the STATIC validity (no cheirality gate): a step
    # that pushes points behind the camera must read as a huge cost, not as
    # "fewer residuals". Otherwise a divergent (even NaN) step that kills
    # every observation scores cost 0 and gets accepted.
    valid_static = p.obs_valid & p.lm_valid[:, None] & p.kf_valid[p.obs_kf]

    def total_cost(kf_T, lm_pos):
        _, _, chi2, _, pc = _residuals_and_weights(p, kf_T, lm_pos, use_huber)
        c = jnp.where(
            use_huber, robust.huber_cost(chi2, robust.CHI2_MONO), chi2
        )
        c = jnp.where(pc[..., 2] > 0.0, c, 1e6)  # cheirality penalty
        c = jnp.sum(c * valid_static)            # NaN chi2 -> NaN cost -> reject
        if axis_name is not None:
            c = jax.lax.psum(c, axis_name)
        return c

    cost0 = total_cost(p.kf_T, p.lm_pos)

    def body(_, state):
        kf_T, lm_pos, lam, cost = state
        dx_c, dx_l = _build_and_solve(
            p, kf_T, lm_pos, lam, use_huber, axis_name=axis_name
        )
        kf_T_new = jax.vmap(lambda d, T: lie.se3_project(lie.se3_exp(d) @ T))(
            dx_c, kf_T
        )
        lm_new = lm_pos + dx_l
        cost_new = total_cost(kf_T_new, lm_new)
        accept = cost_new < cost
        kf_T = jnp.where(accept, kf_T_new, kf_T)
        lm_pos = jnp.where(accept, lm_new, lm_pos)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 10.0, 1e4))
        cost = jnp.where(accept, cost_new, cost)
        return kf_T, lm_pos, lam, cost

    kf_T, lm_pos, lam, cost = jax.lax.fori_loop(
        0, iters, body, (p.kf_T, p.lm_pos, jnp.asarray(lam0, dtype), cost0)
    )

    _, _, chi2_f, valid_f, pc = _residuals_and_weights(p, kf_T, lm_pos, use_huber)
    inlier = valid_f & (chi2_f <= robust.CHI2_MONO)
    return BAResult(kf_T, lm_pos, inlier, cost0, cost)


@functools.partial(jax.jit, static_argnames=("iters",))
def bundle_adjust(p: BAProblem, iters: int = 10, lam0: float = 1e-4) -> BAResult:
    """Single-device Levenberg-Marquardt BA (see `_lm_loop`)."""
    return _lm_loop(p, iters, lam0)
