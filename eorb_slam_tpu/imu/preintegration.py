"""On-manifold IMU preintegration (Forster et al.) as a jitted scan.

Equivalent of ``IMU::Preintegrated`` (reference
src/IMU/ImuTypes.cc, include/IMU/ImuTypes.h:155-267): fixed-shape
measurement windows ``(S,3)`` with validity masks, integrated by
``lax.scan``; state order is (R, V, P) + (bg, ba) exactly as the
reference's 15x15 covariance layout, so the information matrix feeds the
9-dim inertial residual (optim/inertial.py) the same way ``EdgeInertial``
consumes ``GetInformationMatrix`` (reference include/G2oTypes.h:60-822).

Bias updates do NOT re-run the scan: first-order bias Jacobians
(JRg, JVg, JVa, JPg, JPa) give corrected deltas in closed form
(``delta_corrected``), mirroring ``GetDeltaRotation/Velocity/Position``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.geometry import lie

GRAVITY = 9.81
GRAVITY_W = jnp.asarray([0.0, 0.0, -GRAVITY], jnp.float32)


class ImuCalib(NamedTuple):
    """IMU calibration (reference ``IMU::Calib``, include/IMU/ImuTypes.h)."""

    Tbc: jnp.ndarray        # (4,4) camera pose in body frame: p_b = Tbc p_c
    gyro_noise: jnp.ndarray  # () rad/s/sqrt(Hz) * sqrt(freq)  (discrete sigma)
    acc_noise: jnp.ndarray   # () m/s^2 discrete sigma
    gyro_walk: jnp.ndarray   # () discrete random-walk sigma
    acc_walk: jnp.ndarray    # ()


def make_calib(Tbc=None, gyro_noise=1.7e-4, acc_noise=2e-3,
               gyro_walk=1.9e-5, acc_walk=3e-3, freq=200.0) -> ImuCalib:
    """Continuous-time densities -> discrete sigmas at ``freq`` (the
    reference multiplies by sqrt(freq) when parsing YAML, src/Utils/
    MyParameters.cpp IMU section)."""
    sf = jnp.sqrt(jnp.asarray(freq, jnp.float32))
    if Tbc is None:
        Tbc = jnp.eye(4, dtype=jnp.float32)
    return ImuCalib(
        Tbc=jnp.asarray(Tbc, jnp.float32),
        gyro_noise=jnp.asarray(gyro_noise, jnp.float32) * sf,
        acc_noise=jnp.asarray(acc_noise, jnp.float32) * sf,
        gyro_walk=jnp.asarray(gyro_walk, jnp.float32) / sf,
        acc_walk=jnp.asarray(acc_walk, jnp.float32) / sf,
    )


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames (leading batch dims allowed)."""

    dt: jnp.ndarray      # () total time
    dR: jnp.ndarray      # (3,3)
    dV: jnp.ndarray      # (3,)
    dP: jnp.ndarray      # (3,)
    C: jnp.ndarray       # (15,15) covariance, order (R,V,P,bg,ba)
    JRg: jnp.ndarray     # (3,3) d dR / d bg
    JVg: jnp.ndarray     # (3,3)
    JVa: jnp.ndarray     # (3,3)
    JPg: jnp.ndarray     # (3,3)
    JPa: jnp.ndarray     # (3,3)
    bg0: jnp.ndarray     # (3,) gyro bias used during integration
    ba0: jnp.ndarray     # (3,) acc bias used during integration


def identity_preintegrated(bg0=None, ba0=None) -> Preintegrated:
    z3 = jnp.zeros(3, jnp.float32)
    return Preintegrated(
        dt=jnp.zeros((), jnp.float32),
        dR=jnp.eye(3, dtype=jnp.float32),
        dV=z3, dP=z3,
        C=jnp.zeros((15, 15), jnp.float32),
        JRg=jnp.zeros((3, 3), jnp.float32),
        JVg=jnp.zeros((3, 3), jnp.float32),
        JVa=jnp.zeros((3, 3), jnp.float32),
        JPg=jnp.zeros((3, 3), jnp.float32),
        JPa=jnp.zeros((3, 3), jnp.float32),
        bg0=z3 if bg0 is None else jnp.asarray(bg0, jnp.float32),
        ba0=z3 if ba0 is None else jnp.asarray(ba0, jnp.float32),
    )


def integrate(
    gyro: jnp.ndarray,   # (S,3)
    acc: jnp.ndarray,    # (S,3)
    dts: jnp.ndarray,    # (S,)
    valid: jnp.ndarray,  # (S,) bool — masked samples are skipped (dt=0)
    bg0: jnp.ndarray,
    ba0: jnp.ndarray,
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate a masked window of IMU samples.

    Mirrors ``IMU::Preintegrated::IntegrateNewMeasurement`` (reference
    src/IMU/ImuTypes.cc): position/velocity first with the *old* dR, then
    the covariance propagation C <- A C A^T + B Nga B^T, bias Jacobians,
    and finally the rotation update dR <- dR Exp((w-bg) dt).

    Samples are midpoint-averaged with their in-window predecessor before
    integration (the reference's Tracking::PreintegrateIMU interpolates
    consecutive measurements the same way, src/Tracking.cc:454-570): the
    raw backward-rectangle rule leaves an O(dt*dw) rotation error that
    telescopes to dt/2*(w_end - w_start) per window — on rotation-rich
    trajectories that error sits 5-10x above the gyro noise floor and made
    every live inertial-init attempt fail its convergence gate (room_01 VI
    chi2/dof 20-50 vs ~0.1 on smooth motion, r5 measured).
    """
    dtype = jnp.float32
    prev_ok = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
    gyro = jnp.where(
        prev_ok[:, None],
        0.5 * (gyro + jnp.concatenate([gyro[:1], gyro[:-1]])), gyro)
    acc = jnp.where(
        prev_ok[:, None],
        0.5 * (acc + jnp.concatenate([acc[:1], acc[:-1]])), acc)
    Nga = jnp.diag(
        jnp.concatenate([
            jnp.full(3, calib.gyro_noise**2),
            jnp.full(3, calib.acc_noise**2),
        ])
    ).astype(dtype)
    Nwalk = jnp.concatenate([
        jnp.full(3, calib.gyro_walk**2),
        jnp.full(3, calib.acc_walk**2),
    ]).astype(dtype)

    def step(carry, x):
        pre = carry
        w, a, dt, ok = x
        dt = jnp.where(ok, dt, 0.0).astype(dtype)
        w = (w - bg0) * jnp.where(ok, 1.0, 0.0)
        a = (a - ba0) * jnp.where(ok, 1.0, 0.0)

        dR, dV, dP = pre.dR, pre.dV, pre.dP
        ahat = lie.hat(a)

        # position/velocity with the old rotation
        dP_new = dP + dV * dt + 0.5 * (dR @ a) * dt * dt
        dV_new = dV + (dR @ a) * dt

        # A (9x9) / B (9x6) blocks for (R,V,P) noise propagation
        dRi = lie.so3_exp(w * dt)
        Jr = lie.so3_right_jacobian(w * dt)
        A = jnp.zeros((9, 9), dtype)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-dR @ ahat * dt)
        A = A.at[6:9, 0:3].set(-0.5 * dR @ ahat * dt * dt)
        A = A.at[3:6, 3:6].set(jnp.eye(3, dtype=dtype))
        A = A.at[6:9, 6:9].set(jnp.eye(3, dtype=dtype))
        A = A.at[6:9, 3:6].set(jnp.eye(3, dtype=dtype) * dt)
        B = jnp.zeros((9, 6), dtype)
        B = B.at[0:3, 0:3].set(Jr * dt)
        B = B.at[3:6, 3:6].set(dR * dt)
        B = B.at[6:9, 3:6].set(0.5 * dR * dt * dt)

        C9 = A @ pre.C[:9, :9] @ A.T + B @ Nga @ B.T
        Cw = pre.C[9:, 9:] + jnp.diag(Nwalk) * dt
        C = pre.C.at[:9, :9].set(C9).at[9:, 9:].set(Cw)

        # bias Jacobians (update order mirrors the reference)
        JPa = pre.JPa + pre.JVa * dt - 0.5 * dR * dt * dt
        JPg = pre.JPg + pre.JVg * dt - 0.5 * (dR @ ahat @ pre.JRg) * dt * dt
        JVa = pre.JVa - dR * dt
        JVg = pre.JVg - (dR @ ahat @ pre.JRg) * dt
        JRg = dRi.T @ pre.JRg - Jr * dt

        dR_new = lie.project_so3(dR @ dRi)
        new = Preintegrated(
            dt=pre.dt + dt, dR=dR_new, dV=dV_new, dP=dP_new, C=C,
            JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
            bg0=pre.bg0, ba0=pre.ba0,
        )
        return new, None

    init = identity_preintegrated(bg0, ba0)
    out, _ = jax.lax.scan(step, init, (gyro, acc, dts, valid))
    return out


def merge(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose consecutive preintegrations (reference ``MergePrevious``).

    Assumes both were integrated with the same bias (p1.bg0 == p2.bg0).
    Covariance composed to first order via the state transition of the
    second segment acting on the first segment's covariance."""
    dR = lie.project_so3(p1.dR @ p2.dR)
    dV = p1.dV + p1.dR @ p2.dV
    dP = p1.dP + p1.dV * p2.dt + p1.dR @ p2.dP

    JRg = p2.dR.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg  # note: cross rotation term folded in p2.JVg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * p2.dt + p1.dR @ p2.JPg
    JPa = p1.JPa + p1.JVa * p2.dt + p1.dR @ p2.JPa

    # state transition of segment-2 deltas w.r.t. segment-1 (R,V,P) state
    A = jnp.zeros((9, 9), p1.C.dtype)
    A = A.at[0:3, 0:3].set(p2.dR.T)
    A = A.at[3:6, 0:3].set(-p1.dR @ lie.hat(p2.dV) @ p1.dR.T)
    A = A.at[6:9, 0:3].set(-p1.dR @ lie.hat(p2.dP) @ p1.dR.T)
    A = A.at[3:6, 3:6].set(jnp.eye(3, dtype=p1.C.dtype))
    A = A.at[6:9, 3:6].set(jnp.eye(3, dtype=p1.C.dtype) * p2.dt)
    A = A.at[6:9, 6:9].set(jnp.eye(3, dtype=p1.C.dtype))
    C9 = A @ p1.C[:9, :9] @ A.T + p2.C[:9, :9]
    C = p1.C.at[:9, :9].set(C9).at[9:, 9:].set(p1.C[9:, 9:] + p2.C[9:, 9:])
    return Preintegrated(
        dt=p1.dt + p2.dt, dR=dR, dV=dV, dP=dP, C=C,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        bg0=p1.bg0, ba0=p1.ba0,
    )


def delta_corrected(pre: Preintegrated, bg: jnp.ndarray, ba: jnp.ndarray):
    """First-order bias-corrected deltas (reference GetDeltaRotation/
    Velocity/Position, src/IMU/ImuTypes.cc)."""
    dbg = bg - pre.bg0
    dba = ba - pre.ba0
    dR = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    return dR, dV, dP


def information_9(pre: Preintegrated) -> jnp.ndarray:
    """9x9 information of the (R,V,P) deltas (reference
    GetInformationMatrix keeps the 9x9 block and symmetrizes)."""
    C = 0.5 * (pre.C[:9, :9] + pre.C[:9, :9].T)
    C = C + jnp.eye(9, dtype=C.dtype) * 1e-10
    info = jnp.linalg.inv(C)
    return 0.5 * (info + info.T)


def predict_state(
    Rwb: jnp.ndarray, pwb: jnp.ndarray, vwb: jnp.ndarray,
    pre: Preintegrated, bg: jnp.ndarray, ba: jnp.ndarray,
    g: jnp.ndarray = GRAVITY_W,
):
    """IMU dead-reckoning (reference Tracking::PredictStateIMU,
    src/Tracking.cc:572): propagate the body state through the window."""
    dR, dV, dP = delta_corrected(pre, bg, ba)
    t = pre.dt
    Rwb2 = lie.project_so3(Rwb @ dR)
    vwb2 = vwb + g * t + Rwb @ dV
    pwb2 = pwb + vwb * t + 0.5 * g * t * t + Rwb @ dP
    return Rwb2, pwb2, vwb2


def Twb_from_Tcw(Tcw: jnp.ndarray, Tbc: jnp.ndarray) -> jnp.ndarray:
    """Body-in-world pose from camera-from-world: Twb = Tcw^-1 @ Tbc^-1...

    Convention: p_b = Tbc p_c (camera pose in body), p_c = Tcw p_w, so
    Twb = (Tbc @ Tcw)^-1."""
    return lie.se3_inv(Tbc @ Tcw)


def Tcw_from_Twb(Twb: jnp.ndarray, Tbc: jnp.ndarray) -> jnp.ndarray:
    return lie.se3_inv(Twb @ Tbc)
