"""Monocular-inertial SLAM system (IMU_MONOCULAR mode).

Extends the monocular orchestrator with the reference's inertial machinery
(reference src/Tracking.cc:454-570 PreintegrateIMU, :572 PredictStateIMU;
src/LocalMapping.cc:198-241 staged InitializeIMU; src/IMU/IMU_Manager.cpp):

- per-frame preintegration windows merged into per-keyframe factors,
- IMU dead-reckoning as the motion model once initialized,
- one-shot inertial initialization (gravity dir, metric scale, biases,
  velocities) followed by gravity-aligning + rescaling the whole map,
- visual-inertial local BA (optim/vi_ba.py) after each keyframe.

Bias handling is first-order: preintegrations are stored with the bias they
were integrated at and corrected through their bias Jacobians at use — the
reference's Reintegrate-on-bias-update becomes unnecessary.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.geometry import camera as cam_mod, lie
from eorb_slam_tpu.imu import preintegration as pre_mod
from eorb_slam_tpu.optim import inertial, marginalize, vi_ba
from eorb_slam_tpu.slam import local_mapping, map_state, tracking
from eorb_slam_tpu.slam.system import (
    LOST, NOT_INITIALIZED, OK, RECENTLY_LOST, FrameInput, MonoSlam,
    _post_track_update,
)


@dataclasses.dataclass
class ImuChunk:
    """IMU samples between the previous and current frame."""

    gyro: np.ndarray   # (S,3)
    acc: np.ndarray    # (S,3)
    dts: np.ndarray    # (S,)


def _stack_identity_pre(K: int) -> pre_mod.Preintegrated:
    one = pre_mod.identity_preintegrated()
    return jax.tree_util.tree_map(
        lambda x: jnp.tile(x[None], (K,) + (1,) * x.ndim), one
    )


@jax.jit
def _write_kf_imu_state(pre_kf, kf_vel, kf_bg, kf_ba, slot, pre_window,
                        vel, bg, ba):
    """One dispatch for the per-KF inertial-state writes instead of a
    dozen eager .at[].set ops."""
    pre_kf = jax.tree_util.tree_map(
        lambda s, x: s.at[slot].set(x), pre_kf, pre_window
    )
    return (pre_kf, kf_vel.at[slot].set(vel), kf_bg.at[slot].set(bg),
            kf_ba.at[slot].set(ba))


@jax.jit
def _imu_predict(T_last, vel, pre_last, bg, ba, Tbc):
    """Fused PredictStateIMU: body-frame forward integration of the last
    inter-frame preintegration, returned as (T_pred, motion-model velocity,
    body velocity)."""
    Twb = pre_mod.Twb_from_Tcw(T_last, Tbc)
    R2, p2, v2 = pre_mod.predict_state(
        Twb[:3, :3], Twb[:3, 3], vel, pre_last, bg, ba
    )
    Twb2 = jnp.eye(4).at[:3, :3].set(R2).at[:3, 3].set(p2)
    T_pred = pre_mod.Tcw_from_Twb(Twb2, Tbc)
    return T_pred, T_pred @ lie.se3_inv(T_last), v2


@jax.jit
def _visual_velocity(T_prev, T_cur, dt, vel_fallback, Tbc):
    """Body velocity from the finite difference of optimized poses; keeps
    the predicted velocity when the window is degenerate (dt ~ 0)."""
    p1 = pre_mod.Twb_from_Tcw(T_prev, Tbc)[:3, 3]
    p2 = pre_mod.Twb_from_Tcw(T_cur, Tbc)[:3, 3]
    v = (p2 - p1) / jnp.maximum(dt, 1e-4)
    return jnp.where(dt > 1e-4, v, vel_fallback)


@functools.partial(
    jax.jit,
    static_argnames=("max_kp", "img_w", "img_h", "use_prior"),
)
def _vi_frame_step(
    img: jnp.ndarray,           # (H,W) uint8
    cam_params: jnp.ndarray,
    m: map_state.MapState,
    gyro: jnp.ndarray,          # (S,3) padded IMU window since last frame
    acc: jnp.ndarray,           # (S,3)
    dts: jnp.ndarray,           # (S,)
    imu_ok: jnp.ndarray,        # (S,) bool
    T_last: jnp.ndarray,        # (4,4) last frame pose
    vel: jnp.ndarray, bg: jnp.ndarray, ba: jnp.ndarray,
    pre_since_kf: pre_mod.Preintegrated,   # KF -> last frame window
    T_kf: jnp.ndarray, vel_kf: jnp.ndarray,
    prior: marginalize.PoseImuPrior,
    ref_T: jnp.ndarray,         # (4,4) trajectory reference KF pose
    calib: pre_mod.ImuCalib,
    min_inl_retry: jnp.ndarray,  # () int32 — wide re-search threshold
    max_kp: int = 512, img_w: int = 752, img_h: int = 480,
    use_prior: bool = False,
):
    """The ENTIRE inertial per-frame step as ONE dispatch: preintegrate the
    inter-frame IMU window -> PredictStateIMU -> ORB extraction ->
    projection matching (with a wide re-search fallback under lax.cond) ->
    motion-only visual-inertial optimization -> packed host flags.

    It replaces a chain of separate integrate / predict / extract / track /
    retry / VI-opt dispatches with host pulls between them.

    ``use_prior`` selects the reference's per-frame optimizer alternation
    (src/Tracking.cc:1959-1984): False = PoseInertialOptimizationLastKeyFrame
    (src/Optimizer.cc:8606) against (T_kf, vel_kf) over the accumulated
    KF->frame window; True = PoseInertialOptimizationLastFrame
    (src/Optimizer.cc:9006) against the marginal PoseImuPrior carried from
    the previous frame over the frame->frame window. Both emit the next
    frame's prior (ConstraintPoseImu, include/G2oTypes.h:600).

    Returns (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred,
    pre_frame, pre_since_kf_new, vel_out, bg_out, ba_out, next_prior).
    """
    from eorb_slam_tpu.ops import frontend

    # 1. preintegrate the inter-frame window (zero-bias integration; bias
    # enters through the stored Jacobians at every use site)
    pre = pre_mod.integrate(
        gyro, acc, dts, imu_ok, jnp.zeros(3), jnp.zeros(3), calib
    )
    pre_since2 = pre_mod.merge(pre_since_kf, pre)

    # 2. PredictStateIMU
    Twb = pre_mod.Twb_from_Tcw(T_last, calib.Tbc)
    R2, p2, v2 = pre_mod.predict_state(
        Twb[:3, :3], Twb[:3, 3], vel, pre, bg, ba
    )
    Twb2 = jnp.eye(4).at[:3, :3].set(R2).at[:3, 3].set(p2)
    T_pred = pre_mod.Tcw_from_Twb(Twb2, calib.Tbc)

    # 3. extraction + projection tracking
    feats = frontend.extract(img, max_kp=max_kp)
    xy_ud = cam_mod.undistort_points(cam_params, feats.xy)
    res0 = tracking.track_frame(
        m, cam_params, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
        T_pred, img_w=img_w, img_h=img_h,
    )
    res = jax.lax.cond(
        res0.n_inliers < min_inl_retry,
        lambda: tracking.track_frame(
            m, cam_params, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
            T_pred, img_w=img_w, img_h=img_h,
            search_radius=40.0, nn_ratio=0.95,
        ),
        lambda: res0,
    )

    # 4. motion-only VI optimization
    matched = res.feat_lm >= 0
    pts_w = m.lm_pos[jnp.where(matched, res.feat_lm, 0)]
    inv_sigma = frontend.inv_sigma(feats.octave)
    if use_prior:
        Tcw, vel_o, bg_o, ba_o, inlier, n_vi, next_prior = \
            marginalize.pose_inertial_optimization_last_frame(
                cam_params, res.Tcw, v2, bg, ba,
                pts_w, xy_ud, inv_sigma, matched,
                prior, pre, calib.Tbc,
            )
    else:
        Tcw, vel_o, bg_o, ba_o, inlier, n_vi, H = \
            vi_ba.pose_inertial_optimization(
                cam_params, res.Tcw, v2, bg, ba,
                pts_w, xy_ud, inv_sigma, matched,
                T_kf, vel_kf, pre_since2, calib.Tbc,
                return_H=True,
            )
        next_prior = marginalize.PoseImuPrior(Tcw, vel_o, bg_o, ba_o, H)

    feat_lm = jnp.where(inlier, res.feat_lm, -1)
    res = res._replace(Tcw=Tcw, feat_lm=feat_lm, inlier=inlier,
                       n_inliers=n_vi)
    flags = jnp.stack([
        n_vi.astype(jnp.float32),
        jnp.isfinite(Tcw).all().astype(jnp.float32),
    ])
    vel_mm = Tcw @ lie.se3_inv(T_last)
    T_rel = Tcw @ lie.se3_inv(ref_T)
    return (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred,
            pre, pre_since2, vel_o, bg_o, ba_o, next_prior)


class MonoInertialSlam(MonoSlam):
    """Monocular + IMU pipeline (config 2 of BASELINE.json)."""

    def __init__(self, cam_params, calib: pre_mod.ImuCalib,
                 min_kf_imu_init: int = 6, min_time_imu_init: float = 1.5,
                 max_kf_dt: float = 0.5,
                 **kw):
        super().__init__(cam_params, **kw)
        self.calib = calib
        self.min_kf_imu_init = min_kf_imu_init
        self.min_time_imu_init = min_time_imu_init
        # inertial modes force a KF on elapsed time so preintegration
        # factors stay short and scale/gravity remain well-conditioned
        # (reference NeedNewKeyFrame IMU branch, src/Tracking.cc:2083)
        self.max_kf_dt = max_kf_dt

        K = self.map.K
        self.pre_kf = _stack_identity_pre(K)       # factor: kf_prev[k] -> k
        # temporal predecessor slot per KF slot (-1 = chain head). Slots are
        # reused after keyframe culling, so the inertial chain is explicit
        # (reference merges preintegrations on KF culling,
        # IMU::Preintegrated::MergePrevious).
        self.kf_prev = np.full(K, -1, np.int32)
        self.kf_vel = jnp.zeros((K, 3), jnp.float32)
        self.kf_bg = jnp.zeros((K, 3), jnp.float32)
        self.kf_ba = jnp.zeros((K, 3), jnp.float32)

        self.imu_initialized = False
        self._init_kf_count = 0
        self.bg = jnp.zeros(3, jnp.float32)
        self.ba = jnp.zeros(3, jnp.float32)
        self.vel = jnp.zeros(3, jnp.float32)       # current body velocity
        self.pre_since_kf = pre_mod.identity_preintegrated()
        self.pre_last_frame = pre_mod.identity_preintegrated()
        # marginal prior on the last frame's 15-dof state (ConstraintPoseImu
        # carried between frames); None = map updated since the last frame
        # -> next frame optimizes against the last KEYFRAME instead
        # (reference mbMapUpdated alternation, src/Tracking.cc:1959-1984)
        self._prior = None
        self.scale_applied = 1.0
        # world transforms (Ryw, s) applied by IMU init / scale refinement,
        # queued for a paired event tracker to replay on ITS map (reference
        # System::ApplyScaleAndRotationEvSynch, src/LoopClosing.cc:2075-2094)
        self.pending_world_transforms: list = []
        self._last_refine_s = 1.0
        # consecutive frames where the IMU prediction failed but a plain
        # visual search succeeded — a weakly determined init leaves the
        # inertial state inconsistent with the map; at 3 the scale/gravity
        # refinement is pulled forward
        self._imu_inconsistent = 0
        # init convergence gate (chi2 per residual dof); healthy solves
        # measure 0.03-0.10, divergent ones 20-800 (r5); event/MCI chains
        # carry visual pose noise above the IMU-noise whitening and sit
        # at 2-4 when healthy
        self.imu_init_max_chi2 = 3.0
        # per-attempt scale estimates (stability acceptance path)
        self._init_scale_hist: list = []
        self._refine_scale_hist: list = []
        # stereo/RGB-D inertial variants fix the (already metric) scale
        # (reference InitializeIMU bFixedScale for non-monocular sensors)
        self._imu_fix_scale = False

    # ---------------------------------------------------------------- input

    def process_image_imu(self, img, ts: float, imu: ImuChunk,
                          max_kp: int | None = None):
        """One camera frame + its IMU window from a RAW image: when the
        filter is initialized and tracking, the whole step runs as ONE
        fused dispatch (_vi_frame_step); otherwise falls back to separate
        extraction + the staged init path."""
        if not (self.imu_initialized and self.state == OK):
            from eorb_slam_tpu.ops import frontend

            feats = frontend.extract(jnp.asarray(img),
                                     max_kp=max_kp or self.map.N)
            xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
            return self.process_features_imu(
                FrameInput(ts, xy_ud, feats.octave, feats.angle,
                           feats.desc_pm1, feats.valid), imu)

        self.stats["frames"] += 1
        # pad the IMU window to a power-of-two bucket: a stable trace per
        # bucket instead of a re-trace per sample count
        S = int(imu.gyro.shape[0])
        cap = 8
        while cap < S:
            cap *= 2
        gyro = np.zeros((cap, 3), np.float32)
        acc = np.zeros((cap, 3), np.float32)
        dts = np.zeros(cap, np.float32)
        ok = np.zeros(cap, bool)
        gyro[:S] = imu.gyro; acc[:S] = imu.acc; dts[:S] = imu.dts
        ok[:S] = True

        last = self._kf_order[-1]
        ref = self._kf_ref()
        use_prior = self._prior is not None
        prior = self._prior if use_prior else marginalize.PoseImuPrior(
            jnp.eye(4), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3),
            jnp.zeros((15, 15)),
        )
        (res, feats, xy_ud, flags, vel_mm, T_rel, T_pred, pre, pre_since2,
         vel_o, bg_o, ba_o, next_prior) = _vi_frame_step(
            jnp.asarray(img), self.cam, self.map,
            jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
            jnp.asarray(ok),
            self.T_last, self.vel, self.bg, self.ba,
            self.pre_since_kf, self.map.kf_T[last], self.kf_vel[last],
            prior, self.map.kf_T[ref], self.calib,
            jnp.asarray(self.min_track_inliers, jnp.int32),
            max_kp=max_kp or self.map.N,
            img_w=self.img_w, img_h=self.img_h,
            use_prior=use_prior,
        )
        f = FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        self.last_frame = f
        # the IMU window is consumed regardless of tracking outcome
        # (dead-reckoning and the next KF factor both need it)
        self.pre_last_frame = pre
        self.pre_since_kf = pre_since2
        self._T_pred = T_pred

        n_inl, finite = (float(x) for x in np.asarray(flags))
        n_inl = int(n_inl)
        if not finite:
            self._prior = None
            return self._handle_lost(f, 0)
        if n_inl < max(6, self.min_track_inliers // 2):
            self._prior = None
            return self._handle_lost(f, n_inl)

        self.last_track = res
        self.lost_frames = 0
        self.state = OK
        self.velocity = vel_mm
        self.T_last = res.Tcw
        self.vel = vel_o
        self.bg = bg_o
        self.ba = ba_o
        self._prior = next_prior
        self.frames_since_kf += 1
        self.trajectory.append((ts, T_rel, ref))

        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def process_features_imu(self, f: FrameInput, imu: ImuChunk):
        """One frame with the IMU samples since the previous frame."""
        if imu.gyro.shape[0] > 0:
            pre = pre_mod.integrate(
                jnp.asarray(imu.gyro, jnp.float32),
                jnp.asarray(imu.acc, jnp.float32),
                jnp.asarray(imu.dts, jnp.float32),
                jnp.ones(imu.gyro.shape[0], bool),
                jnp.zeros(3), jnp.zeros(3), self.calib,
            )
        else:
            pre = pre_mod.identity_preintegrated()
        self.pre_last_frame = pre
        self.pre_since_kf = pre_mod.merge(self.pre_since_kf, pre)
        return self.process_features(f)

    # ------------------------------------------------------ overridden hooks

    def _try_initialize(self, f: FrameInput):
        ref_before = self._init_frame
        out = super()._try_initialize(f)
        if self.state == OK:
            # founding keyframes created: the accumulated window since the
            # reference frame is the KF0 -> KF1 inertial factor
            self.pre_kf = jax.tree_util.tree_map(
                lambda s, x: s.at[1].set(x), self.pre_kf, self.pre_since_kf
            )
            self.kf_prev[:] = -1
            self.kf_prev[1] = 0
            self.pre_since_kf = pre_mod.identity_preintegrated()
        elif self._init_frame is f and ref_before is not f:
            # reference frame was replaced: restart the accumulation window
            self.pre_since_kf = pre_mod.identity_preintegrated()
        return out

    def _track(self, f: FrameInput):
        if not self.imu_initialized:
            return super()._track(f)
        return self._track_inertial(f)

    def _track_inertial(self, f: FrameInput):
        """Per-frame tracking once the IMU is initialized: IMU dead-reckoning
        prediction, projection matching, then MOTION-ONLY VISUAL-INERTIAL
        optimization of the 15-dof frame state against the last keyframe
        (reference Optimizer::PoseInertialOptimizationLastKeyFrame,
        src/Optimizer.cc:8606, dispatched at src/Tracking.cc:1959-1984).
        The inertial factor keeps the pose metric and scale-consistent even
        when visual inliers collapse."""
        prev_ts = self.last_frame.ts if self.last_frame is not None else None
        self.last_frame = f
        T_last0, vel0 = self.T_last, self.vel
        # PredictStateIMU — one fused dispatch
        T_pred, vel_mm, v2 = _imu_predict(
            self.T_last, self.vel, self.pre_last_frame,
            self.bg, self.ba, self.calib.Tbc,
        )
        self._T_pred = T_pred
        self.velocity = vel_mm
        self.vel = v2

        res = tracking.track_frame(
            self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
            T_pred, img_w=self.img_w, img_h=self.img_h,
        )
        n_vis = int(res.n_inliers)
        if n_vis < self.min_track_inliers:
            res = tracking.track_frame(
                self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                T_pred, img_w=self.img_w, img_h=self.img_h,
                search_radius=40.0, nn_ratio=0.95,
            )
            n_vis = int(res.n_inliers)
        if n_vis < self.min_track_inliers:
            # the IMU prediction itself may be the problem — a weakly
            # determined inertial init (short chain, low excitation) can
            # leave scale/velocity inconsistent with the map, in which case
            # EVERY IMU-predicted search misses while the map is still
            # perfectly trackable visually. Retry from the last pose (the
            # reference's TrackReferenceKeyFrame fallback), and on success
            # repair the inertial state instead of going lost (measured:
            # event-IMU died on the frame after init, r5 trace).
            res_v = tracking.track_frame(
                self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                T_last0, img_w=self.img_w, img_h=self.img_h,
                search_radius=40.0, nn_ratio=0.95,
            )
            n_vv = int(res_v.n_inliers)
            if n_vv >= self.min_track_inliers and bool(
                    jnp.isfinite(res_v.Tcw).all()):
                self._imu_inconsistent += 1
                Tcw = res_v.Tcw
                self.last_track = res_v
                self.lost_frames = 0
                self.state = OK
                ref = self._kf_ref()
                vel_mm2, T_rel = _post_track_update(
                    Tcw, T_last0, self.map.kf_T[ref])
                self.velocity = vel_mm2
                self.T_last = Tcw
                # world velocity from the visual pose delta (finite
                # difference) — the IMU-propagated one just proved wrong
                dtf = (max(f.ts - prev_ts, 1e-3)
                       if prev_ts is not None else 1e-1)
                Cw0 = -T_last0[:3, :3].T @ T_last0[:3, 3]
                Cw1 = -Tcw[:3, :3].T @ Tcw[:3, 3]
                self.vel = (Cw1 - Cw0) / dtf
                self.frames_since_kf += 1
                self.trajectory.append((f.ts, T_rel, ref))
                if self._imu_inconsistent >= 3:
                    # persistent disagreement: re-estimate scale/gravity/
                    # biases over the full chain (staged refinement pulled
                    # forward)
                    self._scale_refinement()
                    self._imu_inconsistent = 0
                out = {"state": self.state, "n_inliers": n_vv,
                       "kf": False, "visual_rescue": True}
                if (n_vv < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
                        or self.frames_since_kf >= self.max_frames_between_kf):
                    self._insert_keyframe(f, res_v)
                    out.update(kf=True, n_lm=self.stats["lm"])
                return out

        # motion-only VI refinement against the last keyframe's state,
        # using the accumulated KF->frame preintegration window
        from eorb_slam_tpu.ops import frontend

        last = self._kf_order[-1]
        matched = res.feat_lm >= 0
        pts_w = self.map.lm_pos[jnp.where(matched, res.feat_lm, 0)]
        Tcw, vel, bg, ba, inlier, n_vi = vi_ba.pose_inertial_optimization(
            self.cam, res.Tcw, self.vel, self.bg, self.ba,
            pts_w, f.xy_ud, frontend.inv_sigma(f.octave), matched,
            self.map.kf_T[last], self.kf_vel[last], self.pre_since_kf,
            self.calib.Tbc,
        )
        n_inl = int(n_vi)
        if not bool(jnp.isfinite(Tcw).all()):
            return self._handle_lost(f, 0)
        # with an inertial factor the pose stays usable below the visual
        # threshold (the reference keeps OK with >=10 map matches and falls
        # back to dead-reckoning below that)
        if n_inl < max(6, self.min_track_inliers // 2):
            return self._handle_lost(f, n_inl)

        feat_lm = jnp.where(inlier, res.feat_lm, -1)
        res = res._replace(Tcw=Tcw, feat_lm=feat_lm, inlier=inlier,
                           n_inliers=n_vi)
        self.last_track = res
        self.lost_frames = 0
        self._imu_inconsistent = 0
        self.state = OK
        ref = self._kf_ref()
        vel_mm2, T_rel = _post_track_update(Tcw, self.T_last,
                                            self.map.kf_T[ref])
        self.velocity = vel_mm2
        self.T_last = Tcw
        self.vel = vel
        self.bg = bg
        self.ba = ba
        self.frames_since_kf += 1
        self.trajectory.append((f.ts, T_rel, ref))

        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res)
            # n_lm lags one keyframe by design (deferred _drain_mapping —
            # tracking never blocks on the in-flight mapping dispatch)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _handle_lost(self, f: FrameInput, n_inl: int):
        """Inertial RECENTLY_LOST: dead-reckon on the IMU prediction through
        the dropout instead of freezing (reference PredictStateIMU branch,
        src/Tracking.cc:928) — then fall back to the visual recovery path."""
        self._prior = None
        if (self.imu_initialized and self.lost_frames < self.lost_grace
                and getattr(self, "_T_pred", None) is not None):
            self.stats["lost"] += 1
            self.lost_frames += 1
            self.state = RECENTLY_LOST
            self.T_last = self._T_pred
            self._log_pose(f.ts, self._T_pred)
            return {"state": self.state, "n_inliers": n_inl,
                    "dead_reckoned": True}
        return super()._handle_lost(f, n_inl)

    def _need_kf_extra(self, f) -> bool:
        # host-cached timestamp: pulling map.kf_ts off-device every frame
        # would be a blocking round trip
        if self.n_kf == 0 or self._last_kf_ts is None:
            return False
        return (f.ts - self._last_kf_ts) >= self.max_kf_dt

    def _insert_keyframe(self, f: FrameInput, res, n_inl=None):
        prev_slot = self._kf_order[-1] if self._kf_order else -1
        pre_window = self.pre_since_kf
        super()._insert_keyframe(f, res, n_inl)  # allocates slot, runs local BA
        # map updated -> next frame re-anchors on the keyframe state
        self._prior = None
        slot = self.last_kf_slot

        self.pre_kf, self.kf_vel, self.kf_bg, self.kf_ba = \
            _write_kf_imu_state(
                self.pre_kf, self.kf_vel, self.kf_bg, self.kf_ba,
                jnp.asarray(slot), pre_window, self.vel, self.bg, self.ba,
            )
        self.kf_prev[slot] = prev_slot
        self.pre_since_kf = pre_mod.identity_preintegrated()

        if not self.imu_initialized:
            self._maybe_initialize_imu()
        else:
            self._vi_local_ba()
            # staged scale/gravity refinement while the map is young
            # (reference LocalMapping::ScaleRefinement windows,
            # src/LocalMapping.cc:244-255): every keyframe until the
            # correction settles at 1 — each refit is multiplicative, so
            # early stops leave a residual scale error on short sequences
            since_init = self._kf_seq_next - self._init_kf_count
            if since_init <= 16 or abs(self._last_refine_s - 1.0) > 0.05:
                self._scale_refinement()

    def _on_cull_keyframe(self, slot: int) -> None:
        """Stitch the inertial chain across the culled keyframe: the
        successor inherits the merged preintegration (reference
        IMU::Preintegrated::MergePrevious on KeyFrameCulling,
        src/LocalMapping.cc)."""
        succ = np.flatnonzero(self.kf_prev == slot)
        if succ.size:
            n = int(succ[0])
            merged = pre_mod.merge(
                jax.tree_util.tree_map(lambda x: x[slot], self.pre_kf),
                jax.tree_util.tree_map(lambda x: x[n], self.pre_kf),
            )
            self.pre_kf = jax.tree_util.tree_map(
                lambda s, x: s.at[n].set(x), self.pre_kf, merged
            )
            self.kf_prev[n] = self.kf_prev[slot]
        self.kf_prev[slot] = -1

    def _imu_chain_masks(self, free_slots=None):
        """(edge_valid, prev) device arrays for the active inertial chain;
        with `free_slots`, only edges whose newer endpoint is free."""
        K = self.map.K
        ev = np.zeros(K, bool)
        for s in self._kf_order:
            ev[s] = self.kf_prev[s] >= 0
        if free_slots is not None:
            in_free = np.zeros(K, bool)
            in_free[list(free_slots)] = True
            ev &= in_free
        return jnp.asarray(ev), jnp.asarray(self.kf_prev)

    # ----------------------------------------------------------- imu stages

    def _maybe_initialize_imu(self):
        if self.n_kf < self.min_kf_imu_init:
            return
        order = self._kf_order
        ts = np.asarray(self.map.kf_ts)
        if ts[order[-1]] - ts[order[0]] < self.min_time_imu_init:
            return

        K = self.map.K
        Tbc = self.calib.Tbc
        Twb = jax.vmap(lambda T: pre_mod.Twb_from_Tcw(T, Tbc))(self.map.kf_T)
        edge_valid, prev = self._imu_chain_masks()
        res = inertial.inertial_init(
            Twb, self.pre_kf, edge_valid,
            prior_gyro=1e2, prior_acc=1e6, iters=60,
            fix_scale=self._imu_fix_scale, prev=prev,
        )
        if not np.isfinite(float(res.cost)) or float(res.scale) < 1e-3:
            return
        # convergence gate: a weakly determined solve (short chain, low
        # excitation) returns an arbitrary scale whose application — and
        # the FullInertialBA that follows — destroys the visual map.
        # Healthy inits land at chi2/dof 0.03-0.10 (measured, r5); the
        # collapsing event-IMU init sat at ~35. Reject and retry at the
        # next keyframe with more baseline — the reference staggers init
        # attempts the same way (src/LocalMapping.cc:198-241). A
        # stability-of-estimate acceptance (consecutive attempts agreeing)
        # was tried and rejected: estimator bias is systematic, so wrong
        # estimates agree with each other (measured, r5).
        n_edges = int((np.asarray(edge_valid) & (np.asarray(prev) >= 0)).sum())
        chi2_dof = float(res.cost) / max(9 * n_edges, 1)
        self._init_scale_hist.append(float(res.scale))
        if chi2_dof > self.imu_init_max_chi2:
            return

        # gravity-align: rotate the world so g maps onto (0,0,-9.81)
        g_est = np.asarray(res.g)
        g_tgt = np.asarray([0.0, 0.0, -pre_mod.GRAVITY])
        v = np.cross(g_est, g_tgt)
        s_ang = np.linalg.norm(v) / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
        c_ang = g_est @ g_tgt / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
        if s_ang > 1e-8:
            axis = v / np.linalg.norm(v)
            Ryw = np.asarray(
                lie.so3_exp(jnp.asarray(axis * np.arctan2(s_ang, c_ang),
                                        jnp.float32))
            )
        else:
            Ryw = np.eye(3, dtype=np.float32)
        Ryw = jnp.asarray(Ryw)
        s = res.scale

        Twb2, lm2, vel2 = inertial.apply_scaled_rotation(
            Twb, self.map.lm_pos, res.vel, Ryw, s
        )
        kf_T2 = jax.vmap(lambda T: pre_mod.Tcw_from_Twb(T, Tbc))(Twb2)
        self.map = self.map._replace(kf_T=kf_T2, lm_pos=lm2)
        self._rescale_trajectory(float(s), Ryw)
        self.kf_vel = vel2
        self.bg = res.bg
        self.ba = res.ba
        self.kf_bg = jnp.tile(res.bg[None], (K, 1))
        self.kf_ba = jnp.tile(res.ba[None], (K, 1))
        last = self._kf_order[-1]
        self.vel = vel2[last]
        self.T_last = self._transform_inflight_pose(Ryw, s)
        self.velocity = jnp.eye(4)
        self.imu_initialized = True
        self._init_kf_count = self._kf_seq_next
        self.scale_applied = float(s)
        self.pending_world_transforms.append(
            (np.asarray(Ryw, np.float32), float(s))
        )

        self._vi_local_ba(full=True)

    def _transform_inflight_pose(self, Ryw, s) -> jnp.ndarray:
        """Map the IN-FLIGHT frame pose through the gravity-align/rescale
        world transform. Rewinding T_last to the last keyframe's pose here
        (the previous behavior) left the next frame's prediction behind the
        camera's true position — measured: event-IMU tracking lost on the
        frame right after IMU init (r5 trace). The reference transforms the
        current frame alongside the map (Map::ApplyScaledRotation +
        Tracking::UpdateFrameIMU, src/LocalMapping.cc:198-241)."""
        Tbc = self.calib.Tbc
        Twb_f = pre_mod.Twb_from_Tcw(self.T_last, Tbc)
        Rwb = Ryw @ Twb_f[:3, :3]
        pwb = s * (Ryw @ Twb_f[:3, 3])
        Twb2 = jnp.eye(4, dtype=Twb_f.dtype)
        Twb2 = Twb2.at[:3, :3].set(lie.project_so3(Rwb))
        Twb2 = Twb2.at[:3, 3].set(pwb)
        return pre_mod.Tcw_from_Twb(Twb2, Tbc)

    def _scale_refinement(self):
        """Re-estimate (scale, gravity dir, biases, velocities) over all
        keyframes and re-apply; corrects the coarse first estimate once more
        baseline has accumulated."""
        K = self.map.K
        Tbc = self.calib.Tbc
        Twb = jax.vmap(lambda T: pre_mod.Twb_from_Tcw(T, Tbc))(self.map.kf_T)
        edge_valid, prev = self._imu_chain_masks()
        res = inertial.inertial_init(
            Twb, self.pre_kf, edge_valid,
            prior_gyro=1.0, prior_acc=1e4, iters=40,
            fix_scale=self._imu_fix_scale, prev=prev,
        )
        s = float(res.scale)
        # wide sanity window only: a refit over MORE baseline regularly has
        # to correct a poor first init by several x (the reference's
        # ScaleRefinement applies its estimate ungated whenever |s-1| is
        # significant, src/LocalMapping.cc:244-255)
        if not np.isfinite(s) or not (0.1 < s < 10.0):
            return
        # same convergence gate as the first init: an unconverged refit
        # must not be applied (see imu_init_max_chi2). NOTE a
        # stability-of-estimate path (accept when consecutive refits agree)
        # was tried and MEASURABLY destructive: estimator bias is
        # systematic, so consecutive wrong estimates agree (room_01 VI went
        # 3.3% -> 46% of path when two agreeing garbage refits applied, r5)
        n_edges = int((np.asarray(edge_valid) & (np.asarray(prev) >= 0)).sum())
        if float(res.cost) / max(9 * n_edges, 1) > self.imu_init_max_chi2:
            return
        self._last_refine_s = s
        g_est = np.asarray(res.g)
        g_tgt = np.asarray([0.0, 0.0, -pre_mod.GRAVITY])
        v = np.cross(g_est, g_tgt)
        s_ang = np.linalg.norm(v) / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
        c_ang = g_est @ g_tgt / (np.linalg.norm(g_est) * pre_mod.GRAVITY)
        if s_ang > 1e-8:
            axis = v / np.linalg.norm(v)
            Ryw = jnp.asarray(np.asarray(lie.so3_exp(jnp.asarray(
                axis * np.arctan2(s_ang, c_ang), jnp.float32))))
        else:
            Ryw = jnp.eye(3)
        Twb2, lm2, vel2 = inertial.apply_scaled_rotation(
            Twb, self.map.lm_pos, res.vel, Ryw, res.scale
        )
        kf_T2 = jax.vmap(lambda T: pre_mod.Tcw_from_Twb(T, Tbc))(Twb2)
        self.map = self.map._replace(kf_T=kf_T2, lm_pos=lm2)
        self._rescale_trajectory(s, Ryw)
        self.kf_vel = vel2
        self.bg = res.bg
        self.ba = res.ba
        self.kf_bg = jnp.tile(res.bg[None], (K, 1))
        self.kf_ba = jnp.tile(res.ba[None], (K, 1))
        last = self._kf_order[-1]
        self.vel = vel2[last]
        self.T_last = self._transform_inflight_pose(Ryw, s)
        self.scale_applied *= s
        self.pending_world_transforms.append(
            (np.asarray(Ryw, np.float32), float(s))
        )
        # re-solve structure+poses with inertial factors at the new scale
        # (the reference follows InertialOptimization with FullInertialBA,
        # src/IMU/IMU_Manager.cpp:322-371)
        self._vi_local_ba(full=True)

    def _vi_local_ba(self, full: bool = False):
        from eorb_slam_tpu.ops import frontend
        from eorb_slam_tpu.optim import schur_ba

        m = self.map
        order = self._kf_order
        lo = 1 if full else max(1, len(order) - self.local_window)
        free_slots = order[lo:]
        kf_free = np.zeros(m.K, bool)
        kf_free[free_slots] = True

        obs_uv = m.kf_xy[m.obs_kf, m.obs_feat]
        obs_oct = m.kf_octave[m.obs_kf, m.obs_feat]
        visual = schur_ba.BAProblem(
            cam_params=self.cam,
            kf_T=m.kf_T,
            kf_fixed=jnp.asarray(~kf_free),
            kf_valid=m.kf_valid,
            lm_pos=m.lm_pos,
            lm_valid=m.lm_valid,
            obs_kf=m.obs_kf,
            obs_uv=obs_uv,
            obs_inv_sigma=frontend.inv_sigma(obs_oct),
            obs_valid=m.obs_valid & m.kf_valid[m.obs_kf],
        )
        edge_valid, prev = self._imu_chain_masks(free_slots)
        prob = vi_ba.VIBAProblem(
            visual=visual, Tbc=self.calib.Tbc,
            kf_vel=self.kf_vel, kf_bg=self.kf_bg, kf_ba=self.kf_ba,
            pre=self.pre_kf, edge_valid=edge_valid, g=pre_mod.GRAVITY_W,
            prev=prev,
        )
        # the reference's FullInertialBA runs 100 iterations at init; the
        # scale/gravity gauge direction moves slowly, so full solves get a
        # deeper budget than the per-KF local refinement
        res = vi_ba.vi_bundle_adjust(prob, iters=24 if full else 8)
        new_obs_valid = m.obs_valid & (res.obs_inlier | (m.lm_nobs[:, None] <= 2))
        self.map = m._replace(
            kf_T=res.kf_T, lm_pos=res.lm_pos, obs_valid=new_obs_valid,
            lm_nobs=jnp.sum(new_obs_valid, axis=1, dtype=jnp.int32),
        )
        self.kf_vel = res.kf_vel
        self.kf_bg = res.kf_bg
        self.kf_ba = res.kf_ba
        last = self._kf_order[-1]
        self.T_last = res.kf_T[last]
        self.vel = res.kf_vel[last]
        self.bg = res.kf_bg[last]
        self.ba = res.kf_ba[last]
