"""Event-inertial SLAM modes: EVENT_IMU and EVENT_IMU_MONO.

Equivalent of the reference's event-side inertial stack —
``IMU_Manager`` (multi-channel measurement queues + per-event-frame
preintegration + staged initializeIMU/scaleRefinement, reference
src/IMU/IMU_Manager.cpp:79-493) wired into the event trackers
(src/Event/EvTrackManager.cpp:87-92, src/Event/EvAsynchTracker.cpp:
1457-1461) and, in EVENT_IMU_MONO, into the image tracker too
(System::TrackEvMono grabs IMU for both sides, src/System.cc:917-925).

Here the "IMU manager" collapses to a host-side sample buffer sliced at
each event-frame timestamp: the L2 event tracker IS the inertial pipeline
(slam/vi_system.MonoInertialSlam instantiated over reconstructed MCIs), so
preintegration, staged gravity/scale initialization, dead-reckoning
prediction, and VI local BA all come from the one shared implementation
instead of the reference's per-tracker clones (EvOptimizer's inertial
variants, src/Event/EvOptimizer.cpp:1567-3193).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.event import builder as ev_builder
from eorb_slam_tpu.geometry import camera as cam_mod
from eorb_slam_tpu.imu import preintegration as pre_mod
from eorb_slam_tpu.ops import frontend
from eorb_slam_tpu.slam import ev_image_system, system as slam_system
from eorb_slam_tpu.slam.vi_system import ImuChunk, MonoInertialSlam


class ImuBuffer:
    """Timestamped IMU sample queue sliced into inter-frame chunks
    (IMU_Manager's per-channel SharedQueue + preintegrateIMU window logic,
    reference src/IMU/IMU_Manager.cpp:64-120)."""

    def __init__(self):
        self._ts = np.zeros(0, np.float64)
        self._gyro = np.zeros((0, 3), np.float32)
        self._acc = np.zeros((0, 3), np.float32)
        self._last_t: Optional[float] = None

    def push(self, ts: np.ndarray, gyro: np.ndarray, acc: np.ndarray):
        self._ts = np.concatenate([self._ts, np.asarray(ts, np.float64)])
        self._gyro = np.concatenate(
            [self._gyro, np.asarray(gyro, np.float32).reshape(-1, 3)]
        )
        self._acc = np.concatenate(
            [self._acc, np.asarray(acc, np.float32).reshape(-1, 3)]
        )

    def push_chunk(self, t1: float, chunk: ImuChunk):
        """Append a pre-sliced chunk whose samples end at ``t1`` (uniform
        spacing assumed from chunk.dts)."""
        n = chunk.gyro.shape[0]
        if n == 0:
            return
        ts = t1 - np.cumsum(chunk.dts[::-1])[::-1] + chunk.dts
        self.push(ts, chunk.gyro, chunk.acc)

    def window(self, t1: float) -> ImuChunk:
        """Pop all samples with ts <= t1 into one chunk; dt of the first
        sample spans from the previous window's end."""
        sel = self._ts <= t1
        ts = self._ts[sel]
        gyro = self._gyro[sel]
        acc = self._acc[sel]
        self._ts = self._ts[~sel]
        self._gyro = self._gyro[~sel]
        self._acc = self._acc[~sel]
        t_prev = self._last_t if self._last_t is not None else (
            float(ts[0]) - (float(ts[1] - ts[0]) if len(ts) > 1 else 0.005)
            if len(ts) else t1
        )
        self._last_t = t1
        if len(ts) == 0:
            return ImuChunk(
                gyro=np.zeros((0, 3), np.float32),
                acc=np.zeros((0, 3), np.float32),
                dts=np.zeros(0, np.float32),
            )
        dts = np.diff(ts, prepend=t_prev).astype(np.float32)
        dts = np.clip(dts, 1e-5, 0.1)
        return ImuChunk(gyro=gyro, acc=acc, dts=dts)


class EventInertialSlam:
    """EVENT_IMU mode: event windows + IMU, no intensity images (reference
    System::TrackEvent with vImuMeas, src/System.cc:800-866 ->
    EvTrackManager::grabImuData -> IMU_Manager). The L2 tracker over MCIs is
    a full monocular-inertial pipeline, so the event map becomes metric and
    gravity-aligned once the IMU initializes."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        calib: pre_mod.ImuCalib,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        max_kp: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 30,
        min_track_inliers: int = 8,
        min_kf_imu_init: int = 5,
        min_time_imu_init: float = 1.0,
        seed: int = 0,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params)
        self.max_kp = max_kp
        self.imu = ImuBuffer()
        self.l2 = MonoInertialSlam(
            cam_params, calib,
            img_w=self.cfg.img_w, img_h=self.cfg.img_h,
            K=K, M=M, N=max_kp, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers,
            min_kf_imu_init=min_kf_imu_init,
            min_time_imu_init=min_time_imu_init,
            seed=seed,
        )
        # no fuse over MCIs (see EventSlam): the reference's event mapper
        # has no SearchInNeighbors pass and coarse event features make
        # duplicate-merging net-harmful for the VI estimate
        self.l2.fuse_enabled = False
        self._T_prev_mci: Optional[np.ndarray] = None
        self.n_mci = 0
        self.n_tracked = 0

    def grab_imu(self, ts: np.ndarray, gyro: np.ndarray, acc: np.ndarray):
        """EvTrackManager::grabImuData (src/Event/EvTrackManager.cpp)."""
        self.imu.push(ts, gyro, acc)

    def track_events(self, events: np.ndarray) -> list[dict]:
        # batched window path: one dispatch per L1 window, no per-chunk
        # host loop (see builder.step_window)
        self.builder.feed(events)
        out = []
        while True:
            pi = self.builder.step_window()
            if pi is None:
                break
            out.append(self._track_mci(pi))
        return out

    def _track_mci(self, pi: ev_builder.PoseImage) -> dict:
        self.n_mci += 1
        img = jnp.asarray(pi.img * 255.0, jnp.float32)
        chunk = self.imu.window(pi.ts)
        if self.l2.imu_initialized and self.l2.state == slam_system.OK:
            # fused ONE-dispatch VI frame step on the MCI (extraction +
            # predict + track + motion-only VI opt inside one jit instead
            # of a separate extract/track/opt chain)
            res = self.l2.process_image_imu(img, pi.ts, chunk,
                                            max_kp=self.max_kp)
        else:
            feats = frontend.extract(img, max_kp=self.max_kp)
            xy_ud = cam_mod.undistort_points(self.l2.cam, feats.xy)
            f = slam_system.FrameInput(
                pi.ts, xy_ud, feats.octave, feats.angle, feats.desc_pm1,
                feats.valid,
            )
            res = self.l2.process_features_imu(f, chunk)
        res = dict(res, ts=pi.ts, mci_kind=pi.best_kind,
                   imu_init=self.l2.imu_initialized)

        if self.l2.state == slam_system.OK:
            self.n_tracked += 1
            # PoseDepthInfo feedback stays ON DEVICE (no host pull; the
            # window jit consumes the arrays directly)
            T_cur = self.l2.T_last
            if self._T_prev_mci is not None:
                self.builder.set_pose_prior(
                    self._T_prev_mci, T_cur, self._median_scene_depth(T_cur)
                )
            self._T_prev_mci = T_cur
        return res

    def _median_scene_depth(self, Tcw):
        """KeyFrame::ComputeSceneMedianDepth equivalent over the event map
        (device-side masked median; stays on device)."""
        from eorb_slam_tpu.slam import map_state as ms
        m = self.l2.map
        return ms.median_scene_depth(
            m.lm_pos, m.lm_valid, jnp.asarray(Tcw, jnp.float32))

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def imu_initialized(self) -> bool:
        return self.l2.imu_initialized

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update(mci=self.n_mci, tracked=self.n_tracked, **{
            f"l2_{k}": v for k, v in self.l2.stats.items()
        })
        return s


class EvImageInertialSlam(ev_image_system.EvImageSlam):
    """EVENT_IMU_MONO mode: image clock + synch event MCIs + IMU on the
    image tracker (reference System::TrackEvMono routing IMU to both
    Tracking and EvTrackManager, src/System.cc:917-925; the event side is
    rescaled through the gauge bridge once the image map turns metric —
    the reference's ApplyScaleAndRotationEvSynch, src/LoopClosing.cc:
    2075-2094)."""

    def __init__(self, cam_params, calib: pre_mod.ImuCalib, *,
                 min_kf_imu_init: int = 6, min_time_imu_init: float = 1.5,
                 **kw):
        super().__init__(cam_params, **kw)
        slam_kw = {
            k: v for k, v in kw.items()
            if k in ("K", "M", "P", "min_init_matches", "min_track_inliers",
                     "local_window", "seed", "loop_words")
        }
        # replace the visual image tracker with the inertial pipeline
        self.im = MonoInertialSlam(
            cam_params, calib,
            img_w=self.im.img_w, img_h=self.im.img_h, N=self.max_kp,
            min_kf_imu_init=min_kf_imu_init,
            min_time_imu_init=min_time_imu_init,
            **slam_kw,
        )
        self._scale_seen = 1.0

    def _track_image(self, img: np.ndarray, ts: float, imu=None):
        if imu is None:
            imu = ImuChunk(
                gyro=np.zeros((0, 3), np.float32),
                acc=np.zeros((0, 3), np.float32),
                dts=np.zeros(0, np.float32),
            )
        feats = frontend.extract(jnp.asarray(img, jnp.float32),
                                 max_kp=self.max_kp)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        f = slam_system.FrameInput(
            ts, xy_ud, feats.octave, feats.angle, feats.desc_pm1, feats.valid
        )
        res = self.im.process_features_imu(f, imu)
        # IMU init / scale refinement rescaled the image map. With a locked
        # (joint-init) gauge, REPLAY the same world transform on the event
        # map so the identity bridge stays exact — the reference's
        # ApplyScaleAndRotationEvSynch (src/LoopClosing.cc:2075-2094).
        # Without a locked gauge, the stored pairs mix scales: drop them.
        for Ryw, s in self.im.pending_world_transforms:
            if self._gauge_locked and self.ev.n_kf >= 2:
                self._apply_world_transform_to_event(Ryw, s)
        self.im.pending_world_transforms.clear()
        if self.im.scale_applied != self._scale_seen:
            self._gauge_pairs.clear()
            self._scale_seen = self.im.scale_applied
        return res

    def _apply_world_transform_to_event(self, Ryw: np.ndarray, s: float):
        """world' = s * Ryw * world on the event map: Rcw' = Rcw Ryw^T,
        tcw' = s tcw, lm' = s Ryw lm (Map::ApplyScaledRotation semantics,
        include/Map.h:122-123, replayed on the event Atlas)."""
        m = self.ev.map
        R = m.kf_T[:, :3, :3] @ jnp.asarray(Ryw).T
        kf_T = m.kf_T.at[:, :3, :3].set(R).at[:, :3, 3].multiply(s)
        lm = s * (m.lm_pos @ jnp.asarray(Ryw).T)
        self.ev.map = m._replace(kf_T=kf_T, lm_pos=lm)
        Tl = np.asarray(self.ev.T_last).copy()
        Tl[:3, :3] = Tl[:3, :3] @ np.asarray(Ryw).T
        Tl[:3, 3] *= s
        self.ev.T_last = jnp.asarray(Tl)
        self.ev.velocity = jnp.eye(4)
        self.ev._rescale_trajectory(s, Ryw)
