"""Continuous event tracker: persistent feature tracks instead of per-MCI
descriptor matching.

Redesign of ``EvAsynchTrackerU`` (reference
src/Event/EvAsynchTrackerU.cpp:1093-1214 — per image: trackLastFeatures ->
checkTrackedMapPoints -> detectAndFuseNewFeatures -> createCurrFrame ->
matchCurrentFrame -> estimateCurrentPose -> localMapping -> reconstIniMap)
plus the track-driven mapping of ``EvLocalMapping``
(include/Event/EvLocalMapping.h:55-84).

The key structural idea (see event/feature_tracks.py): a feature track owns
one slot for life and the slot index IS the feature index in every keyframe,
so "matching the current frame" is free — the landmark a track observes is a
per-slot int — and triangulation between keyframes is row-aligned (no
descriptor search at all). Every compute step (KLT advance, top-up, pose GN,
aligned triangulation, local BA) is one jitted fixed-shape call; the host
keeps only the state machine.

Track rebirth cannot alias old keyframe rows: a reseeded slot carries
``birth_kf = -1`` until the NEXT keyframe adopts it, and aligned
triangulation between keyframes a>b only accepts rows with
``0 <= birth_kf <= b``.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.event import builder as ev_builder
from eorb_slam_tpu.event import feature_tracks as ft
from eorb_slam_tpu.geometry import lie, twoview
from eorb_slam_tpu.optim import pose_only
from eorb_slam_tpu.slam import local_mapping, map_state, system as slam_system

import jax


class ContinuousEventTracker(slam_system.MonoSlam):
    """L2 tracker over the stream of event images (tiny frames + MCIs).

    Subclasses MonoSlam for the map/atlas/trajectory/recovery plumbing but
    replaces detection+matching tracking with persistent KLT feature tracks
    (reference EvAsynchTrackerU vs EvAsynchTracker)."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        img_w: int = 240,
        img_h: int = 180,
        n_tracks: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 40,
        min_init_disp_px: float = 4.0,
        min_track_inliers: int = 10,
        kf_disp_px: float = 8.0,
        seed: int = 0,
        **kw,
    ):
        super().__init__(
            cam_params, img_w=img_w, img_h=img_h,
            K=K, M=M, N=n_tracks, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers,
            seed=seed, **kw,
        )
        self.n_tracks = n_tracks
        self.min_init_disp_px = min_init_disp_px
        self.kf_disp_px = kf_disp_px
        self.tracks = ft.empty_tracks(n_tracks)
        self.prev_img: Optional[jnp.ndarray] = None
        # init reference snapshot (reconstIniMap two-view baseline)
        self._ref_xy: Optional[jnp.ndarray] = None
        self._ref_valid: Optional[jnp.ndarray] = None
        self._ref_ts: float = 0.0
        self.stats.update(tiny=0, full=0, topped=0)

    # ----------------------------------------------------------------- input

    def process_event_image(self, img: jnp.ndarray, ts: float,
                            full: bool = True):
        """One event image through the continuous pipeline. ``full=False``
        marks a tiny frame (reference PoseImage::mReconstStat == 0): KLT
        continuity only, no pose/keyframe work."""
        # 1. trackLastFeatures: advance every live track
        if self.prev_img is not None:
            self.tracks, _ = ft.advance(self.tracks, self.prev_img, img)
        self.prev_img = img
        if not full:
            self.stats["tiny"] += 1
            return {"state": self.state, "tiny": True}
        self.stats["full"] += 1
        self.stats["frames"] += 1

        if self.state == slam_system.NOT_INITIALIZED:
            out = self._try_initialize_tracks(img, ts)
        else:
            out = self._track_tracks(img, ts)

        # detectAndFuseNewFeatures: top up dead slots (skip while an init
        # baseline is accumulating — reseeded rows would alias the snapshot)
        if self.state != slam_system.NOT_INITIALIZED or self._ref_xy is None:
            self.tracks, n_new = ft.top_up(self.tracks, img)
            self.stats["topped"] += int(n_new)
        return out

    # ------------------------------------------------------------------ init

    def _reset_init_ref(self, img: jnp.ndarray, ts: float):
        self.tracks = ft.empty_tracks(self.n_tracks)
        self.tracks, _ = ft.top_up(self.tracks, img)
        self._ref_xy = self.tracks.xy
        self._ref_valid = self.tracks.valid
        self._ref_ts = ts

    def _try_initialize_tracks(self, img: jnp.ndarray, ts: float):
        if self._ref_xy is None:
            self._reset_init_ref(img, ts)
            return {"state": self.state, "n": 0}

        alive = self.tracks.valid & self._ref_valid
        n_alive = int(np.asarray(alive).sum())
        if n_alive < self.min_init_matches:
            self._reset_init_ref(img, ts)
            return {"state": self.state, "n": n_alive}

        disp = np.asarray(
            jnp.linalg.norm(self.tracks.xy - self._ref_xy, axis=-1)
        )[np.asarray(alive)]
        if float(np.median(disp)) < self.min_init_disp_px:
            return {"state": self.state, "n": n_alive}  # keep accumulating

        # two-view reconstruction over row-aligned correspondences
        self.key, k = jax.random.split(self.key)
        res = twoview.reconstruct_two_views(
            self.cam, self._ref_xy, self.tracks.xy, alive, k,
            min_triangulated=self.min_init_triangulated,
        )
        if not bool(res.success):
            return {"state": self.state, "n": n_alive}
        return self._create_initial_map(res, alive, ts)

    def _create_initial_map(self, res, alive, ts: float):
        """initMap (reference EvAsynchTrackerU::reconstIniMap + initMap,
        src/Event/EvAsynchTrackerU.cpp:964-1040): two slot-aligned founding
        keyframes, median-depth gauge, init BA."""
        good = np.asarray(res.is_triangulated & alive)
        pts = np.asarray(res.pts3d)
        med = float(np.median(pts[good, 2])) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_s = jnp.asarray(pts * scale)
        T2 = np.array(res.Tcw2)
        T2[:3, 3] *= scale
        T2 = jnp.asarray(T2)

        N = self.n_tracks
        no_lm = jnp.full(N, -1, jnp.int32)
        zeros = jnp.zeros(N, jnp.int32)
        m = self.map
        m = map_state.insert_keyframe(
            m, jnp.asarray(0), jnp.eye(4), self._ref_ts, self._ref_xy,
            zeros, zeros.astype(jnp.float32), self.tracks.desc_pm1,
            self._ref_valid, no_lm,
        )
        m = map_state.insert_keyframe(
            m, jnp.asarray(1), T2, ts, self.tracks.xy,
            zeros, zeros.astype(jnp.float32), self.tracks.desc_pm1,
            self.tracks.valid, no_lm,
        )
        ok = res.is_triangulated & alive
        feat_ids = jnp.arange(N, dtype=jnp.int32)
        m, lm_ids = map_state.alloc_landmarks(
            m, pts_s, self.tracks.desc_pm1, ok,
            jnp.asarray(0), feat_ids, jnp.asarray(1), feat_ids,
        )
        self.map = m
        self.n_kf = 2

        kf_free = jnp.zeros(self.map.K, bool).at[1].set(True)
        self.map, _, _ = local_mapping.local_ba(
            self.map, self.cam, kf_free, iters=10,
            refresh_desc=self.desc_refresh,
        )
        # re-pin the monocular gauge after init BA (see MonoSlam)
        lmv = np.asarray(self.map.lm_valid)
        if lmv.any():
            s2 = 1.0 / max(float(np.median(np.asarray(self.map.lm_pos)[lmv, 2])), 1e-6)
            T1b = np.array(self.map.kf_T[1])
            T1b[:3, 3] *= s2
            self.map = self.map._replace(
                lm_pos=self.map.lm_pos * s2,
                kf_T=self.map.kf_T.at[1].set(jnp.asarray(T1b)),
            )

        # adopt tracks: landmark links + birth at KF0. birth_kf stores the
        # monotone keyframe SEQUENCE id (slots are reused after culling, so
        # slot indices do not order in time)
        seq0 = int(self.kf_seq[0])
        seq1 = int(self.kf_seq[1])
        self.tracks = self.tracks._replace(
            lm=jnp.where(lm_ids >= 0, lm_ids, self.tracks.lm),
            birth_kf=jnp.where(
                self.tracks.valid & alive, seq0,
                jnp.where(self.tracks.valid, seq1, self.tracks.birth_kf),
            ),
        )
        self._ref_xy = None
        self._ref_valid = None
        self.state = slam_system.OK
        self.T_last = self.map.kf_T[1]
        self.velocity = jnp.eye(4)
        self.frames_since_kf = 0
        n_lm = int(np.asarray(self.map.lm_valid).sum())
        self.n_inliers_ref = n_lm
        self._log_pose(ts, self.T_last)
        self.stats["kf"] = 2
        self.stats["lm"] = n_lm
        return {"state": self.state, "n_pts": n_lm}

    # ----------------------------------------------------------------- track

    def _lm_observations(self):
        tr = self.tracks
        has = tr.valid & (tr.lm >= 0)
        lm_idx = jnp.where(has, tr.lm, 0)
        obs_ok = has & self.map.lm_valid[lm_idx]
        return self.map.lm_pos[lm_idx], obs_ok

    def _track_tracks(self, img: jnp.ndarray, ts: float):
        """estimateCurrentPose (reference src/Event/EvAsynchTrackerU.cpp:
        828-853): motion-model prediction + pose-only GN over the tracks'
        landmark observations — matching is the slot identity."""
        pts_w, obs_ok = self._lm_observations()
        # KLT quality-weighted information (unit information would ignore
        # the tracker's own NCC measure; the reference carries per-track
        # match quality through ELK_Tracker)
        inv_sigma = 0.5 + self.tracks.quality
        T_pred = slam_system._mm_predict(self.velocity, self.T_last)
        Tcw, inl, n_inl = pose_only.pose_optimization(
            self.cam, T_pred, pts_w, self.tracks.xy, inv_sigma, obs_ok
        )
        n = int(n_inl)
        if n < self.min_track_inliers:
            Tcw, inl, n_inl = pose_only.pose_optimization(
                self.cam, self.T_last, pts_w, self.tracks.xy, inv_sigma, obs_ok
            )
            n = int(n_inl)
            if n < self.min_track_inliers:
                return self._lost_tracks(img, ts, n)
        if not bool(jnp.isfinite(Tcw).all()):
            return self._lost_tracks(img, ts, 0)

        # checkTrackedMapPoints: detach tracks whose observation is an
        # outlier under the solved pose (the track drifted off its landmark)
        detach = obs_ok & ~inl
        self.tracks = self.tracks._replace(
            lm=jnp.where(detach, -1, self.tracks.lm)
        )

        self.lost_frames = 0
        self.state = slam_system.OK
        self.velocity = slam_system._post_track_update(
            Tcw, self.T_last, Tcw)[0]
        self.T_last = Tcw
        self.frames_since_kf += 1
        self._log_pose(ts, Tcw)

        out = {"state": self.state, "n_inliers": n, "kf": False}
        if self._need_kf(n):
            self._insert_track_keyframe(ts, Tcw)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _need_kf(self, n_inl: int) -> bool:
        """KF decision by median track displacement since the last keyframe
        (reference EvAsynchTrackerU::localMapping KF policy: median track
        area / displacement thresholds, src/Event/EvAsynchTrackerU.cpp:
        1042-1089) plus the inlier-ratio / frame-count rules of Tracking."""
        last = self._kf_order[-1]
        both = (
            self.tracks.valid
            & self.map.kf_feat_valid[last]
            & (self.tracks.birth_kf >= 0)
            & (self.tracks.birth_kf <= int(self.kf_seq[last]))
        )
        nb = int(np.asarray(both).sum())
        if nb >= 8:
            d = jnp.linalg.norm(self.tracks.xy - self.map.kf_xy[last], axis=-1)
            med = float(jnp.nanmedian(jnp.where(both, d, jnp.nan)))
            if med > self.kf_disp_px:
                return True
        return (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
        )

    def _insert_track_keyframe(self, ts: float, Tcw: jnp.ndarray):
        slot_i = self._alloc_kf_slot()
        slot = jnp.asarray(slot_i)
        N = self.n_tracks
        zeros = jnp.zeros(N, jnp.int32)
        self.map = map_state.insert_keyframe(
            self.map, slot, Tcw, ts, self.tracks.xy, zeros,
            zeros.astype(jnp.float32), self.tracks.desc_pm1,
            self.tracks.valid, jnp.where(self.tracks.valid, self.tracks.lm, -1),
        )
        # aligned triangulation against recent keyframes: row i of both
        # keyframes is the same physical track iff it was born at or before
        # the older keyframe (rebirth bumps birth_kf, so no aliasing)
        order = self._kf_order
        for back in range(1, min(3, len(order)) + 1):
            kf_b = order[-back]
            slot_ok = (
                self.tracks.valid
                & (self.tracks.birth_kf >= 0)
                & (self.tracks.birth_kf <= int(self.kf_seq[kf_b]))
            )
            self.map, lm_ids = local_mapping.create_new_landmarks_aligned(
                self.map, self.cam, slot, jnp.asarray(kf_b), slot_ok
            )
            self.tracks = self.tracks._replace(
                lm=jnp.where(lm_ids >= 0, lm_ids, self.tracks.lm)
            )
        self._kf_order.append(slot_i)
        self.kf_seq[slot_i] = self._kf_seq_next
        self._kf_seq_next += 1
        self.last_kf_slot = slot_i
        # adopt fresh tracks into this keyframe
        self.tracks = self.tracks._replace(
            birth_kf=jnp.where(
                self.tracks.valid & (self.tracks.birth_kf < 0),
                int(self.kf_seq[slot_i]), self.tracks.birth_kf,
            )
        )
        self.frames_since_kf = 0

        self.map, _, _ = local_mapping.local_ba(
            self.map, self.cam, jnp.asarray(self._ba_window()),
            refresh_desc=self.desc_refresh,
        )
        self._cull_keyframes()
        # drop links to landmarks that BA or culling invalidated
        lm_idx = jnp.where(self.tracks.lm >= 0, self.tracks.lm, 0)
        self.tracks = self.tracks._replace(
            lm=jnp.where(
                (self.tracks.lm >= 0) & ~self.map.lm_valid[lm_idx],
                -1, self.tracks.lm,
            )
        )
        self.T_last = self.map.kf_T[slot_i]
        pts_w, obs_ok = self._lm_observations()
        self.n_inliers_ref = int(np.asarray(obs_ok).sum())
        self.stats["kf"] = self.n_kf
        self.stats["lm"] = int(np.asarray(self.map.lm_valid).sum())

    # -------------------------------------------------------------- recovery

    def _lost_tracks(self, img: jnp.ndarray, ts: float, n_inl: int):
        """Track-loss recovery (reference disconnected-graph reset,
        src/Event/EvAsynchTrackerU.cpp:942-961): keep the finished KF chain
        in the atlas and start a fresh disconnected segment; fuseEventTracks
        stitches the chains at output time."""
        self.stats["lost"] += 1
        self.lost_frames += 1
        if self.lost_frames <= self.lost_grace:
            self.state = slam_system.RECENTLY_LOST
            self._log_pose(ts, None)
            return {"state": self.state, "n_inliers": n_inl}
        self._freeze_trajectory()
        if self.n_kf < 5:
            self.atlas.reset_active()
        else:
            self.atlas.create_new_map()
        self.state = slam_system.NOT_INITIALIZED
        self.n_kf = 0
        self.lost_frames = 0
        self.T_last = jnp.eye(4)
        self.velocity = jnp.eye(4)
        self.n_inliers_ref = 0
        self._reset_init_ref(img, ts)
        return {"state": self.state, "n_inliers": n_inl, "new_map": True}


class EventSlamContinuous:
    """Event-only SLAM in continuous-tracking mode (reference
    EvAsynchTrackerU selected by Event.contTracking, src/Event/
    EvTrackManager.cpp:44-60): L1 window builder + continuous L2 tracker."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        n_tracks: int = 256,
        seed: int = 0,
        **tracker_kw,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params)
        self.l2 = ContinuousEventTracker(
            cam_params, img_w=self.cfg.img_w, img_h=self.cfg.img_h,
            n_tracks=n_tracks, seed=seed, **tracker_kw,
        )
        self._T_prev_mci: Optional[np.ndarray] = None

    def track_events(self, events: np.ndarray) -> list[dict]:
        self.builder.feed(events)
        out = []
        while True:
            pi = self.builder.step()
            if pi is None:
                break
            img = jnp.asarray(pi.img * 255.0, jnp.float32)
            res = self.l2.process_event_image(
                img, pi.ts, full=pi.reconst_stat == 1
            )
            if pi.reconst_stat != 1:
                continue
            out.append(dict(res, ts=pi.ts, mci_kind=pi.best_kind))
            if self.l2.state == slam_system.OK:
                T_cur = np.asarray(self.l2.T_last)
                if self._T_prev_mci is not None:
                    self.builder.set_pose_prior(
                        self._T_prev_mci, T_cur, self._median_scene_depth(T_cur)
                    )
                self._T_prev_mci = T_cur
        return out

    def _median_scene_depth(self, Tcw: np.ndarray) -> float:
        """KeyFrame::ComputeSceneMedianDepth equivalent over the event map
        (device-side masked median; one scalar pull)."""
        from eorb_slam_tpu.slam import map_state as ms
        m = self.l2.map
        return float(ms.median_scene_depth(
            m.lm_pos, m.lm_valid, jnp.asarray(Tcw, jnp.float32)))

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update({f"l2_{k}": v for k, v in self.l2.stats.items()})
        return s
