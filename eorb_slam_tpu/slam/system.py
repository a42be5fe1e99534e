"""Monocular SLAM system facade: host orchestration over jitted steps.

Replaces the reference's System + Tracking-state-machine + thread pipeline
(reference src/System.cc, src/Tracking.cc:732-1246): the host keeps only
small Python state (mode, cursors, velocity, trajectory log); every compute
step — extraction, init matching, two-view reconstruction, tracking,
triangulation, local BA — is a jitted fixed-shape call.

States: NOT_INITIALIZED -> OK -> (LOST), mirroring Tracking::eTrackingState
(reference include/Tracking.h:122-130; relocalization lands with the
place-recognition milestone).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.geometry import camera as cam_mod, lie, twoview
from eorb_slam_tpu.ops import frontend, matching
from eorb_slam_tpu.slam import atlas as atlas_mod
from eorb_slam_tpu.slam import local_mapping, map_state, relocalization, tracking

NOT_INITIALIZED = 0
OK = 1
LOST = 2
RECENTLY_LOST = 3


@jax.jit
def _track_flags(res):
    """Pack the per-frame host decisions into ONE device->host pull:
    [n_inliers, all-finite]. Every separate int()/bool() on a device value
    is a blocking device-to-host sync."""
    return jnp.stack([
        res.n_inliers.astype(jnp.float32),
        jnp.isfinite(res.Tcw).all().astype(jnp.float32),
    ])


@jax.jit
def _mm_predict(velocity, T_last):
    """Constant-velocity motion-model prediction as ONE dispatch."""
    return velocity @ T_last


@jax.jit
def _post_track_update(Tcw, T_last, kf_T_ref):
    """One fused dispatch for the per-frame pose algebra: motion model,
    and the trajectory entry relative to the reference keyframe. Eager
    4x4 matrix ops would each be a separate device call."""
    vel = Tcw @ lie.se3_inv(T_last)
    T_rel = Tcw @ lie.se3_inv(kf_T_ref)
    return vel, T_rel


@dataclasses.dataclass
class FrameInput:
    """Pre-extracted features for one frame (undistorted coords)."""

    ts: float
    xy_ud: jnp.ndarray       # (N,2)
    octave: jnp.ndarray      # (N,)
    angle: jnp.ndarray       # (N,)
    desc_pm1: jnp.ndarray    # (N,256) int8
    valid: jnp.ndarray       # (N,)
    # per-feature metric depth (stereo match / RGB-D lookup); <=0 or
    # non-finite = unknown. None for pure monocular frames. (reference
    # Frame::mvDepth / mvuRight, include/Frame.h)
    depth: Optional[jnp.ndarray] = None


class MonoSlam:
    """Monocular ORB-SLAM-class pipeline (config 1 of BASELINE.json)."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        img_w: int = 752,
        img_h: int = 480,
        K: int = 32,
        M: int = 4096,
        N: int = 512,
        P: int = 8,
        local_window: int = 5,
        min_init_matches: int = 80,
        min_init_triangulated: Optional[int] = None,
        min_track_inliers: int = 15,
        kf_inlier_ratio: float = 0.7,
        max_frames_between_kf: int = 10,
        seed: int = 0,
        loop_words: Optional[jnp.ndarray] = None,
        loop_min_gap: int = 8,
        pipelined: bool = False,
    ):
        self.cam = cam_params
        self.img_w, self.img_h = img_w, img_h
        self.atlas = atlas_mod.Atlas(K=K, M=M, N=N, P=P)
        self.state = NOT_INITIALIZED
        # --- keyframe lifecycle (KeyFrameCulling + slot reuse, reference
        # src/LocalMapping.cc:KeyFrameCulling): the active keyframes are an
        # ordered list of slots (temporal order), each with a monotone
        # sequence id; capacity K is a window, not a run-length limit.
        self._kf_order: list[int] = []
        self.kf_seq = np.full(K, -1, np.int64)
        self._kf_seq_next = 0
        self.last_kf_slot = -1
        self.kf_culled = 0
        self.cull_redundancy = 0.9   # >=90% of obs seen in >=3 other KFs
        self.kf_protect_recent = 3   # never cull the newest KFs
        self.cull_enabled = True     # periodic redundancy culling
        # SearchInNeighbors/Fuse pass: on for full-resolution imagery; at
        # small sensor sizes (event MCIs, tiny frames) descriptors are too
        # weak to distinguish true duplicates from close neighbors and
        # merging is net-harmful (measured), so it defaults off there —
        # mirroring the reference, whose event-side mapper (EvLocalMapping)
        # has no SearchInNeighbors pass
        self.fuse_enabled = img_w >= 320
        # medoid descriptor refresh follows the same small-sensor policy
        self.desc_refresh = img_w >= 320
        self.local_window = local_window
        self.min_init_matches = min_init_matches
        # the reference's TwoViewReconstruction requires 50 triangulated
        # points for image init; event-image init works from far sparser
        # MCIs, so it must scale with the match budget instead of being
        # hard-floored above it
        self.min_init_triangulated = (
            min_init_triangulated
            if min_init_triangulated is not None
            else max(50, min_init_matches // 2)
        )
        self.min_track_inliers = min_track_inliers
        self.kf_inlier_ratio = kf_inlier_ratio
        self.max_frames_between_kf = max_frames_between_kf
        self.key = jax.random.PRNGKey(seed)

        self._init_frame: Optional[FrameInput] = None
        self.T_last = jnp.eye(4)
        self.velocity = jnp.eye(4)  # T_curr @ inv(T_last)
        self.frames_since_kf = 0
        self.n_inliers_ref = 0
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.stats = {"kf": 0, "lm": 0, "frames": 0, "lost": 0}
        # last-frame exposure for synch/joint modes (reference keeps the
        # paired event frame reachable via Frame::mpEvFrame)
        self.last_frame: Optional[FrameInput] = None
        self.last_track = None
        # --- pipelined tracking (opt-in): the per-frame host decision pull
        # (2 floats) is a blocking device-to-host sync; with speculation
        # the pull for frame i overlaps frame i+1's dispatch.
        # Device state (T_last/velocity/trajectory) advances on device refs
        # alone; host decisions (lost / wide retry / KF policy) trail one
        # frame and roll the speculation back when they miss. This is the
        # tracking-thread/decision split of the reference re-expressed as
        # latency hiding (SURVEY §2.10) — the state machine is identical,
        # one frame late.
        self.pipelined = pipelined
        self._pipe = None            # in-flight speculation
        # failure recovery (reference Tracking RECENTLY_LOST grace +
        # CreateMapInAtlas, src/Tracking.cc:898-970,:1206-1224)
        self.lost_frames = 0
        self.lost_grace = 5
        # maps smaller than this are RESET on irrecoverable loss instead of
        # stored in the Atlas (reference resets tiny active maps,
        # src/Tracking.cc:951-970). Event L2 trackers lower it: the
        # reference's save-chain-then-reinit policy keeps even short event
        # KF chains for later stitching (src/Event/EvAsynchTracker.cpp:1348)
        self.min_kf_store = 10
        self._traj_frozen: list[tuple[float, np.ndarray]] = []
        self._last_kf_ts: Optional[float] = None  # host cache (no device pull)
        # in-the-loop place recognition (reference spawns a LoopClosing
        # thread per System; here it runs inline at KF insertion, gated by
        # a minimum temporal gap like NewDetectCommonRegions' consistency)
        self.loop_closer = None
        self.loop_min_gap = loop_min_gap
        self.loops_closed = 0
        # handoff to a paired event tracker (EvImageSlam): on a loop
        # correction the pre-correction keyframe poses + the LoopInfo are
        # stashed so the synch event map can follow the weld and the final
        # GBA can include event observations (reference dispatches
        # EvOptimizer variants from LoopClosing/GBA whenever isEvent(),
        # src/LoopClosing.cc:2535-2549) — consumed by the wrapper, None
        # otherwise. Only stashed when a consumer opted in (the wrapper
        # sets loop_correction_consumer=True); a standalone MonoSlam would
        # otherwise pin the pre-correction kf_T buffer indefinitely
        self.last_loop_correction = None
        self.loop_correction_consumer = False
        if loop_words is not None:
            from eorb_slam_tpu.slam import loop_closing as lc_mod

            self.loop_closer = lc_mod.LoopCloser(
                cam_params, loop_words, Kmax=K, sparse_words_per_kf=N,
                img_w=img_w, img_h=img_h,
                # small sensors (event MCIs) carry fewer trackable features
                # per frame — scale the projection-verify quorum with the
                # feature budget, floor 20
                proj_verify_min=max(20, min(40, N // 12)),
            )
        # BoW databases of stored (lost) maps, keyed by atlas index — the
        # retrieval side of cross-map merging (reference LoopClosing checks
        # candidates over the whole Atlas, src/LoopClosing.cc:267)
        self._stored_dbs: dict = {}
        self.map_merges = 0
        # async tracking/mapping overlap (SURVEY §2.10: the reference's
        # LocalMapping THREAD becomes async dispatch): the mapping step's
        # small stats stay ON DEVICE and culling is deferred until the next
        # keyframe, so per-frame tracking dispatches pipeline behind the
        # in-flight BA instead of blocking on its results
        self._pending_map_stats = None
        # prefetched KF-redundancy ranking for the deferred culling pass
        self._pending_redundancy = None

    # ------------------------------------------------------------- map/atlas

    @property
    def map(self) -> map_state.MapState:
        return self.atlas.current

    @map.setter
    def map(self, m: map_state.MapState) -> None:
        self.atlas.current = m

    # -------------------------------------------------- keyframe lifecycle

    @property
    def n_kf(self) -> int:
        return len(self._kf_order)

    @n_kf.setter
    def n_kf(self, v: int) -> None:
        """Assigning n_kf = v declares slots 0..v-1 active in temporal order
        (used by the init paths, which always build into a fresh map)."""
        self._kf_order = list(range(v))
        self.kf_seq[:] = -1
        for s in self._kf_order:
            self.kf_seq[s] = self._kf_seq_next
            self._kf_seq_next += 1
        self.last_kf_slot = self._kf_order[-1] if self._kf_order else -1

    def _kf_ref(self) -> int:
        return self._kf_order[-1] if self._kf_order else 0

    def _alloc_kf_slot(self) -> int:
        """Next free keyframe slot; culls a keyframe to make room when the
        map is at capacity (redundant one if any, else the least useful)."""
        active = set(self._kf_order)
        K = self.map.K
        if len(active) < K:
            for s in range(K):
                if s not in active:
                    return s
        slot = self._cull_keyframes(force=True)
        assert slot is not None and slot >= 0
        return slot

    def _cull_keyframes(self, force: bool = False):
        """KeyFrameCulling (reference src/LocalMapping.cc:KeyFrameCulling):
        remove the most redundant keyframe if >=`cull_redundancy` of its
        observations are covered by >=3 other keyframes. With force=True a
        slot is ALWAYS freed (sliding-window fallback: the least useful
        non-recent KF goes). Returns the freed slot or None."""
        order = self._kf_order
        if not force and not self.cull_enabled:
            return None
        if not force and len(order) <= max(self.kf_protect_recent + 1, 3):
            return None
        if self._pending_redundancy is not None:
            # prefetched at the last keyframe insertion — the transfer has
            # landed, the read is ~free. One-KF-stale redundancy is fine
            # for choosing which keyframe to drop (it's a heuristic rank).
            # NOT cleared on read: the periodic cull and a force cull in
            # the same insertion share one ranking (cleared on map change)
            packed = np.asarray(self._pending_redundancy)
        else:
            frac, total = map_state.keyframe_redundancy(self.map)
            # one packed pull instead of two blocking syncs
            packed = np.asarray(
                jnp.concatenate([frac, total.astype(jnp.float32)]))
        frac, total = packed[: self.map.K], packed[self.map.K:]
        # candidates: all but the origin KF and the most recent ones; under
        # force (map at capacity, K small vs kf_protect_recent) shrink the
        # protected window so a slot is ALWAYS freeable
        protect = self.kf_protect_recent
        if force:
            protect = min(protect, max(len(order) - 2, 0))
        cand = order[1 : len(order) - protect]
        if not cand:
            if not force:
                return None
            cand = order[1:] or order[:1]
        scores = [(frac[s], s) for s in cand]
        best_frac, best_slot = max(scores)
        redundant = best_frac >= self.cull_redundancy or total[best_slot] == 0
        if not redundant:
            if not force:
                return None
            # sliding-window fallback: drop the oldest non-origin KF
            best_slot = cand[0]
        self._resolve_trajectory_refs(best_slot)
        self._on_cull_keyframe(best_slot)
        self.map = map_state.remove_keyframe(self.map, jnp.asarray(best_slot))
        self._pending_redundancy = None   # ranking is stale once a KF left
        order.remove(best_slot)
        self.kf_seq[best_slot] = -1
        self.kf_culled += 1
        self.stats["kf_culled"] = self.kf_culled
        self.stats["kf"] = self.n_kf
        if self.loop_closer is not None:
            self.loop_closer.remove_keyframe(best_slot)
        return best_slot

    def _on_cull_keyframe(self, slot: int) -> None:
        """Subclass hook fired before KF `slot` is erased (inertial systems
        merge the preintegration chain across the gap here)."""

    def _resolve_trajectory_refs(self, slot: int) -> None:
        """Trajectory entries are stored relative to a reference KF slot;
        before that slot is culled/reused, bake them into absolute poses
        (ref == -2 marks an absolute Tcw entry)."""
        hit = [i for i, (_, T_rel, ref) in enumerate(self.trajectory)
               if ref == slot and T_rel is not None]
        if not hit:
            return
        # ONE batched device matmul, NO pull — the baked rows stay device
        # references; trajectory_twc batch-pulls at save
        baked = (jnp.stack([jnp.asarray(self.trajectory[i][1])
                            for i in hit])
                 @ self.map.kf_T[slot])
        for j, i in enumerate(hit):
            ts, _, _ = self.trajectory[i]
            self.trajectory[i] = (ts, baked[j], -2)

    # ---------------------------------------------------------------- input

    def process_image(self, img: jnp.ndarray, ts: float,
                      max_kp: Optional[int] = None):
        if max_kp is None:
            max_kp = self.map.N  # frame capacity == extraction budget
        if self.state == OK and type(self)._track is MonoSlam._track:
            # fused fast path: extraction + prediction + tracking in ONE
            # dispatch (see tracking.track_image_frame)
            ref = self._kf_ref()
            res, feats, xy_ud, flags, vel_new, T_rel = \
                tracking.track_image_frame(
                    jnp.asarray(img), self.cam, self.map, self.velocity,
                    self.T_last, self.map.kf_T[ref], max_kp=max_kp,
                    img_w=self.img_w, img_h=self.img_h,
                )
            f = FrameInput(ts, xy_ud, feats.octave, feats.angle,
                           feats.desc_pm1, feats.valid)
            self.stats["frames"] += 1
            if self.pipelined:
                return self._speculate(f, res, flags, vel_new, T_rel, ref)
            return self._track_post(f, res, flags,
                                    fused=(vel_new, T_rel, ref))
        self.flush_pipeline()
        feats = frontend.extract(img, max_kp=max_kp)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        return self.process_features(
            FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        )

    # ------------------------------------------------- pipelined tracking

    def _speculate(self, f, res, flags, vel_new, T_rel, ref):
        """Advance device state for this frame WITHOUT pulling its flags,
        then resolve the PREVIOUS frame's decisions — its flags transfer
        overlapped with this frame's dispatch, so the host never waits."""
        prev = self._pipe
        saved = (self.T_last, self.velocity)
        self.velocity = vel_new
        self.T_last = res.Tcw
        self.trajectory.append((f.ts, T_rel, ref))
        # start the D2H of the decision flags NOW — by the time the next
        # frame resolves this speculation the transfer has landed and the
        # pull does not wait on the device
        try:
            flags.copy_to_host_async()
        except AttributeError:
            pass
        self._pipe = (f, res, flags, saved)
        out = {"state": self.state, "pipelined": True, "n_inliers": -1}
        if prev is not None:
            out = self._resolve_speculation(prev, successor=True)
        return out

    def flush_pipeline(self):
        """Resolve any in-flight speculation (call before reading
        trajectory/stats or checkpointing)."""
        if self._pipe is not None:
            prev, self._pipe = self._pipe, None
            return self._resolve_speculation(prev, successor=False)
        return None

    def _resolve_speculation(self, pend, successor: bool):
        f, res, flags, saved = pend
        n_inl, finite = (float(x) for x in np.asarray(flags))
        n_inl = int(n_inl)
        if n_inl >= self.min_track_inliers and finite:
            # prediction confirmed — commit the host-side bookkeeping
            self.last_frame = f
            self.last_track = res
            self.lost_frames = 0
            self.frames_since_kf += 1
            need_kf = (
                n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
                or self.frames_since_kf >= self.max_frames_between_kf
                or self._need_kf_extra(f)
            )
            out = {"state": self.state, "n_inliers": n_inl, "kf": False}
            if need_kf:
                T_spec, vel_spec = self.T_last, self.velocity
                welds0 = self.loops_closed + self.map_merges
                self._insert_keyframe(f, res, n_inl=n_inl)
                corrected = (self.loops_closed + self.map_merges) != welds0
                if successor and not corrected:
                    # the KF's refined pose must not clobber the newer
                    # in-flight frame's speculated pose
                    self.T_last, self.velocity = T_spec, vel_spec
                elif successor and corrected:
                    # a loop/merge moved the map under the in-flight
                    # speculation: its predicted pose and trajectory entry
                    # are pre-weld. Drop the speculation and reprocess its
                    # frame synchronously against the corrected map
                    succ = self._pipe
                    self._pipe = None
                    if succ is not None:
                        if self.trajectory:
                            self.trajectory.pop()
                        self._track(succ[0])
                out.update(kf=True, n_lm=self.stats["lm"])
            return out
        # misprediction: this frame did NOT track. Unwind every speculative
        # trajectory entry at or after it, restore the pre-frame state, and
        # run the synchronous recovery (wide retry / lost handling); a
        # successor speculation was predicted from the bad pose — drop it
        # and reprocess its features synchronously.
        n_pop = 1 + (1 if successor else 0)
        for _ in range(n_pop):
            if self.trajectory:
                self.trajectory.pop()
        succ_f = self._pipe[0] if (successor and self._pipe) else None
        self._pipe = None
        self.T_last, self.velocity = saved
        out = self._track(f)
        if succ_f is not None:
            out = self._track(succ_f)
        return out

    def process_features(self, f: FrameInput):
        self.stats["frames"] += 1
        if self.state == NOT_INITIALIZED:
            return self._try_initialize(f)
        return self._track(f)

    # ----------------------------------------------------------------- init

    def _try_initialize(self, f: FrameInput):
        if self._init_frame is None:
            self._init_frame = f
            return {"state": self.state, "n": 0}
        ref = self._init_frame

        m12, _ = tracking.match_for_initialization(
            ref.desc_pm1, ref.valid, ref.xy_ud,
            f.desc_pm1, f.valid, f.xy_ud,
        )
        matched = np.asarray(m12 >= 0)
        n = int(matched.sum())
        if n < self.min_init_matches:
            # too few matches: slide the reference frame (reference resets
            # mInitialFrame when matches < 100, src/Tracking.cc:1430)
            self._init_frame = f
            return {"state": self.state, "n": n}

        idx2 = jnp.where(m12 >= 0, m12, 0)
        self.key, k = jax.random.split(self.key)
        res = twoview.reconstruct_two_views(
            self.cam, ref.xy_ud, f.xy_ud[idx2], m12 >= 0, k,
            min_triangulated=self.min_init_triangulated,
        )
        if not bool(res.success):
            return {"state": self.state, "n": n}

        # --- create initial map: median-depth normalization (reference
        # CreateInitialMapMonocular scales by inverse median depth)
        good = np.asarray(res.is_triangulated)
        pts = np.asarray(res.pts3d)
        med_depth = float(np.median(pts[good, 2]))
        scale = 1.0 / max(med_depth, 1e-6)
        pts_s = jnp.asarray(pts * scale)
        T2 = np.array(res.Tcw2)  # copy: jax->numpy views are read-only
        T2[:3, 3] *= scale
        T2 = jnp.asarray(T2)

        N = ref.xy_ud.shape[0]
        feat_ids = jnp.arange(N, dtype=jnp.int32)

        # insert the two founding keyframes with no landmark links yet
        m = self.map
        m = map_state.insert_keyframe(
            m, jnp.asarray(0), jnp.eye(4), ref.ts, ref.xy_ud, ref.octave,
            ref.angle, ref.desc_pm1, ref.valid, jnp.full(N, -1, jnp.int32),
        )
        m = map_state.insert_keyframe(
            m, jnp.asarray(1), T2, f.ts, f.xy_ud, f.octave,
            f.angle, f.desc_pm1, f.valid, jnp.full(N, -1, jnp.int32),
        )
        ok = res.is_triangulated & (m12 >= 0)
        m, lm_ids = map_state.alloc_landmarks(
            m, pts_s, ref.desc_pm1, ok,
            jnp.asarray(0), feat_ids, jnp.asarray(1), idx2,
        )
        self.map = m
        self.n_kf = 2

        # init BA: optimize KF1 + landmarks, KF0 fixed (gauge)
        kf_free = jnp.zeros(self.map.K, bool).at[1].set(True)
        self.map, c0, c1 = local_mapping.local_ba(
            self.map, self.cam, kf_free, iters=10,
            refresh_desc=self.desc_refresh,
        )
        # re-normalize scale after init BA (monocular scale gauge is free
        # with a single fixed pose; reference re-scales by median depth in
        # CreateInitialMapMonocular after the init optimization)
        lmv = np.asarray(self.map.lm_valid)
        depths = np.asarray(self.map.lm_pos)[lmv, 2]
        s2 = 1.0 / max(float(np.median(depths)), 1e-6)
        # rescale EVERY active KF translation (not just slot 1): init
        # normally runs on a fresh 2-KF map, but a merge-triggered re-init
        # can carry more history and a partial rescale would shear the map
        kf_T2 = np.array(self.map.kf_T)
        kf_T2[:, :3, 3] *= s2
        self.map = self.map._replace(
            lm_pos=self.map.lm_pos * s2,
            kf_T=jnp.asarray(kf_T2),
        )

        self.state = OK
        self.T_last = self.map.kf_T[1]
        self.velocity = jnp.eye(4)
        self.frames_since_kf = 0
        self.n_inliers_ref = int(np.asarray(ok).sum())
        self._last_kf_ts = f.ts
        self._log_pose(f.ts, self.T_last)
        self.stats["kf"] = 2
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(self.map, 0)
            self.loop_closer.add_keyframe(self.map, 1)
        self.stats["lm"] = int(self.map.lm_valid.sum())
        return {"state": self.state, "n": n, "n_pts": self.stats["lm"]}

    # ---------------------------------------------------------------- track

    def _track(self, f: FrameInput):
        T_pred = _mm_predict(self.velocity, self.T_last)
        res = tracking.track_frame(
            self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
            T_pred, img_w=self.img_w, img_h=self.img_h,
        )
        return self._track_post(f, res, _track_flags(res))

    def _track_post(self, f: FrameInput, res, flags, fused=None):
        self.last_frame = f
        n_inl, finite = (float(x) for x in np.asarray(flags))
        n_inl = int(n_inl)

        if n_inl < self.min_track_inliers:
            # wider re-search around the last pose (motion model may be off;
            # reference falls back to TrackReferenceKeyFrame / relocalization)
            res = tracking.track_frame(
                self.map, self.cam, f.xy_ud, f.octave, f.desc_pm1, f.valid,
                self.T_last, img_w=self.img_w, img_h=self.img_h,
                search_radius=40.0, nn_ratio=0.95,
            )
            n_inl, finite = (float(x) for x in np.asarray(_track_flags(res)))
            n_inl = int(n_inl)
            if n_inl < self.min_track_inliers:
                return self._handle_lost(f, n_inl)
            fused = None

        if not finite:
            # a degenerate GN solve must not poison T_last / the trajectory
            return self._handle_lost(f, 0)

        self.last_track = res
        self.lost_frames = 0
        self.state = OK
        Tcw = res.Tcw
        if fused is not None and fused[2] == self._kf_ref():
            self.velocity, T_rel, ref = fused[0], fused[1], fused[2]
        else:
            ref = self._kf_ref()
            self.velocity, T_rel = _post_track_update(
                Tcw, self.T_last, self.map.kf_T[ref]
            )
        self.T_last = Tcw
        self.frames_since_kf += 1
        # trajectory entry stays ON DEVICE (no per-frame sync); readers
        # np.asarray it on demand (trajectory_twc / freeze / rescale)
        self.trajectory.append((f.ts, T_rel, ref))

        # keyframe policy (simplified NeedNewKeyFrame, src/Tracking.cc:2083;
        # capacity never gates insertion — KeyFrameCulling frees slots)
        need_kf = (
            n_inl < self.kf_inlier_ratio * max(self.n_inliers_ref, 1)
            or self.frames_since_kf >= self.max_frames_between_kf
            or self._need_kf_extra(f)
        )
        out = {"state": self.state, "n_inliers": n_inl, "kf": False}
        if need_kf:
            self._insert_keyframe(f, res)
            # n_lm lags one keyframe by design: the mapping-step stats stay
            # on device until the next drain so tracking never blocks on the
            # in-flight BA (see _drain_mapping / _pending_map_stats)
            out.update(kf=True, n_lm=self.stats["lm"])
        return out

    def _need_kf_extra(self, f) -> bool:
        """Extra sensor-specific KF triggers; inertial pipelines force a KF
        on elapsed time (reference NeedNewKeyFrame's IMU branch inserts at
        >= 0.5 s since the last KF, src/Tracking.cc:2083)."""
        return False

    # ------------------------------------------------------------- recovery

    def _handle_lost(self, f: FrameInput, n_inl: int):
        """Graded recovery (reference src/Tracking.cc:898-970): RECENTLY_LOST
        attempts relocalization for a grace window, then the Atlas either
        resets a tiny active map or stores it and starts fresh
        (CreateMapInAtlas, src/Tracking.cc:1206-1224)."""
        self._drain_mapping()
        self.stats["lost"] += 1
        self.lost_frames += 1

        T_rel, n_rel = self._relocalize(f)
        if T_rel is not None:
            self.state = OK
            self.lost_frames = 0
            self.velocity = jnp.eye(4)
            self.T_last = T_rel
            self._log_pose(f.ts, T_rel)
            return {"state": self.state, "n_inliers": n_rel, "reloc": True}

        if self.lost_frames <= self.lost_grace:
            self.state = RECENTLY_LOST
            # retry from the LAST pose, not an extrapolation of it: the
            # motion model is the most likely culprit for the miss, and for
            # overlapping event windows the previous pose is the best prior
            self.velocity = jnp.eye(4)
            self._log_pose(f.ts, None)
            return {"state": self.state, "n_inliers": n_inl}

        # irrecoverable: multi-map recovery
        self._freeze_trajectory()
        if self.n_kf < self.min_kf_store:
            self.atlas.reset_active()
        else:
            old_active = self.atlas.active
            self.atlas.create_new_map()
            if self.loop_closer is not None:
                # stash the lost map's BoW index for cross-map merging
                self._stored_dbs[old_active] = self.loop_closer.db
                self.loop_closer.db = self.loop_closer.fresh_db()
        self.state = NOT_INITIALIZED
        self.n_kf = 0
        self.lost_frames = 0
        self._init_frame = f
        self.T_last = jnp.eye(4)
        self.velocity = jnp.eye(4)
        self.n_inliers_ref = 0
        return {"state": self.state, "n_inliers": n_inl, "new_map": True}

    def _relocalize(self, f: FrameInput):
        """Relocalization: BoW keyframe-database candidates + per-candidate
        PnP RANSAC when a vocabulary is loaded (reference
        KeyFrameDatabase::DetectRelocalizationCandidates,
        src/KeyFrameDatabase.cc:783 + MLPnP at src/Tracking.cc:2641-2730);
        global landmark matching is the vocabulary-less fallback."""
        if self.loop_closer is not None and len(self._kf_order) >= 2:
            T, n = self._relocalize_kfdb(f)
            if T is not None:
                return T, n
        m = self.map
        if int(np.asarray(m.lm_valid).sum()) < 30:
            return None, 0
        feat_lm, dist = matching.match_nnratio(
            f.desc_pm1, f.valid, m.lm_desc_pm1, m.lm_valid,
            pair_mask=None, max_dist=matching.TH_LOW, nn_ratio=0.75,
            mutual=True,
        )
        matched = feat_lm >= 0
        if int(np.asarray(matched).sum()) < max(self.min_track_inliers, 12):
            return None, 0
        pts = m.lm_pos[jnp.where(matched, feat_lm, 0)]
        self.key, k = jax.random.split(self.key)
        res = relocalization.pnp_ransac(
            self.cam, pts, f.xy_ud, matched, k,
            min_inliers=max(self.min_track_inliers, 12),
        )
        if not bool(res.ok):
            return None, int(res.n_inliers)
        return res.Tcw, int(res.n_inliers)

    def _relocalize_kfdb(self, f: FrameInput):
        """Query the loop closer's BoW database with the lost frame, then
        PnP against each candidate keyframe's landmarks (best-first)."""
        m = self.map
        lc = self.loop_closer
        bq = lc.frame_query(f.desc_pm1, f.valid)
        scores, idx = lc.query_db(bq, jnp.zeros(m.K, bool), top_k=3)
        scores = np.asarray(scores)
        idx = np.asarray(idx)
        min_inl = max(self.min_track_inliers, 12)
        for rank in range(len(idx)):
            if not np.isfinite(scores[rank]) or scores[rank] <= 0:
                continue
            cand = int(idx[rank])
            vc = m.kf_feat_valid[cand] & (m.kf_feat_lm[cand] >= 0)
            j, _ = matching.match_nnratio(
                f.desc_pm1, f.valid, m.kf_desc_pm1[cand], vc,
                max_dist=matching.TH_LOW, nn_ratio=0.75, mutual=True,
            )
            matched = f.valid & (j >= 0)
            if int(np.asarray(matched).sum()) < min_inl:
                continue
            lm = m.kf_feat_lm[cand][jnp.clip(j, 0)]
            pts = m.lm_pos[jnp.clip(lm, 0)]
            self.key, k = jax.random.split(self.key)
            res = relocalization.pnp_ransac(
                self.cam, pts, f.xy_ud, matched, k, min_inliers=min_inl,
            )
            if bool(res.ok):
                return res.Tcw, int(res.n_inliers)
        return None, 0

    def _pull_trajectory_rows(self) -> dict:
        """Batch-pull every device-resident trajectory row in ONE transfer
        (per-entry np.asarray is one blocking sync each, thousands per
        sequence at event-window rates)."""
        ent = self.trajectory
        idx = [i for i, (_, T_rel, _) in enumerate(ent) if T_rel is not None]
        if not idx:
            return {}
        arr = np.asarray(jnp.stack([jnp.asarray(ent[i][1]) for i in idx]))
        return dict(zip(idx, arr))

    def _freeze_trajectory(self):
        """Resolve all relative trajectory entries against the CURRENT map's
        keyframes before switching maps (they reference its slots)."""
        kf_T = np.asarray(self.map.kf_T)
        rows = self._pull_trajectory_rows()
        for i, (ts, T_rel, ref) in enumerate(self.trajectory):
            if T_rel is not None:
                Tcw = rows[i] if ref == -2 else rows[i] @ kf_T[ref]
                self._traj_frozen.append((ts, np.linalg.inv(Tcw)))
        self.trajectory = []

    def _ba_window(self) -> np.ndarray:
        """(K,) bool mask of poses the local BA may move: the newest
        `local_window` keyframes, minus at least TWO older keyframes kept
        fixed so the monocular scale gauge is pinned."""
        order = self._kf_order
        kf_free = np.zeros(self.map.K, bool)
        for s in order[max(2, len(order) - self.local_window):]:
            kf_free[s] = True
        return kf_free

    def _drain_mapping(self):
        """Force the previous mapping step's deferred host work: pull its
        stats and run the postponed KeyFrameCulling pass."""
        if self._pending_map_stats is None:
            return
        st = np.asarray(self._pending_map_stats)
        self._pending_map_stats = None
        self.stats["lm"] = int(st[0])
        if self.fuse_enabled:
            self.stats["fused"] = self.stats.get("fused", 0) + int(st[1])
        self.stats["ba"] = {
            "opt_kf": int(st[4]), "fixed_kf": int(st[5]),
            "edges": int(st[6]), "cost0": float(st[2]), "cost": float(st[3]),
        }
        from eorb_slam_tpu.utils.logging import every_n, get_logger

        log = get_logger("eorb.mapping")
        if log.isEnabledFor(20) and every_n("lba", 5):
            log.info(
                "LBA kf=%d opt=%d fixed=%d edges=%d cost %.1f->%.1f lm=%d",
                self.n_kf, int(st[4]), int(st[5]), int(st[6]),
                float(st[2]), float(st[3]), int(st[0]),
            )
        self._cull_keyframes()

    def _insert_keyframe(self, f: FrameInput, res: tracking.TrackResult,
                         n_inl: Optional[int] = None):
        self._last_kf_ts = f.ts
        self._drain_mapping()
        slot_i = self._alloc_kf_slot()
        slot = jnp.asarray(slot_i)
        order = self._kf_order
        # triangulation partners: several recent keyframes (consecutive KFs
        # may lack baseline for the parallax gate; the reference uses up to
        # 20 covisible KFs, src/LocalMapping.cc CreateNewMapPoints). Padded
        # with `slot` (self-pairs no-op inside the fused step).
        tri = [order[-k] if k <= len(order) else slot_i for k in range(1, 5)]
        fuse_nb = [s_ for s_ in order[-4:-1]] if self.fuse_enabled else []
        while len(fuse_nb) < 3:
            fuse_nb.append(slot_i)

        self._kf_order.append(slot_i)
        self.kf_seq[slot_i] = self._kf_seq_next
        self._kf_seq_next += 1
        self.last_kf_slot = slot_i
        self.frames_since_kf = 0
        # n_inl from an already-pulled flags vector skips a device sync
        self.n_inliers_ref = (int(res.n_inliers) if n_inl is None
                              else int(n_inl))

        # the whole mapping pass (insert + triangulate + fuse + local BA)
        # is ONE dispatch (local_mapping.keyframe_mapping_step)
        self.map, T_new, stats = local_mapping.keyframe_mapping_step(
            self.map, self.cam, slot, res.Tcw, f.ts, f.xy_ud, f.octave,
            f.angle, f.desc_pm1, f.valid, res.feat_lm,
            jnp.asarray(tri, jnp.int32), jnp.asarray(fuse_nb, jnp.int32),
            jnp.asarray(self._ba_window()), do_fuse=self.fuse_enabled,
            refresh_desc=self.desc_refresh,
        )
        # stereo / RGB-D: features with metric depth found no triangulation
        # partner yet become depth-founded landmarks (reference creates
        # close stereo points at KF creation, src/Tracking.cc)
        if f.depth is not None:
            self.map, _ = local_mapping.create_depth_landmarks(
                self.map, self.cam, slot, jnp.asarray(f.depth)
            )
            self.map, _, _ = local_mapping.local_ba(
                self.map, self.cam, jnp.asarray(self._ba_window())
            )
        self.T_last = T_new
        self.stats["kf"] = self.n_kf
        # stats stay on device; the pull + culling happen at the NEXT
        # keyframe (async tracking/mapping overlap) — unless a loop closer
        # needs a consistent host view right now
        self._pending_map_stats = stats
        # prefetch: the drain at the NEXT keyframe reads these as a landed
        # transfer instead of a blocking sync. Same for the
        # culling pass's redundancy ranking — computed now, consumed at the
        # next cull decision
        frac, total = map_state.keyframe_redundancy(self.map)
        self._pending_redundancy = jnp.concatenate(
            [frac, total.astype(jnp.float32)])
        try:
            stats.copy_to_host_async()
            self._pending_redundancy.copy_to_host_async()
        except AttributeError:
            pass
        if self.loop_closer is not None:
            self._drain_mapping()

        # place recognition + loop correction (reference LoopClosing::Run
        # consumes every new KF; inline here instead of a thread)
        if self.loop_closer is not None:
            q = slot_i
            self.loop_closer.add_keyframe(self.map, q)
            if len(self._kf_order) >= self.loop_min_gap:
                T_before = self.map.kf_T  # device ref, no pull
                self.map, info = self.loop_closer.detect_and_correct(
                    self.map, q, order=self._kf_order
                )
                if info.detected:
                    self.loops_closed += 1
                    self.T_last = self.map.kf_T[q]
                    self.velocity = jnp.eye(4)
                    self.stats["loops"] = self.loops_closed
                    if self.loop_correction_consumer:
                        # stash validity/timestamps WITH the poses: a map
                        # merge in the same insertion can validate new
                        # slots whose T_before rows are garbage — the
                        # consumer must anchor only against slots that were
                        # valid at correction time
                        self.last_loop_correction = (
                            T_before, info,
                            self.map.kf_valid, self.map.kf_ts,
                        )
            if self._stored_dbs and self.n_kf >= 4:
                self._try_map_merge(q)

    def _try_map_merge(self, q: int):
        """Cross-map common-region detection + Sim3 weld (reference
        LoopClosing::MergeLocal, src/LoopClosing.cc:1301): query the stored
        maps' BoW indexes with the new KF; on a hit, Sim3-RANSAC the two
        KFs' landmark pairs and merge the stored map into the active one."""
        from eorb_slam_tpu.geometry import sim3_solver

        m = self.map
        lc = self.loop_closer
        bq = lc.frame_query(m.kf_desc_pm1[q], m.kf_feat_valid[q])
        for idx in list(self._stored_dbs):
            db = self._stored_dbs[idx]
            scores, cand_idx = lc.query_db(
                bq, jnp.zeros(m.K, bool), top_k=1, db=db
            )
            if not np.isfinite(float(scores[0])) or float(scores[0]) <= 0:
                continue
            cand = int(cand_idx[0])
            sto = self.atlas.maps[idx]
            vq = m.kf_feat_valid[q] & (m.kf_feat_lm[q] >= 0)
            vc = sto.kf_feat_valid[cand] & (sto.kf_feat_lm[cand] >= 0)
            j, _ = matching.match_nnratio(
                m.kf_desc_pm1[q], vq, sto.kf_desc_pm1[cand], vc,
                nn_ratio=0.75,
            )
            valid = vq & (j >= 0)
            if int(np.asarray(valid).sum()) < 15:
                continue
            lm_q = jnp.clip(m.kf_feat_lm[q], 0)
            lm_c = jnp.clip(sto.kf_feat_lm[cand][jnp.clip(j, 0)], 0)
            p1 = lie.se3_apply(m.kf_T[q], m.lm_pos[lm_q])
            p2 = lie.se3_apply(sto.kf_T[cand], sto.lm_pos[lm_c])
            self.key, k = jax.random.split(self.key)
            res = sim3_solver.sim3_ransac(
                p1, p2, valid, k,
                px_threshold=jnp.full(p1.shape[0], 9.21, jnp.float32),
                cam_params1=self.cam, cam_params2=self.cam,
            )
            if int(res.n_inliers) < 20:
                continue
            # projection verification through the measured Sim3 (same
            # second gate as in-map loops — a false cross-map weld is
            # strictly worse than a missed merge)
            from eorb_slam_tpu.slam import loop_closing as lc_mod

            n_proj = int(lc_mod._projection_verify(
                self.cam, sto.kf_T[cand], m.kf_T[q],
                sto.kf_feat_lm[cand], sto.kf_feat_valid[cand],
                sto.kf_desc_pm1[cand],
                sto.lm_pos, sto.lm_desc_pm1,
                m.kf_xy[q], m.kf_desc_pm1[q], m.kf_feat_valid[q],
                res.R, res.t, res.s,
                jnp.asarray(float(self.img_w)),
                jnp.asarray(float(self.img_h)),
            ))
            if n_proj < lc.proj_verify_min:
                continue
            # res maps query-cam -> cand-cam; compose stored-world ->
            # active-world: Twq o S^-1 o T_cand
            Rq = m.kf_T[q][:3, :3]
            tq = m.kf_T[q][:3, 3]
            S_wq = (Rq.T, -Rq.T @ tq, jnp.asarray(1.0))
            Si = lie.sim3_inv(res.R, res.t, res.s)
            Tc = sto.kf_T[cand]
            S_tc = (Tc[:3, :3], Tc[:3, 3], jnp.asarray(1.0))
            S_total = lie.sim3_mul(*S_wq, *lie.sim3_mul(*Si, *S_tc))
            self.map = self.atlas.merge(idx, *S_total)
            # merged KFs landed in arbitrary free slots; rebuild the
            # temporal order (and sequence ids) from timestamps
            kv = np.asarray(self.map.kf_valid)
            ts_all = np.asarray(self.map.kf_ts)
            slots = np.flatnonzero(kv)
            self._kf_order = [int(s) for s in slots[np.argsort(ts_all[slots])]]
            self.kf_seq[:] = -1
            for s in self._kf_order:
                self.kf_seq[s] = self._kf_seq_next
                self._kf_seq_next += 1
            self.last_kf_slot = self._kf_order[-1] if self._kf_order else -1
            self.stats["kf"] = self.n_kf
            # atlas indices shifted after deletion; re-key the stashes
            del self._stored_dbs[idx]
            self._stored_dbs = {
                (i - 1 if i > idx else i): d
                for i, d in self._stored_dbs.items()
            }
            self.map_merges += 1
            self.stats["map_merges"] = self.map_merges
            return

    # ------------------------------------------------------------- output
    #
    # Trajectory bookkeeping mirrors the reference's FrameInfo +
    # SaveTrajectoryEuRoC (reference src/Tracking.cc:1233-1245,
    # src/System.cc): each frame stores its pose RELATIVE to the current
    # reference keyframe, and absolute poses are recomposed at output time
    # from the keyframe's latest pose — so BA refinements, gravity
    # alignment, and metric rescaling retroactively correct the whole
    # trajectory.

    def _log_pose(self, ts: float, Tcw):
        if Tcw is None:
            self.trajectory.append((ts, None, -1))
            return
        ref = self._kf_ref()
        T_rel = np.asarray(Tcw @ lie.se3_inv(self.map.kf_T[ref]))
        self.trajectory.append((ts, T_rel, ref))

    def _rescale_trajectory(self, s: float, Ryw=None):
        """Apply a map world transform (gravity rotation ``Ryw`` + scale
        ``s``) to the stored trajectory entries.

        RELATIVE entries (ref >= 0) recompose against the transformed
        keyframe poses, so only their translation scales: with the world
        transform W = Sim3(s) ∘ · ∘ Ryw^T acting on camera poses,
        T_rel' = W(Tf) W(Tk)^-1 = Sim3(s) T_rel Sim3(s)^-1 — rotation
        unchanged, translation x s. ABSOLUTE entries (ref == -2, baked at
        keyframe culls) carry the full pose and need BOTH factors:
        R' = R @ Ryw^T, t' = s t. Missing the rotation kinked every
        trajectory with pre-init culls at the IMU init (measured: room_01
        VI plateaued at 0.76 m uniform offset, r5)."""
        out = []
        for ts, T_rel, ref in self.trajectory:
            if T_rel is not None:
                T_rel = np.asarray(T_rel).copy()
                T_rel[:3, 3] *= s
                if ref == -2 and Ryw is not None:
                    T_rel[:3, :3] = T_rel[:3, :3] @ np.asarray(Ryw).T
            out.append((ts, T_rel, ref))
        self.trajectory = out

    def trajectory_twc(self):
        """[(ts, Twc 4x4)] for evaluation (camera-to-world). Entries from
        earlier Atlas maps were frozen at map-switch time; current-map
        entries recompose against the latest keyframe poses."""
        self.flush_pipeline()
        self._drain_mapping()
        kf_T = np.asarray(self.map.kf_T)
        rows = self._pull_trajectory_rows()
        out = list(self._traj_frozen)
        for i, (ts, T_rel, ref) in enumerate(self.trajectory):
            if T_rel is not None:
                Tcw = rows[i] if ref == -2 else rows[i] @ kf_T[ref]
                out.append((ts, np.linalg.inv(Tcw)))
        out.sort(key=lambda e: e[0])
        return out


class MixedMonoSlam(MonoSlam):
    """Monocular SLAM over mixed ORB + AKAZE features (the reference's
    ``Features.mode: 2`` MixedFrame pipeline, include/MixedFrame.h:60-209).

    Frame slots are channel-partitioned (first ``orb_frac`` ORB, rest
    AKAZE/MLDB-256); all downstream matching/BA is channel-agnostic because
    both descriptors share the 256-bit ±1 layout and cross-channel Hamming
    collisions are statistically nil (see ops/frontend.extract_mixed)."""

    def __init__(self, cam_params, orb_frac: float = 0.5, **kw):
        super().__init__(cam_params, **kw)
        self.orb_frac = orb_frac

    def process_image(self, img: jnp.ndarray, ts: float,
                      max_kp: Optional[int] = None):
        from eorb_slam_tpu.ops import frontend as fe

        if max_kp is None:
            max_kp = self.map.N
        feats, channel = fe.extract_mixed(img, max_kp=max_kp,
                                          orb_frac=self.orb_frac)
        xy_ud = cam_mod.undistort_points(self.cam, feats.xy)
        self.last_channel = channel
        return self.process_features(
            FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        )
