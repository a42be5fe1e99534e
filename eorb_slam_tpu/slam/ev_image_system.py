"""Event-Image synchronized SLAM (EVENT_MONO mode).

Replaces the reference's synch-tracker hook web (§3.4 of SURVEY.md):
``System::TrackEvMono`` slaves event processing to the image-frame clock —
per image, an MCI is reconstructed at the image timestamp
(``EvTrackManager::reconstSynchEvMCI`` -> ``EvImBuilder::getSynchMCI``,
src/Event/EvTrackManager.cpp:651-690), the event frame is paired with the
ORB frame (``Frame::mpEvFrame`` weak link, include/Frame.h:403), twin
keyframes cross-link the two maps (``KeyFrame::mpSynchOrbKF/mpSynchEvKF``),
and every pose optimization pulls BOTH frames' map-point edges into one
graph (``EvOptimizer::PoseOptimization`` / ``setEventMapVxAndEdges``,
src/Event/EvOptimizer.cpp:634,3714-4032).

Here the two maps are two MapState values (the reference's two Atlases),
and the joint optimization is literally ONE ``pose_only.pose_optimization``
call over the concatenation of both matched observation sets — valid
because a DAVIS sensor's events and frames share one pixel array and hence
one camera model (the reference's event modes use the same YAML camera
section for both).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.event import builder as ev_builder
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.ops import frontend
from eorb_slam_tpu.optim import pose_only, schur_ba
from eorb_slam_tpu.slam import system as slam_system, tracking


@functools.partial(jax.jit, static_argnames=("iters",))
def _joint_local_ba_step(
    im_map, ev_map, cam_params,
    R_ie, t_ie, s_ie,            # Sim3: event-map coords -> image-map coords
    kf_free_im, kf_free_ev,      # (K_im,), (K_ev,) bool BA windows
    ev_sigma_scale: float = 0.5,
    iters: int = 8,
    twin_eps: float = 1e-3,
):
    """JOINT local bundle adjustment over the union of the image map and the
    Sim3-bridged event map — the reference's EvOptimizer::LocalBundleAdjust-
    ment / setEventMapVxAndEdges (src/Event/EvOptimizer.cpp:990,3714-4032),
    which pulls the paired event frames' map points into every BA.

    Event keyframes/landmarks are mapped into the image gauge
    (p_im = s R p_ev + t; camera poses transform as R' = R_ev R^T,
    t' = s t_ev - R' t, which preserves projections under the uniform
    camera-frame scaling), both observation tables concatenate into one
    BAProblem (keyframe axis offset for the event rows), and the solution
    is split back — the event side through the inverse Sim3.

    TWIN COUPLING — what makes this BA actually *joint*: a DAVIS event
    frame and the intensity frame at the same timestamp share one physical
    camera pose, and the reference attaches the event frame's edges to the
    IMAGE frame's pose vertex (twin cross-links mpSynchOrbKF/mpSynchEvKF +
    setEventMapVxAndEdges). Here: every event KF whose timestamp matches an
    image KF (|dt| < twin_eps) retargets its observations onto the image
    vertex, so event landmarks constrain image poses (and vice versa
    through the shared vertex) instead of the union being block-diagonal.
    Twin event vertices are dropped from the solve and follow their image
    twin on the way out.

    Returns (im_map', ev_map', stats[cost0, cost])."""
    K_im = im_map.kf_T.shape[0]
    Rm = R_ie.astype(jnp.float32)
    tm = t_ie.astype(jnp.float32)
    sm = s_ie.astype(jnp.float32)

    def ev_pose_to_im(T):
        Rp = T[:3, :3] @ Rm.T
        tp = sm * T[:3, 3] - Rp @ tm
        return jnp.eye(4, dtype=T.dtype).at[:3, :3].set(Rp).at[:3, 3].set(tp)

    def im_pose_to_ev(T):
        Re = T[:3, :3] @ Rm
        te = (T[:3, 3] + T[:3, :3] @ tm) / sm
        return jnp.eye(4, dtype=T.dtype).at[:3, :3].set(Re).at[:3, 3].set(te)

    ev_T_im = jax.vmap(ev_pose_to_im)(ev_map.kf_T)
    ev_lm_im = sm * (ev_map.lm_pos @ Rm.T) + tm

    # timestamp-twin detection: event KF j <-> image KF twin[j]
    dts = jnp.abs(ev_map.kf_ts[:, None] - im_map.kf_ts[None, :])
    dts = jnp.where(im_map.kf_valid[None, :], dts, jnp.inf)
    twin = jnp.argmin(dts, axis=1)                         # (K_ev,)
    has_twin = (jnp.min(dts, axis=1) < twin_eps) & ev_map.kf_valid

    kf_T = jnp.concatenate([im_map.kf_T, ev_T_im])
    kf_valid = jnp.concatenate([im_map.kf_valid, ev_map.kf_valid])
    kf_fixed = ~jnp.concatenate([kf_free_im, kf_free_ev & ~has_twin])
    lm_pos = jnp.concatenate([im_map.lm_pos, ev_lm_im])
    lm_valid = jnp.concatenate([im_map.lm_valid, ev_map.lm_valid])

    obs_uv_im = im_map.kf_xy[im_map.obs_kf, im_map.obs_feat]
    obs_uv_ev = ev_map.kf_xy[ev_map.obs_kf, ev_map.obs_feat]
    sig_im = frontend.inv_sigma(im_map.kf_octave[im_map.obs_kf,
                                                 im_map.obs_feat])
    sig_ev = frontend.inv_sigma(ev_map.kf_octave[ev_map.obs_kf,
                                                 ev_map.obs_feat])

    # event observations ride their image twin's vertex when one exists
    ev_obs_twin = has_twin[ev_map.obs_kf]                  # (M_ev,P)
    obs_kf_ev = jnp.where(
        ev_obs_twin, twin[ev_map.obs_kf], ev_map.obs_kf + K_im
    )

    prob = schur_ba.BAProblem(
        cam_params=cam_params,
        kf_T=kf_T,
        kf_fixed=kf_fixed,
        kf_valid=kf_valid,
        lm_pos=lm_pos,
        lm_valid=lm_valid,
        obs_kf=jnp.concatenate([im_map.obs_kf, obs_kf_ev]),
        obs_uv=jnp.concatenate([obs_uv_im, obs_uv_ev]),
        obs_inv_sigma=jnp.concatenate([sig_im, ev_sigma_scale * sig_ev]),
        obs_valid=jnp.concatenate([
            im_map.obs_valid & im_map.kf_valid[im_map.obs_kf],
            ev_map.obs_valid & ev_map.kf_valid[ev_map.obs_kf],
        ]),
    )
    res = schur_ba.bundle_adjust(prob, iters=iters)

    M_im = im_map.lm_pos.shape[0]
    im_map = im_map._replace(
        kf_T=res.kf_T[:K_im], lm_pos=res.lm_pos[:M_im],
    )
    # twin event KFs follow the refined image vertex exactly
    ev_T_im_out = jnp.where(
        has_twin[:, None, None], res.kf_T[twin], res.kf_T[K_im:]
    )
    ev_T_new = jax.vmap(im_pose_to_ev)(ev_T_im_out)
    ev_T_new = jnp.where(ev_map.kf_valid[:, None, None], ev_T_new,
                         ev_map.kf_T)
    ev_lm_new = ((res.lm_pos[M_im:] - tm) @ Rm) / sm
    ev_map = ev_map._replace(kf_T=ev_T_new, lm_pos=ev_lm_new)
    return im_map, ev_map, jnp.stack([res.cost0, res.cost])


@jax.jit
def _propagate_loop_to_event(
    ev_map, im_kf_ts, im_kf_valid, T_before, T_after, R_ie, t_ie, s_ie,
):
    """Carry an IMAGE-map loop correction into the synch event map.

    The reference's LoopClosing corrects the event side alongside the image
    side (event-aware optimizer dispatch src/LoopClosing.cc:2535-2549 and
    the scale/rotation hooks ApplyScaleAndRotationEvSynch, :2075-2094).
    Here: each event keyframe anchors to its nearest-in-time image keyframe
    and follows that keyframe's correction D_j = T_before_j^-1 T_after_j
    rigidly (the reference's timestamp-interpolated relative-pose stitching,
    src/Utils/MyOptimizer.cpp:3296 findNearestPose); event landmarks follow
    their first-observing keyframe's anchor, keeping camera-frame
    coordinates fixed through the weld. All algebra in the image gauge via
    the Sim3 bridge (R_ie, t_ie, s_ie)."""
    Rm = R_ie.astype(jnp.float32)
    tm = t_ie.astype(jnp.float32)
    sm = s_ie.astype(jnp.float32)

    def ev_pose_to_im(T):
        Rp = T[:3, :3] @ Rm.T
        tp = sm * T[:3, 3] - Rp @ tm
        return jnp.eye(4, dtype=T.dtype).at[:3, :3].set(Rp).at[:3, 3].set(tp)

    def im_pose_to_ev(T):
        Re = T[:3, :3] @ Rm
        te = (T[:3, 3] + T[:3, :3] @ tm) / sm
        return jnp.eye(4, dtype=T.dtype).at[:3, :3].set(Re).at[:3, 3].set(te)

    d = jnp.abs(ev_map.kf_ts[:, None] - im_kf_ts[None, :])
    d = jnp.where(im_kf_valid[None, :], d, jnp.inf)
    anchor = jnp.argmin(d, axis=1)                        # (K_ev,)

    D = jnp.einsum(
        "kij,kjl->kil",
        jax.vmap(lie.se3_inv)(T_before[anchor]), T_after[anchor],
    )                                                     # (K_ev,4,4)
    Te_img = jax.vmap(ev_pose_to_im)(ev_map.kf_T)
    Te_new = jax.vmap(im_pose_to_ev)(
        jnp.einsum("kij,kjl->kil", Te_img, D)
    )
    Te_new = jnp.where(ev_map.kf_valid[:, None, None], Te_new, ev_map.kf_T)

    aj = anchor[jnp.clip(ev_map.lm_first_kf, 0)]          # (M,)
    Dl = jnp.einsum(
        "mij,mjl->mil",
        jax.vmap(lie.se3_inv)(T_after[aj]), T_before[aj],
    )
    y = sm * (ev_map.lm_pos @ Rm.T) + tm                  # ev -> image gauge
    y_new = jnp.einsum("mij,mj->mi", Dl[:, :3, :3], y) + Dl[:, :3, 3]
    x_new = ((y_new - tm) @ Rm) / sm
    x_new = jnp.where(ev_map.lm_valid[:, None], x_new, ev_map.lm_pos)
    return ev_map._replace(kf_T=Te_new, lm_pos=x_new)


@jax.jit
def _init_triangulate_known_poses(
    cam_params,
    d1, v1, xy1,      # event features at the earlier image-tracked frame
    d2, v2, xy2,      # event features at the later image-tracked frame
    T1, T2,           # (4,4) IMAGE-tracker poses at the two timestamps
):
    """Joint event-map initialization core (reference resolveEventMapInit /
    evImReconst2ViewsSynch, src/Event/EvTrackManager.cpp:810,:819): match
    the two event frames and triangulate with the IMAGE tracker's poses —
    the event map is born directly in the image gauge (identity Sim3
    bridge), instead of waiting for an independent event init + a
    trajectory-derived gauge. Returns (m12, pts3d_world, ok, n_ok)."""
    from eorb_slam_tpu.geometry import camera as geo_cam, triangulation
    from eorb_slam_tpu.ops import matching

    # LOOSE matching (TH_HIGH, wide window): with KNOWN poses the
    # triangulation reprojection gate rejects wrong pairs far more reliably
    # than a tight descriptor threshold — MCI descriptors are blurry and a
    # TH_LOW mutual match keeps only a handful of pairs across a baseline
    pair = matching.window_mask(xy1, xy2, 150.0)
    m12, _ = matching.match_nnratio(
        d1, v1, d2, v2, pair_mask=pair,
        max_dist=matching.TH_HIGH, nn_ratio=0.9, mutual=True,
    )
    idx2 = jnp.where(m12 >= 0, m12, 0)
    ray1 = geo_cam.pinhole_unproject_linear(cam_params, xy1)
    ray2 = geo_cam.pinhole_unproject_linear(cam_params, xy2[idx2])
    pts = triangulation.triangulate_dlt(T1[None], T2[None], ray1, ray2)
    fx = cam_params[0]
    ok_tri, _ = triangulation.triangulation_checks(
        T1[None], T2[None], ray1, ray2, pts,
        min_parallax_cos=0.9995,  # >=1.8 deg; the caller gates baseline
        inv_sigma1=fx, inv_sigma2=fx,
    )
    ok = ok_tri & (m12 >= 0) & v1
    return m12, idx2, pts, ok, jnp.sum(ok.astype(jnp.int32))


@jax.jit
def _joint_pose_step(
    cam_params,
    im_lm_pos, ev_lm_pos,
    feat_lm_i, xy_i, oct_i,
    feat_lm_e, xy_e, oct_e,
    R_ie, t_ie, s_ie,
    Tcw0,
):
    """Joint image+event pose optimization as ONE dispatch: gather both
    matched landmark sets (event side Sim3-bridged), one GN solve, packed
    host flags [n_inl_total, n_inl_image, finite]."""
    mi = feat_lm_i >= 0
    me = feat_lm_e >= 0
    pts_i = im_lm_pos[jnp.where(mi, feat_lm_i, 0)]
    pts_e_raw = ev_lm_pos[jnp.where(me, feat_lm_e, 0)]
    pts_e = s_ie * (pts_e_raw @ R_ie.T) + t_ie
    pts = jnp.concatenate([pts_i, pts_e])
    uv = jnp.concatenate([xy_i, xy_e])
    inv_sig = jnp.concatenate(
        [frontend.inv_sigma(oct_i), 0.5 * frontend.inv_sigma(oct_e)]
    )
    valid = jnp.concatenate([mi, me])
    Tj, inlier, n_inl = pose_only.pose_optimization(
        cam_params, Tcw0, pts, uv, inv_sig, valid
    )
    n_im = xy_i.shape[0]
    flags = jnp.stack([
        n_inl.astype(jnp.float32),
        jnp.sum(inlier[:n_im]).astype(jnp.float32),
        jnp.isfinite(Tj).all().astype(jnp.float32),
    ])
    return Tj, flags


@jax.jit
def _joint_writeback(Tj, T_last_im, T_last_ev, R_ie, t_ie, s_ie, ref_T_im):
    """Post-joint-solve pose algebra in one dispatch: both trackers' motion
    models, the event-gauge twin pose, and the trajectory entry."""
    vel_im = Tj @ lie.se3_inv(T_last_im)
    Te = (
        jnp.eye(4, dtype=Tj.dtype)
        .at[:3, :3].set(Tj[:3, :3] @ R_ie)
        .at[:3, 3].set((Tj[:3, :3] @ t_ie + Tj[:3, 3]) / s_ie)
    )
    vel_ev = Te @ lie.se3_inv(T_last_ev)
    T_rel = Tj @ lie.se3_inv(ref_T_im)
    return vel_im, Te, vel_ev, T_rel


class EvImageSlam:
    """One clock (image frames), two maps (image + event), joint pose opt."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        img_w: int = 240,
        img_h: int = 180,
        max_kp: int = 512,
        ev_max_kp: int = 256,
        synch_window_s: float = 0.15,
        **slam_kw,
    ):
        self.cam = cam_params
        self.cfg = cfg or ev_builder.BuilderConfig(img_w=img_w, img_h=img_h)
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params)
        self.synch_window_s = synch_window_s
        self.max_kp = max_kp
        self.ev_max_kp = ev_max_kp

        self.im = slam_system.MonoSlam(
            cam_params, img_w=img_w, img_h=img_h, N=max_kp, **slam_kw
        )
        # opt into the loop-correction handoff (consumed in process(); a
        # standalone MonoSlam never stashes, so the pre-correction kf_T
        # device buffer isn't pinned between loops)
        self.im.loop_correction_consumer = True
        ev_min_init = max(20, slam_kw.get("min_init_matches", 40) // 2)
        self.ev = slam_system.MonoSlam(
            cam_params, img_w=img_w, img_h=img_h, N=ev_max_kp,
            K=slam_kw.get("K", 32), M=slam_kw.get("M", 4096),
            min_init_matches=ev_min_init,
            min_init_triangulated=max(15, ev_min_init * 3 // 4),
            min_track_inliers=8,
        )
        # event twin map: no fuse pass (EvLocalMapping has none; coarse MCI
        # features make duplicate-merging net-harmful)
        self.ev.fuse_enabled = False
        self._ev_buf = np.zeros((0, 4), np.float64)
        self._last_im_ts: Optional[float] = None
        self.joint_frames = 0
        # ORB-driven event init (reference SetInitEvFrameSynch /
        # resolveEventMapInit): stash of (ts, event FrameInput, Tcw_image)
        # from image-tracked frames while the event map does not exist —
        # the event map is then triangulated directly in the image gauge
        self._ev_stash: list = []
        self._ev_stash_cap = 20
        self.joint_inits = 0
        self.gauge_reseeds = 0
        # paired per-tracker poses (ts, Tcw_im, Tcw_ev) feeding the Sim3
        # gauge bridge between the two monocular maps (the reference aligns
        # the event map with scale AND rotation — ApplyScaleAndRotationEvSynch,
        # src/LoopClosing.cc:2075-2094)
        self._gauge_pairs: list[tuple[float, np.ndarray, np.ndarray]] = []
        self._gauge_window = 12
        # joint event+image LOCAL BA (reference EvOptimizer::LocalBundle-
        # Adjustment dispatch, src/LocalMapping.cc:163-188): runs after an
        # image keyframe insertion once the Sim3 gauge bridge is healthy
        self.joint_ba_enabled = True
        self.joint_bas = 0
        self.joint_loop_gbas = 0
        self._last_gauge = None
        # after a JOINT init the two maps share one gauge BY CONSTRUCTION
        # and the joint BA keeps them there — the bridge is pinned at
        # identity and never re-fit from (noisy, baseline-starved)
        # trajectory pairs (measured: a re-fit at 4 pairs produced s=0.06
        # and tore the slaved tracker apart). Map-level rescales (IMU init)
        # are replayed on the event map instead, reference
        # ApplyScaleAndRotationEvSynch (src/LoopClosing.cc:2075-2094).
        self._gauge_locked = False

    # ---------------------------------------------------------------- input

    def track_ev_mono(self, events: np.ndarray, img: np.ndarray, ts: float,
                      imu=None):
        """System::TrackEvMono (src/System.cc:868-939): buffer events, build
        the synch MCI at the image timestamp, run both trackers + joint
        refinement. ``imu`` (ImuChunk since the previous frame) is forwarded
        to inertial image trackers (EVENT_IMU_MONO mode)."""
        if len(events):
            self._ev_buf = np.concatenate(
                [self._ev_buf, np.asarray(events, np.float64)]
            )

        mci = self._synch_mci(ts)

        # image tracker first (clock master)
        im_res = self._track_image(img, ts, imu)

        # an image-side loop correction must move the event map with it and
        # the post-loop global BA must SEE the event observations (reference
        # EvOptimizer dispatch from LoopClosing/GBA, src/LoopClosing.cc:
        # 2535-2549) — otherwise the event map only follows through a stale
        # gauge and the weld tears the joint state apart
        if self.im.last_loop_correction is not None:
            self._on_image_loop(*self.im.last_loop_correction)
            self.im.last_loop_correction = None

        ev_res = None
        if mci is not None:
            mci_img = jnp.asarray(mci.img * 255.0, jnp.float32)
            im_ok = (
                self.im.state == slam_system.OK
                and self.im.last_frame is not None
                and self.im.last_frame.ts == ts
            )
            if self.ev.state == slam_system.OK:
                # SLAVE the event tracker to the image pose (the reference's
                # synch trackers take the ORB pose as the per-frame prior,
                # EvSynchTracker::trackAndOptEvFrameSynch): the image tracker
                # has ALREADY solved this timestamp, so mapping its current
                # pose through the gauge is an exact prediction — the event
                # side only has to match against it, not dead-reckon
                if im_ok and self._last_gauge is not None:
                    self._seed_ev_from_image()
                elif im_ok:
                    self.ev.velocity = self.im.velocity
                ev_res = self.ev.process_image(
                    mci_img, ts, max_kp=self.ev_max_kp,
                )
            elif self.ev.state == slam_system.NOT_INITIALIZED:
                # ORB-driven joint init: the event map is triangulated with
                # the IMAGE tracker's poses, in the image gauge (reference
                # resolveEventMapInit, src/Event/EvTrackManager.cpp:810)
                if im_ok:
                    ev_res = self._try_joint_event_init(mci_img, ts)
            else:
                # event tracker lost but the image tracker is healthy:
                # re-anchor the event pose through the gauge and retry —
                # the synch tracker is SLAVED to the ORB pose (reference
                # EvSynchTracker prior seeding), it never free-runs reloc
                if im_ok and self._last_gauge is not None:
                    # plant the gauge-mapped image pose and retry; the lost
                    # counter KEEPS counting so the tracker's own grace
                    # logic can escalate to a map reset -> joint RE-init
                    # (resetting the counter here would pin the tracker in
                    # RECENTLY_LOST forever, burning reseeds on a map too
                    # sparse to track — measured on seed 11: 10-landmark
                    # seed, 7/32 frames tracked)
                    self._seed_ev_from_image()
                    self.gauge_reseeds += 1
                    ev_res = self.ev.process_image(
                        mci_img, ts, max_kp=self.ev_max_kp,
                    )

        joint = self._joint_refine(ts)
        # joint event+image local BA on keyframe insertions from EITHER
        # side (the reference pulls event map points into every
        # LocalMapping BA — image thread src/LocalMapping.cc:163-188 AND
        # event mapper EvLocalMapping.cpp:162-172); one fused dispatch
        # over the union problem with twin-vertex coupling
        new_kf = (isinstance(im_res, dict) and im_res.get("kf")) or (
            isinstance(ev_res, dict) and ev_res.get("kf"))
        if (
            self.joint_ba_enabled
            and self._last_gauge is not None
            and joint is not None and not joint.get("rejected")
            and new_kf
            and self.ev.n_kf >= 2
        ):
            self._run_joint_ba()
        self._last_im_ts = ts
        return {"image": im_res, "event": ev_res, "joint": joint}

    def _try_joint_event_init(self, mci_img, ts: float):
        """Initialize the event map FROM the image tracker (the reference's
        SetInitEvFrameSynch + evImReconst2ViewsSynch + resolveEventMapInit,
        src/Event/EvSynchTrackerU.cpp:127-140, src/Event/EvTrackManager.cpp:
        810-819): stash event frames at image-tracked timestamps; once two
        stashed frames have image-pose baseline, match + triangulate with
        those poses, seed the event map in the IMAGE gauge, and run one
        JOINT init BA over both observation sets. The Sim3 bridge starts at
        identity instead of waiting for trajectory-derived estimation."""
        from eorb_slam_tpu.geometry import camera as geo_cam
        from eorb_slam_tpu.slam import map_state as ms_mod
        from eorb_slam_tpu.slam.system import FrameInput

        feats = frontend.extract(mci_img, max_kp=self.ev.map.N)
        xy_ud = geo_cam.undistort_points(self.cam, feats.xy)
        f = FrameInput(ts, xy_ud, feats.octave, feats.angle,
                       feats.desc_pm1, feats.valid)
        Ti = np.asarray(self.im.T_last)
        self._ev_stash.append((ts, f, Ti))
        self._ev_stash = self._ev_stash[-self._ev_stash_cap:]
        if len(self._ev_stash) < 2:
            return {"state": self.ev.state, "joint_init": False}

        # partner candidates: NEWEST stashed frames first — MCI appearance
        # decorrelates fast, so matching quality beats baseline size
        # (largest-baseline-first measured n<=11 matches where newest-first
        # got 46). Floor 0.02 map units: below it no point can pass the
        # 1.8 deg parallax gate at the median-normalized scene depth of 1
        # (the old 0.05 floor stalled seed-11 init for 2.2 s).
        C_cur = -Ti[:3, :3].T @ Ti[:3, 3]
        cands = []
        for ts0, f0, T0 in reversed(self._ev_stash[:-1]):
            C0 = -T0[:3, :3].T @ T0[:3, 3]
            if np.linalg.norm(C0 - C_cur) >= 0.02:
                cands.append((ts0, f0, T0))
            if len(cands) >= 3:
                break
        if not cands:
            return {"state": self.ev.state, "joint_init": False}

        best = None
        for ts0, f0, T0 in cands:
            m12, idx2, pts, ok, n = _init_triangulate_known_poses(
                self.cam, f0.desc_pm1, f0.valid, f0.xy_ud,
                f.desc_pm1, f.valid, f.xy_ud,
                jnp.asarray(T0, jnp.float32), jnp.asarray(Ti, jnp.float32),
            )
            n = int(n)
            if best is None or n > best[0]:
                best = (n, ts0, f0, T0, idx2, pts, ok)
        n, ts0, f0, T0, idx2, pts, ok = best
        # the poses are KNOWN here (image tracker), so fewer points than a
        # blind two-view init are enough — but a map the per-frame tracker
        # cannot hold (~2x its inlier floor) must not be seeded at all:
        # a hopeless seed costs a full lost->reset cycle (measured seed 11)
        if n < max(20, 2 * self.ev.min_track_inliers,
                   self.ev.min_init_triangulated // 2):
            return {"state": self.ev.state, "joint_init": False, "n": n}

        ev = self.ev
        N = ev.map.N
        feat_ids = jnp.arange(N, dtype=jnp.int32)
        m = ev.map
        m = ms_mod.insert_keyframe(
            m, jnp.asarray(0), jnp.asarray(T0, jnp.float32), ts0,
            f0.xy_ud, f0.octave, f0.angle, f0.desc_pm1, f0.valid,
            jnp.full(N, -1, jnp.int32),
        )
        m = ms_mod.insert_keyframe(
            m, jnp.asarray(1), jnp.asarray(Ti, jnp.float32), ts,
            f.xy_ud, f.octave, f.angle, f.desc_pm1, f.valid,
            jnp.full(N, -1, jnp.int32),
        )
        m, _ = ms_mod.alloc_landmarks(
            m, pts, f0.desc_pm1, ok, jnp.asarray(0), feat_ids,
            jnp.asarray(1), idx2,
        )
        ev.map = m
        ev.n_kf = 2

        # joint init BA: image gauge pinned, event KF1 + all landmarks free
        kf_free_ev = np.zeros(ev.map.K, bool)
        kf_free_ev[1] = True
        self.im.map, self.ev.map, _ = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam,
            jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.asarray(1.0, jnp.float32),
            jnp.asarray(np.zeros(self.im.map.K, bool)),
            jnp.asarray(kf_free_ev),
        )

        ev.state = slam_system.OK
        ev.T_last = ev.map.kf_T[1]
        ev.velocity = jnp.eye(4)
        ev.frames_since_kf = 0
        ev.n_inliers_ref = n
        ev._last_kf_ts = ts
        ev.last_frame = f
        ev._log_pose(ts, ev.T_last)
        ev.stats["kf"] = 2
        ev.stats["lm"] = int(np.asarray(ev.map.lm_valid).sum())
        if ev.loop_closer is not None:
            ev.loop_closer.add_keyframe(ev.map, 0)
            ev.loop_closer.add_keyframe(ev.map, 1)

        # the bridge is identity BY CONSTRUCTION — and stays pinned there
        self._last_gauge = (1.0, np.eye(3), np.zeros(3))
        self._gauge_locked = True
        self._gauge_pairs = []
        self._ev_stash.clear()
        self.joint_inits += 1
        return {"state": ev.state, "joint_init": True, "n": n}

    def _seed_ev_from_image(self):
        """Map the image tracker's CURRENT pose through the Sim3 bridge into
        the event gauge and plant it as the event tracker's prediction
        (identity velocity): Tcw_ev = [R_i R_ie | (R_i t_ie + t_i)/s]."""
        s, R_ie, t_ie = self._last_gauge
        Ti = np.asarray(self.im.T_last)
        Te = np.eye(4, dtype=np.float32)
        Te[:3, :3] = Ti[:3, :3] @ R_ie
        Te[:3, 3] = (Ti[:3, :3] @ t_ie + Ti[:3, 3]) / s
        self.ev.T_last = jnp.asarray(Te)
        self.ev.velocity = jnp.eye(4)

    def _on_image_loop(self, T_before, info, valid_before=None,
                       ts_before=None):
        """Event side of a loop correction: rigid follow of the weld +
        joint event+image global BA (the event-aware GBA of reference
        src/LoopClosing.cc:2535-2549 / EvOptimizer.cpp:3714-4032)."""
        # paired poses predating the correction no longer constrain the
        # gauge consistently — restart accumulation from the corrected state
        self._gauge_pairs = []
        if (
            self._last_gauge is None
            or self.ev.n_kf < 2
            or self.ev.state not in (slam_system.OK, slam_system.LOST)
        ):
            return
        s, R_ie, t_ie = self._last_gauge
        # anchor against the slots valid AT CORRECTION TIME — a map merge
        # in the same keyframe insertion can validate slots whose T_before
        # rows are garbage (advisor r4)
        anchor_ts = self.im.map.kf_ts if ts_before is None else ts_before
        anchor_valid = (self.im.map.kf_valid if valid_before is None
                        else valid_before & self.im.map.kf_valid)
        self.ev.map = _propagate_loop_to_event(
            self.ev.map, anchor_ts, anchor_valid,
            T_before, self.im.map.kf_T,
            jnp.asarray(R_ie, jnp.float32), jnp.asarray(t_ie, jnp.float32),
            jnp.asarray(s, jnp.float32),
        )
        # joint GBA over BOTH observation sets: every image KF free except
        # the loop anchor (reference RunGlobalBundleAdjustment fixes the
        # loop KF), every event KF free
        im_free = np.asarray(self.im.map.kf_valid).copy()
        if 0 <= info.matched < len(im_free):
            im_free[info.matched] = False
        ev_free = np.asarray(self.ev.map.kf_valid)
        self.im.map, self.ev.map, _ = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam,
            jnp.asarray(R_ie, jnp.float32), jnp.asarray(t_ie, jnp.float32),
            jnp.asarray(s, jnp.float32),
            jnp.asarray(im_free), jnp.asarray(ev_free),
        )
        self.im.T_last = self.im.map.kf_T[self.im._kf_ref()]
        self.im.velocity = jnp.eye(4)
        if self.ev.last_kf_slot >= 0:
            self.ev.T_last = self.ev.map.kf_T[self.ev.last_kf_slot]
        self.ev.velocity = jnp.eye(4)
        self.joint_loop_gbas += 1

    def _run_joint_ba(self):
        s, R_ie, t_ie = self._last_gauge
        im_free = self.im._ba_window()
        ev_free = self.ev._ba_window()
        ref = self.im._kf_ref()
        T_ref_before = self.im.map.kf_T[ref]
        self.im.map, self.ev.map, stats = _joint_local_ba_step(
            self.im.map, self.ev.map, self.cam,
            jnp.asarray(R_ie, jnp.float32), jnp.asarray(t_ie, jnp.float32),
            jnp.asarray(s, jnp.float32),
            jnp.asarray(im_free), jnp.asarray(ev_free),
        )
        # the CURRENT pose follows its reference keyframe's correction
        # relatively (a plain rewind to the KF pose here threw away the
        # frames tracked since the KF — measured 5x ATE blowup when the BA
        # fires on an event-KF frame mid-interval)
        if ref >= 0:
            self.im.T_last = (
                self.im.T_last @ lie.se3_inv(T_ref_before)
                @ self.im.map.kf_T[ref]
            )
        self.joint_bas += 1

    def _track_image(self, img: np.ndarray, ts: float, imu=None):
        """Image-tracker hook; the inertial variant overrides this to route
        the IMU window into the frame (slam/event_inertial.py)."""
        return self.im.process_image(
            jnp.asarray(img, jnp.float32), ts, max_kp=self.max_kp
        )

    def _synch_mci(self, ts: float) -> Optional[ev_builder.PoseImage]:
        """getSynchMCI: MCI over the events ending at the image timestamp
        (reference src/Event/EvImBuilder.cpp:1249)."""
        sel = self._ev_buf[:, 0] <= ts
        window = self._ev_buf[sel]
        self._ev_buf = self._ev_buf[~sel]
        if len(window) < self.cfg.min_chunk:
            return None
        window = window[window[:, 0] >= ts - self.synch_window_s]
        if len(window) < self.cfg.min_chunk:
            return None
        # build_mci does NOT touch builder buffers — the reference's
        # getSynchMCI likewise builds from the passed events without
        # re-injecting an overlap tail into a queue nothing drains
        return self.builder.build_mci(window)

    # ------------------------------------------------------------ joint opt

    def _estimate_gauge(self):
        """Full Sim3 (s, R_ie, t_ie) mapping event-map coordinates into the
        image-map gauge, from recent frames where BOTH trackers tracked
        independently. Two independently initialized monocular maps differ by
        a full Sim3, not just a scale (the reference applies scale AND
        rotation: ApplyScaleAndRotationEvSynch, src/LoopClosing.cc:2075-2094).

        Per pair k the rotations give R_ie = R_im^T R_ev directly; the scale
        comes from camera-center baseline ratios; the translation from the
        residual means. Returns (s, R_ie, t_ie, residual) or None if under-
        constrained / the two gauges disagree."""
        pairs = self._gauge_pairs[-self._gauge_window:]
        if len(pairs) < 3:
            return None
        R_sum = np.zeros((3, 3))
        C_im, C_ev = [], []
        for _, Ti, Te in pairs:
            R_sum += Ti[:3, :3].T @ Te[:3, :3]
            C_im.append(-Ti[:3, :3].T @ Ti[:3, 3])
            C_ev.append(-Te[:3, :3].T @ Te[:3, 3])
        # chordal mean of the per-frame R_ie estimates
        U, _, Vt = np.linalg.svd(R_sum)
        R_ie = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
        C_im = np.stack(C_im)
        C_ev = np.stack(C_ev)

        d_im = np.linalg.norm(np.diff(C_im, axis=0), axis=1)
        d_ev = np.linalg.norm(np.diff(C_ev, axis=0), axis=1)
        ok = d_ev > 1e-4
        if ok.sum() < 2 or float(d_im[ok].max()) < 1e-4:
            return None
        s = float(np.median(d_im[ok] / d_ev[ok]))
        if not np.isfinite(s) or s < 1e-6:
            return None
        t_ie = (C_im - s * (R_ie @ C_ev.T).T).mean(axis=0)

        # agreement gate: the Sim3 must actually explain the paired centers
        resid = np.linalg.norm(C_im - (s * (R_ie @ C_ev.T).T + t_ie), axis=1)
        span = float(d_im.sum())
        if float(np.median(resid)) > max(0.25 * span, 1e-3):
            return None
        return s, R_ie, t_ie, float(np.median(resid))

    def _joint_refine(self, ts: float):
        """EvOptimizer::PoseOptimization equivalent: one GN solve over the
        union of image-map and event-map matches of the paired frames, with
        the event landmarks Sim3-bridged into the image gauge."""
        if (
            self.im.state != slam_system.OK
            or self.ev.state != slam_system.OK
            or self.im.last_track is None
            or self.ev.last_track is None
            or self.im.last_frame is None
            or self.ev.last_frame is None
            or self.im.last_frame.ts != ts
            or self.ev.last_frame.ts != ts
        ):
            return None

        tr_i, f_i = self.im.last_track, self.im.last_frame
        tr_e, f_e = self.ev.last_track, self.ev.last_frame
        if self._gauge_locked:
            s, R_ie, t_ie = self._last_gauge
            return self._joint_solve(ts, tr_i, f_i, tr_e, f_e,
                                     s, R_ie, t_ie, 0.0)
        self._gauge_pairs.append(
            (ts, np.asarray(tr_i.Tcw), np.asarray(tr_e.Tcw))
        )
        gauge = self._estimate_gauge()
        if gauge is None:
            # under-constrained estimate: KEEP the previous bridge (after a
            # joint init it is identity BY CONSTRUCTION and must not be
            # discarded for lack of baseline; drift between the maps is
            # absorbed by the joint BA, not by re-estimating every frame)
            if self._last_gauge is None:
                return None
            s, R_ie, t_ie = self._last_gauge
            resid = -1.0
        else:
            s, R_ie, t_ie, resid = gauge
            self._last_gauge = (s, R_ie, t_ie)
        return self._joint_solve(ts, tr_i, f_i, tr_e, f_e,
                                 s, R_ie, t_ie, resid)

    def _joint_solve(self, ts, tr_i, f_i, tr_e, f_e, s, R_ie, t_ie, resid):
        # ONE dispatch for the joint solve + ONE packed flags pull (the
        # eager gather/concat/solve path was ~10 blocking syncs per frame).
        # Event points carry half weight: Sim3-bridged
        # through an estimated (drifting) gauge, and MCI keypoints are
        # intrinsically blurrier.
        Tj, flags = _joint_pose_step(
            self.cam, self.im.map.lm_pos, self.ev.map.lm_pos,
            tr_i.feat_lm, f_i.xy_ud, f_i.octave,
            tr_e.feat_lm, f_e.xy_ud, f_e.octave,
            jnp.asarray(R_ie, jnp.float32), jnp.asarray(t_ie, jnp.float32),
            jnp.asarray(s, jnp.float32), tr_i.Tcw,
        )
        n_inl, im_inl_joint, finite = (float(x) for x in np.asarray(flags))
        # inlier-count sanity on the IMAGE subset: a bad gauge shows up as
        # the joint solve losing image inliers vs the image-only solve —
        # keep the image pose then (event inliers alone must not vouch).
        # PROPORTIONAL gate: chi2 re-classification flips 1-2 borderline
        # inliers between any two solves, so an absolute >= comparison
        # rejects nearly every joint refine (measured: joint_frames 1/29);
        # only a real drop (>10% + 2) indicates a torn gauge
        if im_inl_joint < 0.9 * float(tr_i.n_inliers) - 2.0 or not finite:
            return {"n_inliers": int(n_inl), "rejected": True}

        # write the joint pose back into both trackers (and their gauges):
        # Tcw_ev = [R_j R_ie | (R_j t_ie + t_j)/s] maps event-world to the
        # camera in event-map units — one fused dispatch, nothing pulled
        vel_im, Te_j, vel_ev, T_rel = _joint_writeback(
            Tj, self.im.T_last, self.ev.T_last,
            jnp.asarray(R_ie, jnp.float32), jnp.asarray(t_ie, jnp.float32),
            jnp.asarray(s, jnp.float32),
            self.im.map.kf_T[self.im._kf_ref()],
        )
        self.im.velocity = vel_im
        self.im.T_last = Tj
        self.ev.velocity = vel_ev
        self.ev.T_last = Te_j
        if self.im.trajectory and self.im.trajectory[-1][0] == ts:
            self.im.trajectory.pop()
            self.im.trajectory.append((ts, T_rel, self.im._kf_ref()))
        self.joint_frames += 1
        return {"n_inliers": int(n_inl), "scale_bridge": s, "gauge_resid": resid}

    # --------------------------------------------------------------- output

    def trajectory_twc(self):
        return self.im.trajectory_twc()

    def fused_trajectory(self, **kw):
        """System::FuseEventORB equivalent: weld the event tracker's KF
        chains into the image trajectory's gauge via the joint pose-graph
        solve (slam/fusion.py; reference MyOptimizer::MergeVisualEvent,
        src/Utils/MyOptimizer.cpp:3471). Returns the fusion result dict."""
        from eorb_slam_tpu.slam import fusion

        return fusion.fuse_event_orb(
            self.im.trajectory_twc(), self.ev.trajectory_twc(), **kw
        )

    @property
    def stats(self):
        return {
            "im": dict(self.im.stats),
            "ev": dict(self.ev.stats),
            "joint_frames": self.joint_frames,
            "joint_bas": self.joint_bas,
            "joint_inits": self.joint_inits,
            "joint_loop_gbas": self.joint_loop_gbas,
            "gauge_reseeds": self.gauge_reseeds,
        }
