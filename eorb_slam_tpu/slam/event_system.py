"""Event SLAM pipeline: L1 window builder + L2 tracker over MCIs.

Replaces the reference's L6 stack — ``EvTrackManager`` (orchestrator,
src/Event/EvTrackManager.cpp:340-391), ``EvAsynchTracker``/``U`` (the L2
mini ORB-SLAM over reconstructed event images,
src/Event/EvAsynchTracker.cpp:1403-1605), and ``EvLocalMapping`` — with a
host loop over jitted steps. There are no threads: L1 candidate synthesis is
batched inside one jit (event/builder.py) and L2 reuses the SAME tensor-map
SLAM core as the image pipeline (slam/system.MonoSlam), instantiated with
its own map arrays — the reference's "second Atlas for event maps"
(src/Event/EvTrackManager.cpp:39) is literally a second MapState value.

The L2->L1 pose/depth feedback channel mirrors ``PoseDepthInfo`` (reference
include/Utils/MyDataTypes.h:547-582): after each tracked MCI the current
pose pair + median scene depth are posted to the builder so its next
DPose-MCI candidate can motion-compensate with a real SE3 interpolation.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.event import builder as ev_builder
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.slam import system as slam_system


class EventSlam:
    """Event-only SLAM (EVENT_ONLY mode; reference System::TrackEvent,
    src/System.cc:800-866 driving EvImBuilder + EvAsynchTracker)."""

    def __init__(
        self,
        cam_params: jnp.ndarray,
        cfg: Optional[ev_builder.BuilderConfig] = None,
        max_kp: int = 256,
        K: int = 24,
        M: int = 2048,
        P: int = 8,
        min_init_matches: int = 40,
        min_track_inliers: int = 10,
        seed: int = 0,
    ):
        self.cfg = cfg or ev_builder.BuilderConfig()
        self.builder = ev_builder.EventWindowBuilder(self.cfg, cam_params)
        self.max_kp = max_kp
        # L2 tracker: the same tensor-map SLAM core over event images, with
        # its own (event-)Atlas map arrays
        self.l2 = slam_system.MonoSlam(
            cam_params,
            img_w=self.cfg.img_w,
            img_h=self.cfg.img_h,
            K=K, M=M, N=max_kp, P=P,
            min_init_matches=min_init_matches,
            min_init_triangulated=max(15, min_init_matches * 3 // 4),
            min_track_inliers=min_track_inliers,
            seed=seed,
            # the per-MCI decision pull overlaps the next window's dispatch
            # (one lagged sync instead of a blocking one per MCI)
            pipelined=True,
            # event-KF cadence: MCIs decorrelate far faster than camera
            # frames (window-size adaptation changes integration time, and
            # the winning candidate kind flips between hist/se2/dpose), so
            # keyframes must land every few windows — the reference's
            # needNewKeyFrame fires on median-track-displacement at MCI
            # rate (src/Event/EvAsynchTracker.cpp:1278)
            max_frames_between_kf=3,
            kf_inlier_ratio=0.8,
        )
        # no SearchInNeighbors/Fuse over MCIs: the reference's event-side
        # mapper has no fuse pass (EvLocalMapping, SURVEY 2.8), and coarse
        # event features make duplicate-merging net-harmful
        self.l2.fuse_enabled = False
        # save-chain-then-reinit (reference EvAsynchTracker lost handling,
        # src/Event/EvAsynchTracker.cpp:1348): short event KF chains are
        # stored, not thrown away — the trajectory keeps its piecewise
        # segments and fuseEventTracks-style stitching stays possible
        self.l2.min_kf_store = 4
        self._T_prev_mci: Optional[np.ndarray] = None
        self.n_mci = 0
        self.n_tracked = 0

    # ---------------------------------------------------------------- input

    def track_events(self, events: np.ndarray) -> list[dict]:
        """System::TrackEvent: push a raw event chunk and run the L1/L2 state
        machines until the buffer is drained. Returns L2 results for every
        completed MCI.

        The L1 builder runs window-at-a-time (builder.step_window): one
        dispatch per window, no blocking pulls — per-chunk tiny frames never
        reach the host (their KLT continuity lives inside the window jit)."""
        self.builder.feed(events)
        out = []
        while True:
            pi = self.builder.step_window()
            if pi is None:
                break
            out.append(self._track_mci(pi))
        return out

    # ------------------------------------------------------------------ L2

    def _track_mci(self, pi: ev_builder.PoseImage) -> dict:
        self.n_mci += 1
        img = jnp.asarray(pi.img * 255.0, jnp.float32)
        res = self.l2.process_image(img, pi.ts, max_kp=self.max_kp)
        res = dict(res, ts=pi.ts, mci_kind=pi.best_kind)

        if self.l2.state == slam_system.OK:
            self.n_tracked += 1
            # PoseDepthInfo feedback entirely ON DEVICE: T_last and the
            # masked median depth stay device arrays (builder consumes them
            # inside the window jit) — no blocking host pull per MCI
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

    # --------------------------------------------------------------- output

    def trajectory_twc(self):
        return self.l2.trajectory_twc()

    @property
    def stats(self):
        s = dict(self.builder.stats)
        s.update(mci=self.n_mci, tracked=self.n_tracked, **{
            f"l2_{k}": v for k, v in self.l2.stats.items()
        })
        return s
