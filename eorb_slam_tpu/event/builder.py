"""L1 event front-end: adaptive windowing + motion-compensated image (MCI)
synthesis with batched candidate selection.

Re-design of ``EvImBuilder`` (reference
include/Event/EvImBuilder.h:47-230, src/Event/EvImBuilder.cpp:1300-1515):

- the reference consumes ``l1ChunkSize`` raw events per step, Gaussian-splats
  them (ev2im_gauss), KLT-tracks FAST corners between consecutive event
  images, and resizes the next window so the median pixel displacement hits
  ``maxPixelDisp`` (src/Event/EvImBuilder.cpp:197-230);
- on window completion it spawns 3-4 THREADS, each building one MCI
  candidate (L2-pose-warped / BA-pose-warped / plain histogram / SE2
  contrast-maximized) and keeps the one with the best patchwise STD
  (src/Event/EvImBuilder.cpp:1146-1247).

Here every candidate is a fixed-shape jitted computation over the SAME
padded event tensor — XLA's async dispatch replaces the fork-join threads,
the splat is one differentiable kernel, and contrast maximization is jitted
gradient ascent instead of Ceres (see event/contrast_max.py). The host keeps
only scalar control state (cursor, adaptive chunk size, state machine).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.event import contrast_max, klt, tensorize
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.ops import fast


@dataclasses.dataclass
class BuilderConfig:
    """Event.* knobs (reference EvParams, include/Event/EventData.h:75-126;
    defaults from Examples/Event/EvETHZ.yaml:184-211)."""

    img_w: int = 240
    img_h: int = 180
    l1_chunk_size: int = 2000          # Event.data.l1ChunkSize
    l1_num_loop: int = 4               # Event.data.l1NumLoop (L2 win = n*chunk)
    min_chunk: int = 500
    max_chunk: int = 12000
    max_pixel_disp: float = 3.0        # Event.data.maxPixelDisp
    min_ev_gen_rate: float = 1.0       # events/px/s idle gate (minEvGenRate)
    sigma: float = 1.0                 # ev2im_gauss sigma
    cm_iters: int = 40                 # contrast-max ascent iterations
    cm_sample: int = 16384             # events used by the CM *ascent* (the
    #                                    final warp/splat always uses all):
    #                                    the contrast gradient is a mean over
    #                                    events, so a temporal-strided subset
    #                                    estimates it at a fraction of the
    #                                    cost on dense streams
    max_window_events: int = 65536     # static capacity of the L2 window
    n_klt_pts: int = 128               # FAST corners tracked per chunk
    overlap: float = 0.5               # continuous-mode re-injection fraction


class PoseImage(NamedTuple):
    """Dispatch record to L2 (reference PoseImage,
    include/Utils/MyDataTypes.h:85-127): reconst_stat 0 = tiny frame (KLT
    continuity only), 1 = fully reconstructed MCI."""

    img: object                # (H,W) float32 in [0,1] — DEVICE array (the
    #                            L2 tracker consumes it on device; viz/debug
    #                            readers np.asarray on demand)
    ts: float                  # window end timestamp
    ts0: float                 # window start timestamp
    reconst_stat: int
    best_kind: str             # 'hist' | 'se2' | 'dpose' | 'klt2d'
    se2_params: object         # (3,) [omega, vx, vy] from contrast max
    score: float               # winning patch-STD


def _pad_events(ev: np.ndarray, cap: int, t0: Optional[float] = None):
    """(n,4) float64 -> fixed-cap (cap,4) float32 + valid mask (host-side).

    Timestamps are rebased to ``t0`` (default: first kept event) BEFORE the
    float32 cast: raw dataset timestamps can be O(1e5) s (or epoch-scale),
    where float32 quantizes to tens of microseconds and would corrupt the
    per-event relative times inside millisecond-scale MCI windows (the
    reference keeps ``EventData::ts`` double for the same reason,
    include/Event/EventData.h:36-58).

    When the window exceeds ``cap`` the MOST RECENT events are kept — the
    newest events are the ones closest to the dispatch timestamp and the
    tail is what downstream pose/KLT continuity needs. Returns
    (padded, valid, n_dropped).
    """
    n_drop = max(len(ev) - cap, 0)
    if t0 is None:
        t0 = float(ev[n_drop, 0]) if len(ev) else 0.0

    from eorb_slam_tpu.io import native as _native

    nat = _native.pad_rebase(ev, cap, t0)
    if nat is not None:
        return nat

    ev = ev[n_drop:]
    n = len(ev)
    out = np.zeros((cap, 4), np.float32)
    valid = np.zeros(cap, bool)
    out[:n, 0] = (ev[:, 0] - t0).astype(np.float32)
    out[:n, 1:] = ev[:, 1:].astype(np.float32)
    valid[:n] = True
    return out, valid, n_drop


@functools.partial(jax.jit, static_argnames=("H", "W", "sigma"))
def _chunk_image(ev, valid, *, H, W, sigma):
    img = tensorize.splat_gauss(ev[:, 1:3], valid, ev[:, 3], H, W, sigma=sigma)
    return tensorize.normalize_to_image(img)


# one jit builds ALL candidate MCIs + their scores from one padded window
def _make_candidates(
    ev: jnp.ndarray,        # (C,4) padded window events [t-t0, x, y, p]
    valid: jnp.ndarray,     # (C,)
    dt: jnp.ndarray,        # () window duration t1-t0 (seconds)
    T0: jnp.ndarray,        # (4,4) Tcw prior at window start (L2 DPose)
    T1: jnp.ndarray,        # (4,4) Tcw prior at window end
    med_depth: jnp.ndarray, # () scalar median scene depth from L2
    have_dpose: jnp.ndarray,  # () bool — is the (T0,T1,depth) prior usable
    klt_prev: jnp.ndarray,  # (Npts,2) KLT reference corners (chunk i-1)
    klt_cur: jnp.ndarray,   # (Npts,2) tracked positions (chunk i)
    klt_ok: jnp.ndarray,    # (Npts,) bool
    klt_dt: jnp.ndarray,    # () seconds between the two chunk images
    have_klt: jnp.ndarray,  # () bool
    cam_params: jnp.ndarray,
    H: int,
    W: int,
    sigma: float,
    cm_iters: int,
    cm_stride: int = 1,
):
    # event times arrive REBASED to the window start (float64 ts - t0 done
    # host-side, see _pad_events) so float32 precision is ~ns here
    t_sec = ev[:, 0]                                            # seconds
    t_rel = t_sec / jnp.maximum(dt, 1e-9)                       # [0,1]
    xy = ev[:, 1:3]
    pol = ev[:, 3]

    # candidate 0: plain Gaussian histogram (getEvHist)
    img_h = tensorize.splat_gauss(xy, valid, pol, H, W, sigma=sigma)

    # candidate 1: SE2 contrast maximization (getAff2DMCI): jitted ascent.
    # The ascent runs on a temporally-strided subset (cm_stride > 1 on
    # dense streams): the contrast objective is a mean over events, so the
    # subset estimates its gradient; the final warp uses ALL events.
    params, c_after, c_before = contrast_max.maximize_rt2d(
        xy[::cm_stride], t_sec[::cm_stride], valid[::cm_stride],
        H, W, iters=cm_iters, sigma=sigma
    )
    center = jnp.asarray([W / 2.0, H / 2.0], xy.dtype)
    # align to the window END (t_rel' = t - dt is 0 there): the MCI is
    # stamped ts = window end, so its content must correspond to that
    # instant — same constant-flow params maximize contrast either way
    xy_se2 = tensorize.warp_se2(xy, t_sec - dt, params, center)
    img_se2 = tensorize.splat_gauss(xy_se2, valid, pol, H, W, sigma=sigma)

    # candidate 2: SE3 DPose warp with L2's median depth (getDPoseMCI)
    xy_dp, z_dp = tensorize.warp_se3_depth(
        xy, t_rel, T0, T1, cam_params, med_depth
    )
    v_dp = valid & (z_dp > 1e-3)
    img_dp = tensorize.splat_gauss(xy_dp, v_dp, pol, H, W, sigma=sigma)

    # candidate 3: SE2 flow fitted to the builder's own KLT correspondences
    # (the reference's measured-track candidate: optimize2D SE2 fit of
    # matched KPts feeding the MCI selection, src/Event/EvImBuilder.cpp:1124)
    params_fit, n_fit = contrast_max.fit_rt2d_points(
        klt_prev, klt_cur, klt_ok, klt_dt, center
    )
    xy_fit = tensorize.warp_se2(xy, t_sec - dt, params_fit, center)
    img_fit = tensorize.splat_gauss(xy_fit, valid, pol, H, W, sigma=sigma)

    # score the RAW accumulators: all candidates carry the same event mass,
    # so patch-STD is directly comparable — min-max normalizing first would
    # penalize exactly the sharpest candidate (its peak is tallest, so
    # normalization compresses the rest of its dynamic range)
    imgs_raw = jnp.stack([img_h, img_se2, img_dp, img_fit])
    scores = jax.vmap(tensorize.patch_std_mean)(imgs_raw)
    # conditional candidates only compete when their inputs exist
    scores = scores.at[2].set(jnp.where(have_dpose, scores[2], -jnp.inf))
    scores = scores.at[3].set(
        jnp.where(have_klt & (n_fit >= 6), scores[3], -jnp.inf)
    )
    best = jnp.argmax(scores)
    # select + normalize ON DEVICE: the host only ever needs the winner
    best_img = tensorize.normalize_to_image(imgs_raw[best])
    return best_img, best, scores, params


_make_candidates_jit = jax.jit(
    _make_candidates,
    static_argnames=("H", "W", "sigma", "cm_iters", "cm_stride"),
)


# ---------------------------------------------------------------------------
# Batched window step: the ENTIRE L1 window — per-chunk splats, the KLT
# continuity chain, FAST re-detection, and all four MCI candidates — in ONE
# dispatch instead of a host loop with one blocking device pull per chunk.
# The host gets back only DEVICE references plus one small metadata vector
# that is
# prefetched with copy_to_host_async and read one window later (lagged
# adaptive feedback, like the pipelined image tracker).
@functools.partial(
    jax.jit,
    static_argnames=("H", "W", "sigma", "cm_iters", "cm_stride"),
)
def _window_step(
    chunks: jnp.ndarray,      # (L,C,4) per-chunk padded events, t rebased
    #                           to the WINDOW start (float32 seconds)
    cvalid: jnp.ndarray,      # (L,C)
    dt_win: jnp.ndarray,      # () window duration (s)
    chunk_dts: jnp.ndarray,   # (L,) dt between consecutive chunk ends
    prev_img: jnp.ndarray,    # (H,W) last chunk image of the previous window
    prev_pts: jnp.ndarray,    # (Np,2) its FAST corners
    prev_ok: jnp.ndarray,     # (Np,)
    T_prev: jnp.ndarray,      # (4,4) L2 pose feedback (PoseDepthInfo)
    T_cur: jnp.ndarray,       # (4,4)
    med_depth: jnp.ndarray,   # ()
    have_dpose: jnp.ndarray,  # () bool
    cam_params: jnp.ndarray,
    H: int,
    W: int,
    sigma: float,
    cm_iters: int,
    cm_stride: int,
):
    L, C, _ = chunks.shape

    imgs = jax.vmap(
        lambda e, v: tensorize.normalize_to_image(
            tensorize.splat_gauss(e[:, 1:3], v, e[:, 3], H, W, sigma=sigma)
        )
    )(chunks, cvalid)

    n_klt = prev_pts.shape[0]

    def body(carry, img_c):
        img_p, pts_p, ok_p = carry
        res = klt.track(
            img_p, img_c, pts_p, ok_p, win=9, levels=2, iters=6, min_ncc=0.3
        )
        md = klt.median_displacement(res, pts_p)
        xy_new, _, vmask = fast.detect_grid(
            img_c, threshold=0.08, min_threshold=0.03, cell=24,
            per_cell=2, max_kp=n_klt, border=6,
        )
        return (img_c, xy_new, vmask), (md, pts_p, res.xy, ok_p & res.ok)

    (img_l, pts_l, ok_l), (mds, kp, kc, kok) = jax.lax.scan(
        body, (prev_img, prev_pts, prev_ok), imgs
    )

    # window-level MCI candidates over the flattened (time-ordered) events
    ev = chunks.reshape(L * C, 4)
    valid = cvalid.reshape(L * C)
    # DPose prior: constant-velocity extrapolation on DEVICE (the host
    # posts T_prev/T_cur as device arrays — no pull)
    rel = T_cur @ lie.se3_inv(T_prev)
    best_img, best, scores, se2 = _make_candidates(
        ev, valid, dt_win,
        T_cur, rel @ T_cur, med_depth, have_dpose,
        kp[-1], kc[-1], kok[-1], jnp.maximum(chunk_dts[-1], 1e-6),
        jnp.sum(kok[-1]) >= 6,
        cam_params, H=H, W=W, sigma=sigma, cm_iters=cm_iters,
        cm_stride=cm_stride,
    )
    meta = jnp.concatenate(
        [best[None].astype(jnp.float32), scores, mds, se2]
    )
    return best_img, meta, img_l, pts_l, ok_l


class EventWindowBuilder:
    """Host orchestrator for the L1 state machine (IDLE -> TRACKING).

    Feed raw event arrays with :meth:`feed`; poll :meth:`step` which returns
    a ``PoseImage`` whenever an L1 chunk (tiny frame) or a full L2 window
    (MCI) completes, else ``None``.
    """

    def __init__(self, cfg: BuilderConfig, cam_params=None):
        self.cfg = cfg
        self.cam = (
            cam_params
            if cam_params is not None
            else jnp.asarray([1.0, 1.0, cfg.img_w / 2.0, cfg.img_h / 2.0, 0, 0, 0, 0],
                             jnp.float32)
        )
        # host event buffer stays float64: raw timestamps must not be
        # quantized before window rebasing (see _pad_events). Backed by the
        # native C++ queue (io/native.NativeEventQueue — O(1) consume/
        # inject, background file streaming) when the library is available,
        # else a numpy array.
        from eorb_slam_tpu.io import native as _native

        self._q = _native.make_queue()
        self.buf = np.zeros((0, 4), np.float64)
        self.chunk_size = cfg.l1_chunk_size
        self.chunks_in_window: list[np.ndarray] = []
        self.prev_img: Optional[jnp.ndarray] = None
        self.prev_pts: Optional[jnp.ndarray] = None
        self.prev_pts_valid: Optional[jnp.ndarray] = None
        self.last_med_disp = float("nan")
        # PoseDepthInfo analog: L2 posts (T0, T1, med_depth) back here
        # (reference include/Utils/MyDataTypes.h:547-582)
        self.pose_prior: Optional[tuple[np.ndarray, np.ndarray, float]] = None
        # latest KLT correspondence set (prev_pts, cur_pts, ok, dt) for the
        # measured-flow MCI candidate
        self._klt_fit = None
        self._last_chunk_ts = 0.0
        # batched-window path state (step_window): device KLT carry +
        # prefetched metadata resolved one window later
        self._win_carry = None
        self._pending_meta = None
        self._last_kind = "hist"
        self._last_score = 0.0
        self.stats = {"chunks": 0, "windows": 0, "idle": 0, "ev_truncated": 0}

    # ------------------------------------------------------------- input

    def feed(self, events: np.ndarray) -> None:
        if len(events):
            if self._q is not None:
                self._q.feed(np.asarray(events, np.float64))
            else:
                self.buf = np.concatenate(
                    [self.buf, np.asarray(events, np.float64)]
                )

    def stream_file(self, path: str, max_rows=None) -> bool:
        """Start the native background streamer parsing ``path`` (ts x y p
        text) into the queue; returns False when unavailable."""
        return self._q is not None and self._q.stream_file(path, max_rows)

    def pending_events(self) -> int:
        return len(self._q) if self._q is not None else len(self.buf)

    def _consume(self, n: int) -> np.ndarray:
        if self._q is not None:
            return self._q.consume(n)
        chunk, self.buf = self.buf[:n], self.buf[n:]
        return chunk

    def _inject_front(self, events: np.ndarray) -> None:
        if self._q is not None:
            self._q.inject_front(events)
        else:
            self.buf = np.concatenate([events, self.buf])

    def set_pose_prior(self, T0, T1, med_depth):
        """L2 pose/depth feedback (PoseDepthInfo analog). Accepts DEVICE
        arrays — they are consumed on device by step_window, so posting
        them must not force a host pull."""
        self.pose_prior = (T0, T1, med_depth)

    # ------------------------------------------------------------- control

    def _adapt_chunk_size(self, med_disp: float) -> None:
        """calcNewL1ChunkSize (reference src/Event/EvImBuilder.cpp:197-230):
        scale the window so median optical flow hits maxPixelDisp."""
        if not np.isfinite(med_disp) or med_disp <= 1e-3:
            return
        ratio = self.cfg.max_pixel_disp / med_disp
        ratio = float(np.clip(ratio, 0.5, 2.0))  # damped feedback
        self.chunk_size = int(
            np.clip(self.chunk_size * ratio, self.cfg.min_chunk, self.cfg.max_chunk)
        )

    def step(self) -> Optional[PoseImage]:
        cfg = self.cfg
        if self.pending_events() < self.chunk_size:
            return None
        chunk = self._consume(self.chunk_size)
        self.stats["chunks"] += 1

        # gen-rate gate (reference src/Event/EvImBuilder.cpp:1327-1342)
        t_span = float(chunk[-1, 0] - chunk[0, 0])
        rate = len(chunk) / max(t_span, 1e-9) / (cfg.img_w * cfg.img_h)
        if rate < cfg.min_ev_gen_rate:
            self.stats["idle"] += 1
            self.chunks_in_window.clear()
            self.prev_img = None
            self._klt_fit = None   # stale correspondences must not seed the
            # measured-flow MCI after an idle gap (their dt no longer matches)
            return None

        ev_pad, v_pad, _ = _pad_events(chunk, cfg.max_chunk)
        img = _chunk_image(
            jnp.asarray(ev_pad), jnp.asarray(v_pad),
            H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma,
        )

        # KLT continuity between consecutive chunk images -> median pixel
        # displacement drives the adaptive window (step()/resolveEvWinSize)
        if self.prev_img is not None and self.prev_pts is not None:
            res = klt.track(
                self.prev_img, img, self.prev_pts, self.prev_pts_valid,
                win=9, levels=2, iters=6, min_ncc=0.3,
            )
            med = float(
                klt.median_displacement(res, self.prev_pts)
            )
            self.last_med_disp = med
            self._adapt_chunk_size(med)
            # keep the correspondences: they seed the measured-flow MCI
            # candidate (fit_rt2d_points) at window completion
            self._klt_fit = (
                self.prev_pts, res.xy, self.prev_pts_valid & res.ok,
                float(chunk[-1, 0]) - self._last_chunk_ts,
            )
        self._last_chunk_ts = float(chunk[-1, 0])

        # refresh reference corners on the new chunk image
        xy, resp, vmask = fast.detect_grid(
            img, threshold=0.08, min_threshold=0.03, cell=24,
            per_cell=2, max_kp=cfg.n_klt_pts, border=6,
        )
        self.prev_img = img
        self.prev_pts = xy
        self.prev_pts_valid = vmask

        self.chunks_in_window.append(chunk)
        if len(self.chunks_in_window) < cfg.l1_num_loop:
            # tiny frame: KLT continuity only, not full tracking (reference
            # PoseImage::mReconstStat == 0, src/Event/EvAsynchTracker.cpp:1438)
            return PoseImage(
                img=img, ts=float(chunk[-1, 0]),
                ts0=float(chunk[0, 0]), reconst_stat=0, best_kind="hist",
                se2_params=np.zeros(3, np.float32), score=0.0,
            )
        return self._finish_window()

    # --------------------------------------------- batched window pipeline

    def _resolve_window_meta(self, block: bool = False) -> None:
        """Opportunistically pull the most recent window metadata and run
        the adaptive-window feedback on it. NEVER blocks in the steady
        state: the prefetched transfer (copy_to_host_async) is consumed
        only once ``is_ready()``, so the host never waits on the device
        between windows. Feedback lag of a few windows is harmless: the
        reference's controller is a damped ratio clamp."""
        if self._pending_meta is None:
            return
        if not block and not self._pending_meta.is_ready():
            return
        meta = np.asarray(self._pending_meta)
        self._pending_meta = None
        L = self.cfg.l1_num_loop
        best_i = int(meta[0])
        self._last_kind = ["hist", "se2", "dpose", "klt2d"][best_i]
        self._last_score = float(meta[1 + best_i])
        mds = meta[5:5 + L]
        mds = mds[np.isfinite(mds) & (mds > 1e-3)]
        if len(mds):
            med = float(np.median(mds))
            self.last_med_disp = med
            self._adapt_chunk_size(med)

    def step_window(self) -> Optional[PoseImage]:
        """Process one FULL L1 window (l1_num_loop chunks) in a single
        dispatch — splats, KLT continuity chain, FAST re-detection, and the
        four MCI candidates (see _window_step). Returns a PoseImage per
        completed window; tiny frames never surface (their only purpose —
        KLT continuity + window adaptation — happens inside the jit).

        ``best_kind``/``score`` lag one window (telemetry-only fields; the
        exact values ride the prefetched metadata)."""
        cfg = self.cfg
        L = cfg.l1_num_loop
        cs = self.chunk_size
        if self.pending_events() < cs * L:
            return None
        self._resolve_window_meta()
        cs = self.chunk_size        # feedback may have changed it
        if self.pending_events() < cs * L:
            return None
        win = self._consume(cs * L)
        self.stats["chunks"] += L

        t0, t1 = float(win[0, 0]), float(win[-1, 0])
        rate = len(win) / max(t1 - t0, 1e-9) / (cfg.img_w * cfg.img_h)
        if rate < cfg.min_ev_gen_rate:
            self.stats["idle"] += 1
            self._win_carry = None
            self._klt_fit = None
            return None

        # per-chunk padded tensor, power-of-two bucket (bounded recompiles)
        C = max(1024, 1 << (cs - 1).bit_length())
        chunks = np.zeros((L, C, 4), np.float32)
        cvalid = np.zeros((L, C), bool)
        tr = (win[:, 0] - t0).astype(np.float32)
        for i in range(L):
            seg = slice(i * cs, (i + 1) * cs)
            chunks[i, :cs, 0] = tr[seg]
            chunks[i, :cs, 1:] = win[seg, 1:].astype(np.float32)
            cvalid[i, :cs] = True
        chunk_t1 = win[(np.arange(L) + 1) * cs - 1, 0]
        prev_t1 = self._last_chunk_ts or (t0 - 1e-3)
        dts = np.diff(np.concatenate([[prev_t1], chunk_t1])).astype(np.float32)
        self._last_chunk_ts = float(chunk_t1[-1])

        carry = self._win_carry
        if carry is None:
            n = cfg.n_klt_pts
            carry = (
                jnp.zeros((cfg.img_h, cfg.img_w), jnp.float32),
                jnp.zeros((n, 2), jnp.float32),
                jnp.zeros(n, bool),
            )
        if self.pose_prior is not None:
            T_prev, T_cur, depth = self.pose_prior
            have_dpose = True
        else:
            T_prev = T_cur = np.eye(4, dtype=np.float32)
            depth, have_dpose = 1.0, False
        cm_stride = max(1, int(np.ceil(L * C / max(cfg.cm_sample, 1))))

        best_img, meta, img_l, pts_l, ok_l = _window_step(
            jnp.asarray(chunks), jnp.asarray(cvalid),
            jnp.asarray(t1 - t0, jnp.float32), jnp.asarray(dts),
            carry[0], carry[1], carry[2],
            jnp.asarray(T_prev, jnp.float32), jnp.asarray(T_cur, jnp.float32),
            jnp.asarray(depth, jnp.float32), jnp.asarray(bool(have_dpose)),
            self.cam, H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma,
            cm_iters=cfg.cm_iters, cm_stride=cm_stride,
        )
        self._win_carry = (img_l, pts_l, ok_l)
        meta.copy_to_host_async()
        self._pending_meta = meta
        self.stats["windows"] += 1

        n_keep = int(len(win) * cfg.overlap)
        if n_keep > 0:
            self._inject_front(win[-n_keep:])
        return PoseImage(
            img=best_img, ts=t1, ts0=t0, reconst_stat=1,
            best_kind=self._last_kind, se2_params=meta,
            score=self._last_score,
        )

    def build_mci(self, window: np.ndarray) -> PoseImage:
        """Candidate synthesis + selection over one event window. Pure w.r.t.
        builder buffers — usable both by the window state machine and by the
        synch mode (reference getSynchMCI, src/Event/EvImBuilder.cpp:1249,
        which builds the MCI from the passed events without re-injection)."""
        cfg = self.cfg
        t0, t1 = float(window[0, 0]), float(window[-1, 0])
        ev_pad, v_pad, n_drop = _pad_events(window, cfg.max_window_events)
        if n_drop:
            # padded window rebases to the first KEPT event; keep ts0 honest
            t0 = float(window[n_drop, 0])
            self.stats["ev_truncated"] += n_drop

        if self.pose_prior is not None:
            # L2 posts the poses of the LAST TWO tracked frames (PoseDepthInfo
            # analog); this window starts where the last one ended, so warp
            # with the constant-velocity extrapolation (T_cur, rel @ T_cur)
            # — matching the reference's DPose usage, which applies the last
            # relative pose forward (src/Event/EvImBuilder.cpp:958-1032)
            T_prev, T_cur, depth = (np.asarray(x) for x in self.pose_prior)
            rel = T_cur @ np.linalg.inv(T_prev)
            T0 = T_cur.astype(np.float32)
            T1 = (rel @ T_cur).astype(np.float32)
            depth = float(depth)
            have_dpose = True
        else:
            T0 = T1 = np.eye(4, dtype=np.float32)
            depth, have_dpose = 1.0, False

        if self._klt_fit is not None and self._klt_fit[3] > 0:
            # kdt <= 0 happens for the chunk pair straddling overlap
            # re-injection (timestamps step backward); fit_rt2d_points would
            # clamp it to 1e-9 and produce ~1e9 px/s garbage params
            kp, kc, kok, kdt = self._klt_fit
            have_klt = True
        else:
            n = cfg.n_klt_pts
            kp = kc = jnp.zeros((n, 2), jnp.float32)
            kok = jnp.zeros(n, bool)
            kdt, have_klt = 1e-3, False

        best_img, best, scores, se2 = _make_candidates_jit(
            jnp.asarray(ev_pad), jnp.asarray(v_pad),
            jnp.asarray(t1 - t0, jnp.float32),
            jnp.asarray(T0, jnp.float32), jnp.asarray(T1, jnp.float32),
            jnp.asarray(depth, jnp.float32), jnp.asarray(have_dpose),
            kp, kc, kok, jnp.asarray(kdt, jnp.float32),
            jnp.asarray(have_klt),
            self.cam, H=cfg.img_h, W=cfg.img_w, sigma=cfg.sigma,
            cm_iters=cfg.cm_iters,
        )
        # ONE packed host pull for the tiny metadata; the MCI itself stays
        # on device (the L2 tracker consumes it there, so no D2H +
        # re-upload per window)
        meta = np.asarray(
            jnp.concatenate([best[None].astype(jnp.float32), scores])
        )
        best_i = int(meta[0])
        kind = ["hist", "se2", "dpose", "klt2d"][best_i]
        self.stats["windows"] += 1
        return PoseImage(
            img=best_img, ts=t1, ts0=t0, reconst_stat=1,
            best_kind=kind, se2_params=se2, score=float(meta[1 + best_i]),
        )

    def _finish_window(self) -> PoseImage:
        window = np.concatenate(self.chunks_in_window)
        pi = self.build_mci(window)

        # continuous mode: re-inject the overlap tail (reference
        # injectEventsBegin, src/Event/EvImBuilder.cpp:1473-1477)
        n_keep = int(len(window) * self.cfg.overlap)
        if n_keep > 0:
            self._inject_front(window[-n_keep:])
        self.chunks_in_window.clear()
        return pi
