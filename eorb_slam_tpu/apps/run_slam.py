"""Unified dataset-driven SLAM runner — the reference's app layer.

One YAML settings file drives everything, exactly like the reference's
``fmt_ev_ethz`` / ``fmt_euroc`` mains (Examples/Event/fmt_ev_ethz.cpp:43-270):
per image timestamp, pull the events in ``(last, t]`` and the IMU chunk,
dispatch on the sensor config to the right pipeline, time every iteration,
and save TUM trajectories with the timing-stats header
(:221-242 of the reference main). Event-only modes stream fixed-size event
chunks instead of frames (System::TrackEvent, src/System.cc:800-866).

Usage:
    python -m eorb_slam_tpu.apps.run_slam <settings.yaml> [--out DIR]
        [--max-frames N] [--eval] [--sequence NAME]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import jax.numpy as jnp

from eorb_slam_tpu.io import config as cfg_mod
from eorb_slam_tpu.io import datasets, trajectory
from eorb_slam_tpu.io.config import SensorConfig


def make_vocab(st: cfg_mod.Settings, seq=None):
    """Load or train the place-recognition vocabulary (reference loads
    ORBvoc.txt in System::System, src/System.cc:82-93). Returns a
    bow.HierVocab or None."""
    from eorb_slam_tpu.retrieval import bow

    if st.vocab.path:
        return bow.load_vocab_text_hier(st.vocab.path)
    if st.vocab.train_words > 0 and seq is not None and seq.n_frames > 0:
        from eorb_slam_tpu.ops import frontend

        descs = []
        idxs = np.linspace(0, seq.n_frames - 1,
                           min(st.vocab.train_frames, seq.n_frames),
                           dtype=int)
        for i in idxs:
            img = (seq.image(int(i)) * 255.0).astype(np.uint8)
            f = frontend.extract(jnp.asarray(img), max_kp=512)
            descs.append(np.asarray(f.desc_pm1)[np.asarray(f.valid)])
        d = jnp.asarray(np.concatenate(descs))
        k1 = max(8, int(np.sqrt(st.vocab.train_words)))
        k2 = max(8, st.vocab.train_words // k1)
        return bow.train_hier_vocab(d, K1=k1, K2=k2, iters=4)
    return None


def build_system(st: cfg_mod.Settings, loop_words=None, pipelined=True):
    """System::System equivalent: construct the pipeline for the sensor
    config (reference src/System.cc:61-274 + EvTrackManager tracker
    selection, src/Event/EvTrackManager.cpp:41-66). ``pipelined`` picks
    MONOCULAR's pipelined tracking (see ``MonoSlam``)."""
    from eorb_slam_tpu.event import builder as ev_builder
    from eorb_slam_tpu.imu import preintegration as pre_mod

    cam = jnp.asarray(st.cam.params_array())
    n_kp = min(max(st.features.n_features, 128), 1024)
    kw = dict(
        img_w=st.cam.width or 240, img_h=st.cam.height or 180, N=n_kp,
        K=st.slam.max_keyframes, M=st.slam.max_landmarks,
        local_window=st.slam.local_window,
        max_frames_between_kf=st.slam.max_frames_between_kf,
    )
    if loop_words is not None:
        kw["loop_words"] = loop_words
    calib = pre_mod.make_calib(
        Tbc=jnp.asarray(st.imu.Tbc), gyro_noise=st.imu.noise_gyro,
        acc_noise=st.imu.noise_acc, gyro_walk=st.imu.walk_gyro,
        acc_walk=st.imu.walk_acc, freq=st.imu.freq,
    )
    ev_cfg = ev_builder.BuilderConfig(
        img_w=st.cam.width or 240, img_h=st.cam.height or 180,
        l1_chunk_size=st.event.l1_chunk_size,
        l1_num_loop=st.event.l1_num_loop,
        min_ev_gen_rate=st.event.min_ev_gen_rate,
        max_pixel_disp=st.event.max_pixel_disp,
        sigma=st.event.sigma,
    )
    s = st.sensor
    if s is SensorConfig.MONOCULAR:
        if st.features.mode == 2:  # mixed ORB+AKAZE (Features.mode: 2)
            from eorb_slam_tpu.slam.system import MixedMonoSlam

            return MixedMonoSlam(cam, **kw)
        from eorb_slam_tpu.slam.system import MonoSlam

        # pipelined: the per-frame decision pull overlaps the next frame's
        # dispatch (host decisions trail one frame)
        return MonoSlam(cam, pipelined=pipelined, **kw)
    if s is SensorConfig.STEREO:
        from eorb_slam_tpu.slam.rgbd_stereo import StereoSlam

        return StereoSlam(cam, baseline=st.cam.bf / max(st.cam.fx, 1e-9), **kw)
    if s is SensorConfig.RGBD:
        from eorb_slam_tpu.slam.rgbd_stereo import RgbdSlam

        return RgbdSlam(cam, **kw)
    if s is SensorConfig.IMU_MONOCULAR:
        from eorb_slam_tpu.slam.vi_system import MonoInertialSlam

        return MonoInertialSlam(cam, calib, **kw)
    if s is SensorConfig.IMU_STEREO:
        from eorb_slam_tpu.slam.rgbd_stereo import StereoInertialSlam

        return StereoInertialSlam(
            cam, calib, baseline=st.cam.bf / max(st.cam.fx, 1e-9), **kw
        )
    if s is SensorConfig.EVENT_ONLY:
        if st.event.continuous:
            from eorb_slam_tpu.slam.event_continuous import EventSlamContinuous

            return EventSlamContinuous(cam, ev_cfg)
        from eorb_slam_tpu.slam.event_system import EventSlam

        return EventSlam(cam, ev_cfg)
    if s is SensorConfig.EVENT_IMU:
        from eorb_slam_tpu.slam.event_inertial import EventInertialSlam

        return EventInertialSlam(cam, calib, ev_cfg)
    # image tracker of the synch modes carries the loop closer; a loop
    # correction is propagated into the event map + a joint GBA runs over
    # both observation sets (reference event-aware LoopClosing dispatch,
    # src/LoopClosing.cc:2535-2549)
    ev_im_kw = {}
    if loop_words is not None:
        ev_im_kw["loop_words"] = loop_words
    if s is SensorConfig.EVENT_MONO:
        from eorb_slam_tpu.slam.ev_image_system import EvImageSlam

        return EvImageSlam(
            cam, ev_cfg, img_w=st.cam.width, img_h=st.cam.height,
            max_kp=n_kp, **ev_im_kw,
        )
    if s is SensorConfig.EVENT_IMU_MONO:
        from eorb_slam_tpu.slam.event_inertial import EvImageInertialSlam

        return EvImageInertialSlam(
            cam, calib, cfg=ev_cfg, img_w=st.cam.width, img_h=st.cam.height,
            max_kp=n_kp, **ev_im_kw,
        )
    raise ValueError(f"unsupported sensor config: {s}")


def _imu_chunk(seq: datasets.Sequence, t0: float, t1: float):
    from eorb_slam_tpu.slam.vi_system import ImuChunk

    if seq.imu is None:
        return ImuChunk(
            gyro=np.zeros((0, 3), np.float32),
            acc=np.zeros((0, 3), np.float32),
            dts=np.zeros(0, np.float32),
        )
    i0 = int(np.searchsorted(seq.imu.ts, t0, side="right"))
    i1 = int(np.searchsorted(seq.imu.ts, t1, side="right"))
    ts = seq.imu.ts[i0:i1]
    dts = np.diff(ts, prepend=t0).astype(np.float32)
    return ImuChunk(
        gyro=seq.imu.gyro[i0:i1].astype(np.float32),
        acc=seq.imu.acc[i0:i1].astype(np.float32),
        dts=np.clip(dts, 1e-5, 0.1),
    )


def run_sequence(
    st: cfg_mod.Settings,
    seq: datasets.Sequence,
    out_dir: str = "results",
    max_frames: Optional[int] = None,
    pace: bool = False,
    verbose: bool = True,
    pipelined: bool = True,
):
    """One sequence through the pipeline; returns (slam, result dict).
    The dict's ``iter_ms`` holds the time of every frame (or event chunk);
    in event-clock modes ``window_ts`` holds the timestamp of every event
    window tracked."""
    loop_words = make_vocab(st, seq) if st.sensor.is_image() else None
    slam = build_system(st, loop_words=loop_words, pipelined=pipelined)
    s = st.sensor
    main_timer = trajectory.SmartTimer("tracking")
    t_wall0 = time.perf_counter()

    if s in (SensorConfig.EVENT_ONLY, SensorConfig.EVENT_IMU):
        # event-clock loop: fixed-size chunks (System::TrackEvent)
        assert seq.events is not None, "event mode needs an event stream"
        chunk_n = st.event.l1_chunk_size * st.event.l1_num_loop
        n_chunks = 0
        window_ts = []
        last_t = float(seq.events.events[0, 0]) if len(seq.events) else 0.0
        while not seq.events.exhausted:
            chunk = seq.events.next_chunk_count(chunk_n)
            if len(chunk) == 0:
                break
            t_hi = float(chunk[-1, 0])
            if s is SensorConfig.EVENT_IMU and seq.imu is not None:
                sel = (seq.imu.ts > last_t) & (seq.imu.ts <= t_hi)
                slam.grab_imu(
                    seq.imu.ts[sel], seq.imu.gyro[sel], seq.imu.acc[sel]
                )
            main_timer.tic()
            res = slam.track_events(chunk)
            main_timer.toc()
            window_ts += [r["ts"] for r in res]
            last_t = t_hi
            n_chunks += 1
            if max_frames is not None and n_chunks >= max_frames:
                break
        n_iter = n_chunks
    else:
        # image-clock loop (fmt_ev_ethz main loop :161-201)
        n = seq.n_frames if max_frames is None else min(seq.n_frames, max_frames)
        last_t = None
        for i in range(n):
            t = float(seq.image_ts[i])
            t_prev = last_t if last_t is not None else t - 1.0 / max(
                st.cam.fps, 1.0
            )
            # loader serves [0,1]; FAST thresholds (and the reference
            # pipeline) are 8-bit units. uint8 keeps H2D transfers small.
            img = (seq.image(i) * 255.0).astype(np.uint8)
            main_timer.tic()
            if s is SensorConfig.MONOCULAR:
                slam.process_image(jnp.asarray(img), t)  # uint8; extract
                # casts on device
            elif s is SensorConfig.IMU_MONOCULAR:
                # fused per-frame path: extraction + predict + track + VI
                # pose opt in ONE dispatch (vi_system._vi_frame_step)
                slam.process_image_imu(
                    jnp.asarray(img), t, _imu_chunk(seq, t_prev, t)
                )
            elif s is SensorConfig.STEREO:
                img_r = seq.image_right(i) * 255.0
                slam.process_stereo(jnp.asarray(img, jnp.float32),
                                    jnp.asarray(img_r, jnp.float32), t)
            elif s is SensorConfig.IMU_STEREO:
                img_r = seq.image_right(i) * 255.0
                slam.process_stereo_imu(
                    jnp.asarray(img, jnp.float32),
                    jnp.asarray(img_r, jnp.float32), t,
                    _imu_chunk(seq, t_prev, t),
                )
            elif s is SensorConfig.RGBD:
                slam.process_rgbd(jnp.asarray(img, jnp.float32),
                                  jnp.asarray(seq.depth(i), jnp.float32), t)
            elif s in (SensorConfig.EVENT_MONO, SensorConfig.EVENT_IMU_MONO):
                ev = (
                    seq.events.next_chunk_until(t)
                    if seq.events is not None
                    else np.zeros((0, 4))
                )
                if s is SensorConfig.EVENT_IMU_MONO:
                    slam.track_ev_mono(ev, img, t,
                                       imu=_imu_chunk(seq, t_prev, t))
                else:
                    slam.track_ev_mono(ev, img, t)
            else:
                raise ValueError(f"unsupported sensor config: {s}")
            main_timer.toc()
            last_t = t
            if pace:
                dt_target = 1.0 / max(st.cam.fps, 1.0)
                sleep = dt_target - main_timer.deltas[-1]
                if sleep > 0:
                    time.sleep(sleep)
            if verbose and i % 50 == 0:
                print(f"[{seq.name}] frame {i}/{n}", file=sys.stderr)
        n_iter = n

    wall = time.perf_counter() - t_wall0
    os.makedirs(out_dir, exist_ok=True)
    traj = slam.trajectory_twc()
    out = {
        "sequence": seq.name,
        "iterations": n_iter,
        "wall_s": wall,
        "tracked_poses": len(traj),
        "avg_track_ms": main_timer.average * 1e3,
        "iter_ms": [d * 1e3 for d in main_timer.deltas],
        "stats": dict(slam.stats),
    }
    if s in (SensorConfig.EVENT_ONLY, SensorConfig.EVENT_IMU):
        out["window_ts"] = [float(t) for t in window_ts]
    if traj:
        ts = np.asarray([x for x, _ in traj])
        Twc = np.stack([T for _, T in traj])
        path = os.path.join(out_dir, f"{seq.name}_{s.name.lower()}.txt")
        trajectory.save_tum(path, ts, Twc, timers=(main_timer,))
        out["trajectory_file"] = path
    # FuseEventORB on the way out (reference System::Shutdown path)
    if hasattr(slam, "fused_trajectory"):
        try:
            fused = slam.fused_trajectory()
            if fused.get("chains", 0) > 0:
                ts = np.asarray([x for x, _ in fused["fused"]])
                Twc = np.stack([T for _, T in fused["fused"]])
                path = os.path.join(out_dir, f"{seq.name}_fused.txt")
                trajectory.save_tum(path, ts, Twc, timers=(main_timer,))
                out["fused_trajectory_file"] = path
        except Exception as e:  # fusion is best-effort post-processing
            out["fusion_error"] = str(e)
    return slam, out


def evaluate(seq: datasets.Sequence, traj_file: str, monocular: bool = True):
    """Score a saved trajectory against the sequence GT (the reference's
    evaluate_ate_scale.py / my_eval_ape.py protocol)."""
    from eorb_slam_tpu.evals import ate, rpe
    from eorb_slam_tpu.io.trajectory import load_tum, tum_to_mats

    if seq.gt_ts is None:
        return {"error": "no ground truth in sequence"}
    rows = load_tum(traj_file)
    ts_e, Twc_e = tum_to_mats(rows)
    est = list(zip(ts_e.tolist(), Twc_e))
    gt_rows = np.concatenate([seq.gt_ts[:, None], seq.gt_pose], axis=1)
    ts_g, Twc_g = tum_to_mats(gt_rows)
    gt = list(zip(ts_g.tolist(), Twc_g))
    out = {}
    r, n, scale, _, _ = ate.ate_rmse(est, gt, with_scale=monocular)
    out["ate_rmse"] = r
    out["ate_n"] = n
    out["ate_scale"] = scale
    out["ape_piecewise"] = {
        k: v for k, v in rpe.ate_piecewise(est, gt, with_scale=monocular).items()
        if k != "pieces"
    }
    rp = rpe.rpe(est, gt, delta=1, scale_norm=monocular)
    out["rpe_trans_rmse"] = rp["trans_rmse"]
    out["rpe_rot_rmse"] = rp["rot_rmse"]
    # KITTI-devkit sub-sequence odometry metrics (reference
    # evaluation/kitti-odom-eval/eval_odom.py) when enough overlap exists
    ia, ib = ate.associate(ts_e, ts_g, 0.02)
    if len(ia) >= 50:
        from eorb_slam_tpu.evals import kitti_odom

        ko = kitti_odom.kitti_odom_eval(Twc_g[ib], Twc_e[ia])
        if ko["n_subseq"]:
            out["kitti_t_err_pct"] = ko["t_err_pct"]
            out["kitti_r_err_deg_per_100m"] = ko["r_err_deg_per_100m"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("settings", help="YAML settings file (reference format)")
    p.add_argument("--out", default="results")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--sequence", default=None,
                   help="override DS target sequence name")
    p.add_argument("--eval", action="store_true", dest="do_eval")
    p.add_argument("--pace", action="store_true",
                   help="sleep to dataset frame rate (real-time pacing)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a JAX profiler trace of the run into DIR "
                        "(the reference's SAVE_TIMES/MySmartTimer analog, "
                        "SURVEY.md 5.1 — view with TensorBoard)")
    args = p.parse_args(argv)

    from eorb_slam_tpu.utils import compile_cache

    compile_cache.enable()
    st = cfg_mod.load_settings(args.settings)
    seqs = list(st.dataset.sequences) or [""]
    if args.sequence is not None:
        seqs = [args.sequence]
    elif st.dataset.seq_target >= 0:
        seqs = [seqs[st.dataset.seq_target]]

    import contextlib

    prof = contextlib.nullcontext()
    if args.profile:
        import jax

        prof = jax.profiler.trace(args.profile)

    results = []
    for name in seqs:
        seq = datasets.load_sequence(
            st.dataset.format, st.dataset.root, name,
            ts_factor=st.dataset.ts_factor,
        )
        with prof:
            slam, out = run_sequence(
                st, seq, out_dir=args.out, max_frames=args.max_frames,
                pace=args.pace,
            )
        prof = contextlib.nullcontext()  # only trace the first sequence
        if args.do_eval and "trajectory_file" in out:
            out["eval"] = evaluate(
                seq, out["trajectory_file"],
                monocular=st.sensor.is_monocular() and not st.sensor.is_inertial(),
            )
        print({k: v for k, v in out.items()
               if k not in ("iter_ms", "window_ts")})
        results.append(out)
    return results


if __name__ == "__main__":
    main()
