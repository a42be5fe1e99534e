"""Headline benchmark on one GPU. Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "device": {...}, "extra": {...}}

Current headline: bundle-adjustment ms per LM iteration on a local-BA-sized
window (K=16 keyframes, M=2048 landmarks, P=8 obs/landmark ≈ 16k residuals).
Exits non-zero unless JAX's first device is a GPU; everything runs in this
one process.

Usage: python bench.py
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np


def make_problem(K=16, M=2048, P=8, seed=0):
    import jax
    import jax.numpy as jnp

    from eorb_slam_tpu.geometry import camera, lie
    from eorb_slam_tpu.optim import schur_ba

    rng = np.random.default_rng(seed)
    cam = camera.make_pinhole(458.0, 457.0, 376.0, 240.0)
    lm = np.concatenate(
        [rng.uniform(-3, 3, (M, 2)), rng.uniform(4, 10, (M, 1))], axis=1
    ).astype(np.float32)
    Ts = []
    for k in range(K):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(
            lie.so3_exp(jnp.asarray([0.0, 0.01 * k, 0.0], jnp.float32))
        )
        T[:3, 3] = [-0.2 * k, 0.0, 0.0]
        Ts.append(T)
    Ts = np.stack(Ts)
    obs_kf = rng.integers(0, K, (M, P)).astype(np.int32)
    T_obs = Ts[obs_kf]  # (M,P,4,4)
    pc = np.einsum("mpij,mj->mpi", T_obs[..., :3, :3], lm) + T_obs[..., :3, 3]
    uv = np.stack(
        [
            458.0 * pc[..., 0] / pc[..., 2] + 376.0,
            457.0 * pc[..., 1] / pc[..., 2] + 240.0,
        ],
        axis=-1,
    ).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)

    return schur_ba.BAProblem(
        cam_params=cam,
        kf_T=jnp.asarray(Ts + 0),
        kf_fixed=jnp.asarray([True, True] + [False] * (K - 2)),
        kf_valid=jnp.ones(K, bool),
        lm_pos=jnp.asarray(lm + rng.normal(0, 0.03, lm.shape).astype(np.float32)),
        lm_valid=jnp.ones(M, bool),
        obs_kf=jnp.asarray(obs_kf),
        obs_uv=jnp.asarray(uv),
        obs_inv_sigma=jnp.ones((M, P), jnp.float32),
        obs_valid=jnp.asarray(pc[..., 2] > 0.1),
    )


def _time_call(fn, arg, reps):
    import jax

    res = fn(arg)
    jax.block_until_ready(res.kf_T)  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn(arg)
        jax.block_until_ready(res.kf_T)
    return (time.perf_counter() - t0) / reps, res


def time_ba(device, prob, iters_lo=10, iters_hi=40, reps=5, trials=3):
    """Marginal ms per LM iteration: (t(iters_hi) - t(iters_lo)) / diff.

    Differential timing removes the fixed per-call cost (dispatch and the
    blocking result pull) that would otherwise be misattributed to the
    solver. MIN over `trials` independent differentials."""
    import jax

    from eorb_slam_tpu.optim import schur_ba

    prob_d = jax.device_put(prob, device)
    fn_lo = jax.jit(
        lambda p: schur_ba.bundle_adjust(p, iters=iters_lo), device=device
    )
    fn_hi = jax.jit(
        lambda p: schur_ba.bundle_adjust(p, iters=iters_hi), device=device
    )
    best = float("inf")
    res = None
    for _ in range(trials):
        t_lo, res = _time_call(fn_lo, prob_d, reps)
        t_hi, _ = _time_call(fn_hi, prob_d, reps)
        best = min(
            best, max(t_hi - t_lo, 1e-9) / (iters_hi - iters_lo) * 1000.0
        )
    return best, res


def make_tracking_inputs(W=752, H=480, N=512, M=4096, seed=1):
    """A rendered frame + a populated tensor map for the per-frame chain.

    Throughput of the jitted chain is shape-bound, not content-bound (every
    stage is a fixed-shape masked computation), but the scene is still a
    real splat render with a consistent landmark table."""
    import jax.numpy as jnp

    from eorb_slam_tpu.event import tensorize
    from eorb_slam_tpu.geometry import camera
    from eorb_slam_tpu.slam import map_state

    rng = np.random.default_rng(seed)
    cam = camera.make_pinhole(458.0, 457.0, W / 2.0, H / 2.0)
    pts = np.concatenate(
        [rng.uniform(-4, 4, (M, 2)), rng.uniform(4, 12, (M, 1))], axis=1
    ).astype(np.float32)
    uv = np.stack(
        [458.0 * pts[:, 0] / pts[:, 2] + W / 2.0,
         457.0 * pts[:, 1] / pts[:, 2] + H / 2.0], axis=1
    ).astype(np.float32)
    ok = (uv[:, 0] > 0) & (uv[:, 0] < W) & (uv[:, 1] > 0) & (uv[:, 1] < H)
    amp = rng.uniform(0.4, 1.0, M).astype(np.float32)
    img = tensorize.splat_gauss(
        jnp.asarray(uv), jnp.asarray(ok), jnp.asarray(amp), H, W, sigma=1.2
    )
    img8 = np.asarray(tensorize.normalize_to_image(img) * 255.0).astype(np.uint8)

    m = map_state.empty_map(K=32, M=M, N=N, P=8)
    desc = (rng.integers(0, 2, (M, 256)).astype(np.int8) * 2 - 1)
    m = m._replace(
        lm_pos=jnp.asarray(pts),
        lm_valid=jnp.asarray(ok),
        lm_desc_pm1=jnp.asarray(desc),
        kf_valid=m.kf_valid.at[0].set(True),
    )
    return cam, jnp.asarray(img8), m


def time_tracking(device, reps=20):
    """Steady-state latency of the FULL per-frame jit chain
    (extract -> undistort -> project/match/pose-opt) in frames/s.

    One fused jit per frame, as the live pipeline runs it; the blocking
    flags pull is charged to the number (that IS the deployed per-frame
    cost)."""
    import jax
    import jax.numpy as jnp

    from eorb_slam_tpu.geometry import camera as cam_mod
    from eorb_slam_tpu.ops import frontend
    from eorb_slam_tpu.slam import tracking

    cam, img8, m = make_tracking_inputs()
    cam_d = jax.device_put(cam, device)
    img_d = jax.device_put(img8, device)
    m_d = jax.device_put(m, device)

    @functools.partial(jax.jit, device=device)
    def frame_chain(img, m, T_pred):
        feats = frontend.extract(img, max_kp=512)
        xy_ud = cam_mod.undistort_points(cam_d, feats.xy)
        res = tracking.track_frame(
            m, cam_d, xy_ud, feats.octave, feats.desc_pm1, feats.valid,
            T_pred, img_w=752, img_h=480,
        )
        return res.Tcw, res.n_inliers

    T0 = jax.device_put(jnp.eye(4), device)
    Tcw, n = frame_chain(img_d, m_d, T0)
    jax.block_until_ready(Tcw)
    t0 = time.perf_counter()
    for _ in range(reps):
        Tcw, n = frame_chain(img_d, m_d, T0)
        int(n)  # the per-frame host decision pull (state machine)
    dt = (time.perf_counter() - t0) / reps

    # pipelined variant (MonoSlam(pipelined=True), the run_slam default):
    # the decision pull for frame i overlaps frame i+1's dispatch
    n_prev = None
    t0 = time.perf_counter()
    for _ in range(reps):
        Tcw, n = frame_chain(img_d, m_d, T0)
        if n_prev is not None:
            int(n_prev)   # lagged pull — overlaps the in-flight dispatch
        n_prev = n
    int(n_prev)
    dt_pipe = (time.perf_counter() - t0) / reps
    return 1.0 / dt, 1.0 / dt_pipe


def time_event_engine(device, n_events=65536, reps=10):
    """MCI candidate synthesis + selection throughput: windows/s for the
    full 4-candidate build at the static 65k-event window capacity."""
    import jax
    import jax.numpy as jnp

    from eorb_slam_tpu.event import builder as ev_builder
    from eorb_slam_tpu.geometry import camera

    rng = np.random.default_rng(3)
    W, H = 240, 180
    cam = jax.device_put(camera.make_pinhole(199.0, 199.0, W / 2, H / 2),
                         device)
    ev = np.zeros((n_events, 4), np.float32)
    ev[:, 0] = np.sort(rng.uniform(0, 0.03, n_events))
    ev[:, 1] = rng.uniform(0, W, n_events)
    ev[:, 2] = rng.uniform(0, H, n_events)
    ev[:, 3] = rng.choice([-1.0, 1.0], n_events)
    ev_d = jax.device_put(jnp.asarray(ev), device)
    v_d = jax.device_put(jnp.ones(n_events, bool), device)
    kp = jax.device_put(jnp.zeros((128, 2), jnp.float32), device)
    kok = jax.device_put(jnp.zeros(128, bool), device)
    eye = jax.device_put(jnp.eye(4, dtype=jnp.float32), device)

    fn = jax.jit(ev_builder._make_candidates,
                 static_argnames=("H", "W", "sigma", "cm_iters"))

    def run():
        out = fn(
            ev_d, v_d, jnp.asarray(0.03, jnp.float32), eye, eye,
            jnp.asarray(1.0, jnp.float32), jnp.asarray(True),
            kp, kp, kok, jnp.asarray(0.01, jnp.float32), jnp.asarray(True),
            cam, H=H, W=W, sigma=1.0, cm_iters=30,
        )
        jax.block_until_ready(out[0])

    run()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    dt = (time.perf_counter() - t0) / reps
    return 1.0 / dt


def time_event_app(n_seconds=3.0, rate=400_000):
    """END-TO-END event-engine throughput: windows/s
    through EventSlam.track_events — the L1 batched-window builder, the L2
    tracker, keyframe mapping, and the pose/depth feedback — not the
    isolated candidate kernel."""
    from eorb_slam_tpu.event import builder as ev_builder
    from eorb_slam_tpu.geometry import camera, lie
    import jax.numpy as jnp

    W, H = 240, 180
    fx = fy = 150.0
    cam = camera.make_pinhole(fx, fy, W / 2.0, H / 2.0)
    rng = np.random.default_rng(5)
    pts = np.concatenate(
        [rng.uniform(-2.2, 2.2, (300, 1)), rng.uniform(-1.6, 1.6, (300, 1)),
         rng.uniform(2.5, 6.0, (300, 1))], axis=1).astype(np.float32)

    def pose(t):
        pos = np.asarray([0.4 * t, 0.1 * np.sin(1.5 * t), 0.08 * t])
        R = np.asarray(lie.so3_exp(jnp.asarray(
            [0.0, 0.06 * np.sin(0.8 * t), 0.0], jnp.float32)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ pos
        return T

    n = int(n_seconds * rate)
    ts = np.sort(rng.uniform(0, n_seconds, n))
    idx = rng.integers(0, len(pts), n)
    n_bins = int(n_seconds * 500)
    bins = np.clip((ts / n_seconds * n_bins).astype(int), 0, n_bins - 1)
    poses = np.stack([pose((b + 0.5) * n_seconds / n_bins)
                      for b in range(n_bins)])
    T = poses[bins]
    pc = np.einsum("nij,nj->ni", T[:, :3, :3], pts[idx]) + T[:, :3, 3]
    ev = np.zeros((n, 4), np.float32)
    ev[:, 0] = ts
    ev[:, 1] = fx * pc[:, 0] / pc[:, 2] + W / 2.0
    ev[:, 2] = fy * pc[:, 1] / pc[:, 2] + H / 2.0
    ev[:, 1:3] += rng.normal(0, 0.25, (n, 2))
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    inb = (ev[:, 1] >= 0) & (ev[:, 1] < W) & (ev[:, 2] >= 0) & (ev[:, 2] < H)
    ev = ev[inb]

    from eorb_slam_tpu.slam.event_system import EventSlam
    cfg = ev_builder.BuilderConfig(
        img_w=W, img_h=H, l1_chunk_size=4000, l1_num_loop=4,
        min_ev_gen_rate=0.01, max_window_events=32768)
    s = EventSlam(cam, cfg, max_kp=256, min_init_matches=30,
                  min_track_inliers=8)
    half = len(ev) // 2
    for k in range(0, half, 50_000):          # warmup: compiles + init
        s.track_events(ev[k:k + 50_000])
    w0 = s.stats["windows"]
    t0 = time.perf_counter()
    for k in range(half, len(ev), 50_000):
        s.track_events(ev[k:k + 50_000])
    s.l2.flush_pipeline()
    dt = time.perf_counter() - t0
    w1 = s.stats["windows"]
    data_s = float(ev[-1, 0] - ev[half, 0])
    return (w1 - w0) / max(dt, 1e-9), data_s / max(dt, 1e-9)


def main():
    import jax

    from eorb_slam_tpu.utils import compile_cache

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs}")
    compile_cache.enable()
    prob = make_problem()
    ba_ms, res = time_ba(dev, prob)
    track_fps, track_fps_pipe = time_tracking(dev)
    ev_wps = time_event_engine(dev)
    ev_app_wps, ev_app_rt = time_event_app()

    print(
        json.dumps(
            {
                "metric": "local_ba_ms_per_iter_K16_M2048_obs16k",
                "value": round(ba_ms, 3),
                "unit": "ms/iter",
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind, "count": len(devs)},
                "extra": {
                    "tracking_fps_752x480_512kp": round(track_fps, 1),
                    "tracking_fps_pipelined": round(track_fps_pipe, 1),
                    "event_mci_windows_per_s_65k": round(ev_wps, 1),
                    # end-to-end: EventSlam.track_events (L1+L2+mapping),
                    # 400k ev/s synthetic stream; _rt = data-seconds per
                    # wall-second at that density
                    "event_app_windows_per_s": round(ev_app_wps, 1),
                    "event_app_realtime_x": round(ev_app_rt, 3),
                    # deployed margin: run_slam's mono path IS pipelined
                    "realtime_margin_24fps": round(track_fps_pipe / 24.0, 2),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
