"""Long-run soak: thousands of frames on a closed loop with repeated
revisits (hardening the synthetic gates where real data can't reach).

A 5,000-frame orbit sequence revisits the same wall sections every lap, so
keyframe culling + duplicate-landmark fusion + the loop closer all run many
times at full K=32 capacity. Gates: the landmark table stays bounded (cull
and fuse actually reclaim slots), the keyframe count respects capacity,
tracking never degrades into a windowed ATE cliff, and a checkpoint taken
mid-sequence resumes bit-exact (io/checkpoint.py — a capability the
reference comments out, src/System.cc:104-168)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest

from eorb_slam_tpu.evals import ate
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.io import checkpoint
from eorb_slam_tpu.slam import system as slam_system
from tests.synth import SynthWorld, random_descriptors

pytestmark = pytest.mark.slow

ORBIT_R = 3.0        # camera orbit radius [m]
WALL_R = 10.0        # landmark cylinder radius [m]
PERIOD = 20.0        # seconds per lap


class OrbitWorld(SynthWorld):
    """Camera orbits inside a landmark cylinder, always looking outward:
    every lap re-observes the same wall — a revisit machine."""

    def __init__(self, n_landmarks=4000, seed=0, noise_px=0.4):
        super().__init__(n_landmarks=n_landmarks, seed=seed,
                         noise_px=noise_px)
        rng = np.random.default_rng(seed + 7)
        th = rng.uniform(0, 2 * np.pi, n_landmarks)
        z = rng.uniform(-3.0, 3.0, n_landmarks)
        r = WALL_R + rng.uniform(-0.5, 0.5, n_landmarks)
        self.lm = np.stack(
            [r * np.cos(th), r * np.sin(th), z], axis=1
        ).astype(np.float32)

    def pose(self, t: float) -> np.ndarray:
        th = 2 * np.pi * t / PERIOD
        C = np.asarray([
            ORBIT_R * np.cos(th),
            ORBIT_R * np.sin(th),
            0.3 * np.sin(2 * np.pi * t / 7.3),   # vertical bob
        ])
        out = np.asarray([np.cos(th), np.sin(th), 0.0])   # optical axis
        up = np.asarray([0.0, 0.0, -1.0])
        x = np.cross(up, out); x /= np.linalg.norm(x)
        y = np.cross(out, x)
        Rwc = np.stack([x, y, out], axis=1)               # cam axes in world
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ C
        return Tcw


def test_soak_5000_frames_orbit():
    n_frames = 5000
    fps = 25.0                       # 200 s = 10 laps = 9 revisits
    world = OrbitWorld(n_landmarks=4000, seed=3)
    # flat vocabulary sampled from the world's own descriptor population
    # (what a trained vocab converges to on this scene)
    words = jnp.asarray(random_descriptors(256, seed=11))

    def make_slam():
        return slam_system.MonoSlam(
            jnp.asarray(world_cam()), K=32, M=4096, N=256,
            loop_words=words, loop_min_gap=8,
        )

    def world_cam():
        from tests.synth import CAM
        return CAM

    slam = make_slam()
    ckpt_frame = n_frames // 2
    ckpt_path = None
    lm_high_water = 0
    for i in range(n_frames):
        t = i / fps
        f, _ = world.frame(t, n_slots=256, n_clutter=24,
                           seed=100000 + i)
        slam.process_features(f)
        assert len(slam._kf_order) <= 32
        if i % 500 == 499:
            n_lm = int(np.asarray(slam.map.lm_valid).sum())
            lm_high_water = max(lm_high_water, n_lm)
            # culling + fusion keep the table bounded well below capacity
            assert n_lm < 4096, (i, n_lm)
        if i == ckpt_frame:
            import tempfile, os
            ckpt_path = os.path.join(tempfile.mkdtemp(), "soak_ckpt")
            checkpoint.save_slam(ckpt_path, slam)

    st = slam.stats
    assert st["kf_culled"] > 50, st          # culling ran at capacity
    assert st.get("loops", 0) >= 1, st       # revisits detected
    assert lm_high_water < 4096

    # ---- accuracy: full-run ATE and windowed cliff check
    traj = slam.trajectory_twc()
    assert len(traj) > 0.9 * n_frames, len(traj)
    gt = [(ts, np.linalg.inv(world.pose(ts))) for ts, _ in traj]
    rmse, n, scale, _, _ = ate.ate_rmse(traj, gt, with_scale=True)
    assert n > 0.9 * n_frames
    assert rmse < 0.5, (rmse, scale)   # 0.5 m over a ~190 m, 10-lap path

    # windowed ATE: no post-loop/merge cliff (each 500-frame slice aligns
    # independently; a torn map shows up as one slice blowing up)
    worst = 0.0
    for k in range(0, len(traj) - 500, 500):
        sl = traj[k:k + 500]
        gts = gt[k:k + 500]
        r_w, n_w, _, _, _ = ate.ate_rmse(sl, gts, with_scale=True)
        if n_w >= 100:
            worst = max(worst, r_w)
    assert worst < 0.35, worst

    # ---- checkpoint/resume: bit-exact map, identical continuation
    resumed = make_slam()
    checkpoint.load_slam(ckpt_path, resumed)
    np.testing.assert_array_equal(np.asarray(resumed.map.kf_T),
                                  np.asarray(_ckpt_map(ckpt_path).kf_T))
    ref = make_slam()
    checkpoint.load_slam(ckpt_path, ref)
    for i in range(ckpt_frame + 1, ckpt_frame + 21):
        t = i / fps
        f, _ = world.frame(t, n_slots=256, n_clutter=24, seed=100000 + i)
        resumed.process_features(f)
        ref.process_features(f)
    np.testing.assert_array_equal(np.asarray(resumed.T_last),
                                  np.asarray(ref.T_last))
    np.testing.assert_array_equal(np.asarray(resumed.map.lm_pos),
                                  np.asarray(ref.map.lm_pos))


def _ckpt_map(path):
    atlas, _, _ = checkpoint.load_atlas(path + ".npz", with_arrays=True)
    return atlas.current
