"""Event-ORB trajectory/map fusion — the reference's global Atlas merge.

Equivalent of ``System::FuseEventORB`` (reference
src/System.cc:1022-1034) -> ``MyOptimizer::MergeVisualEvent``
(src/Utils/MyOptimizer.cpp:3471), which welds the event-tracker keyframe
chains into the image-tracker keyframe graph by **timestamp-interpolated
relative-pose constraints** (``addEventVertexPose`` :3356 interpolates the
ORB chain at each event KF's timestamp via ``findNearestPose`` :3296) and
jointly optimizes, producing one fused trajectory in the image gauge.
``EvTrackManager::fuseEventTracks`` (src/Event/EvTrackManager.cpp:430) is
the trajectory-level fallback — a timestamp merge without optimization.

Design here: one Sim3 pose graph (optim/pose_graph.py) over the union of
image poses and event poses. Each disconnected event chain is first
Sim3-initialized against the interpolated image trajectory (Umeyama on
paired positions — each monocular event chain carries its own gauge), then
tied in with (a) sequential odometry edges preserving its internal shape
and (b) anchor edges to the interpolated image poses at its timestamps.
Image vertices are held fixed: the image map is the gauge master, exactly
as the reference rescales the event side only (ApplyScaleAndRotationEvSynch,
src/LoopClosing.cc:2075-2094). The solve is a single jitted masked GN over
dense (7K,7K) normal equations, no g2o.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from eorb_slam_tpu.evals.ate import associate, umeyama_align
from eorb_slam_tpu.geometry import lie
from eorb_slam_tpu.optim import pose_graph as pg


def interpolate_tcw(traj: list[tuple[float, np.ndarray]], t: float):
    """SE3-interpolated world->camera pose at time ``t`` from a sorted
    (ts, Twc) list (reference MyOptimizer::findNearestPose,
    src/Utils/MyOptimizer.cpp:3296). Returns None outside the time span."""
    ts = np.asarray([x for x, _ in traj])
    if len(ts) == 0 or t < ts[0] - 1e-9 or t > ts[-1] + 1e-9:
        return None
    j = int(np.clip(np.searchsorted(ts, t), 1, len(ts) - 1))
    t0, t1 = float(ts[j - 1]), float(ts[j])
    T0 = np.linalg.inv(np.asarray(traj[j - 1][1], np.float64))
    T1 = np.linalg.inv(np.asarray(traj[j][1], np.float64))
    if t1 - t0 < 1e-9:
        return T0.astype(np.float32)
    a = (t - t0) / (t1 - t0)
    return np.asarray(
        lie.interpolate_se3(
            jnp.asarray(T0, jnp.float32), jnp.asarray(T1, jnp.float32),
            float(np.clip(a, 0.0, 1.0)),
        )
    )


def _chain_gauge(chain, im_traj, max_dt):
    """Initial Sim3 (s, R, t: event-world -> image-world) for one event
    chain, from Umeyama over camera centers paired by interpolation."""
    src, dst = [], []
    for ts, Twc_e in chain:
        Tcw_i = interpolate_tcw(im_traj, ts)
        if Tcw_i is None:
            continue
        src.append(np.asarray(Twc_e, np.float64)[:3, 3])
        Twc_i = np.linalg.inv(Tcw_i)
        dst.append(Twc_i[:3, 3])
    if len(src) < 3:
        return None
    src = np.asarray(src)
    dst = np.asarray(dst)
    if np.linalg.norm(src - src[0], axis=1).max() < 1e-6:
        return None
    s, R, t = umeyama_align(src, dst, with_scale=True)
    if not np.isfinite(s) or s < 1e-9:
        return None
    return s, R, t


def fuse_event_orb(
    im_traj: list[tuple[float, np.ndarray]],
    ev_traj: list[tuple[float, np.ndarray]],
    chain_gap_s: float = 1.0,
    anchor_weight: float = 1.0,
    odo_weight: float = 4.0,
    iters: int = 15,
    max_dt: float = 0.05,
):
    """Fuse an event trajectory (possibly disconnected chains) into the
    image trajectory's gauge via one joint Sim3 pose-graph solve.

    im_traj / ev_traj: [(ts, Twc 4x4)]. Returns dict with the fused
    [(ts, Twc)] (union, sorted by ts), per-chain gauges, and counts.
    """
    from eorb_slam_tpu.evals.rpe import break_pieces

    if len(im_traj) < 2:
        return {"fused": list(ev_traj), "chains": 0, "anchored": 0}

    # image-pose vertices, all fixed (gauge master)
    verts_R, verts_t, verts_s, fixed, vert_ts = [], [], [], [], []
    for ts, Twc in im_traj:
        Tcw = np.linalg.inv(np.asarray(Twc, np.float64))
        verts_R.append(Tcw[:3, :3])
        verts_t.append(Tcw[:3, 3])
        verts_s.append(1.0)
        fixed.append(True)
        vert_ts.append((ts, "im"))
    n_im = len(im_traj)

    chains = [
        c for c in break_pieces(ev_traj, th_ts=chain_gap_s) if len(c) >= 3
    ]
    edges = []  # (i, j, R_ji, t_ji, s_ji, w)
    gauges = []
    n_anchor = 0
    for chain in chains:
        g = _chain_gauge(chain, im_traj, max_dt)
        if g is None:
            continue
        s_g, R_g, t_g = g
        gauges.append({"scale": s_g, "n": len(chain)})
        base = len(verts_R)
        prev_idx = None
        prev_Tcw = None
        for ts, Twc_e in chain:
            # bring the event pose into the image gauge: the camera center
            # maps as C' = s R C + t, the orientation as R_cw' = R_cw R_g^T
            Tcw_e = np.linalg.inv(np.asarray(Twc_e, np.float64))
            C = np.asarray(Twc_e, np.float64)[:3, 3]
            C2 = s_g * R_g @ C + t_g
            R2 = Tcw_e[:3, :3] @ R_g.T
            Tcw2 = np.eye(4)
            Tcw2[:3, :3] = R2
            Tcw2[:3, 3] = -R2 @ C2
            idx = len(verts_R)
            verts_R.append(R2)
            verts_t.append(Tcw2[:3, 3])
            verts_s.append(1.0)
            fixed.append(False)
            vert_ts.append((ts, "ev"))
            # (a) sequential odometry edge preserving the chain's shape
            if prev_idx is not None:
                rel = Tcw2 @ np.linalg.inv(prev_Tcw)
                edges.append(
                    (prev_idx, idx, rel[:3, :3], rel[:3, 3], 1.0, odo_weight)
                )
            # (b) anchor edge to the interpolated image pose: measured
            # relative pose between this event KF and its bracketing image
            # vertex (the addEventVertexPose constraint)
            Tcw_i = interpolate_tcw(im_traj, ts)
            if Tcw_i is not None:
                ts_im = np.asarray([x for x, _ in im_traj])
                k = int(
                    np.clip(np.searchsorted(ts_im, ts) - 1, 0, n_im - 1)
                )
                Tcw_k = np.linalg.inv(np.asarray(im_traj[k][1], np.float64))
                # measured S_ji maps cam_k -> cam_ev via the interpolation:
                # rel = Tcw_interp @ Twc_k (what the event pose SHOULD be
                # relative to image vertex k if the two agreed)
                rel = np.asarray(Tcw_i, np.float64) @ np.linalg.inv(Tcw_k)
                edges.append(
                    (k, idx, rel[:3, :3], rel[:3, 3], 1.0, anchor_weight)
                )
                n_anchor += 1
            prev_idx = idx
            prev_Tcw = Tcw2

    if not edges or len(verts_R) == n_im:
        return {"fused": list(im_traj), "chains": 0, "anchored": 0}

    K = len(verts_R)
    E = len(edges)
    g = pg.PoseGraph(
        R=jnp.asarray(np.stack(verts_R), jnp.float32),
        t=jnp.asarray(np.stack(verts_t), jnp.float32),
        s=jnp.asarray(verts_s, jnp.float32),
        kf_valid=jnp.ones(K, bool),
        fixed=jnp.asarray(fixed),
        edge_i=jnp.asarray([e[0] for e in edges], jnp.int32),
        edge_j=jnp.asarray([e[1] for e in edges], jnp.int32),
        edge_R=jnp.asarray(np.stack([e[2] for e in edges]), jnp.float32),
        edge_t=jnp.asarray(np.stack([e[3] for e in edges]), jnp.float32),
        edge_s=jnp.asarray([e[4] for e in edges], jnp.float32),
        edge_w=jnp.asarray([e[5] for e in edges], jnp.float32),
    )
    g2 = pg.optimize_pose_graph(g, iters=iters, chart="sim3")

    R = np.asarray(g2.R, np.float64)
    t = np.asarray(g2.t, np.float64)
    s = np.asarray(g2.s, np.float64)
    fused = []
    for k, (ts, kind) in enumerate(vert_ts):
        Tcw = np.eye(4)
        Tcw[:3, :3] = R[k]
        Tcw[:3, 3] = t[k] / max(s[k], 1e-12)  # Sim3 -> SE3 (unit-scale Twc)
        fused.append((ts, np.linalg.inv(Tcw), kind))
    fused.sort(key=lambda x: x[0])
    return {
        "fused": [(ts, T) for ts, T, _ in fused],
        "kinds": [k for _, _, k in fused],
        "chains": len(gauges),
        "gauges": gauges,
        "anchored": n_anchor,
        "n_vertices": K,
        "n_edges": E,
    }
