"""Checkpoint / resume of the full SLAM state.

The reference's SaveAtlas/LoadAtlas are commented out (reference
src/System.cc:104-168; boost-serialization plumbing survives in
include/Atlas.h:51-72) — so live checkpointing is a capability this
engine ADDS. Because the entire map is a handful of fixed-shape arrays
(slam/map_state.MapState) plus scalar host state, a checkpoint is one
compressed ``.npz`` per atlas + a small JSON of host state; restore is
exact (bit-for-bit array equality), giving real mid-sequence resume.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from eorb_slam_tpu.slam import atlas as atlas_mod
from eorb_slam_tpu.slam import map_state as ms

FORMAT_VERSION = 1


def _norm_path(path: str) -> str:
    # np.savez_compressed appends ".npz" to extension-less paths; mirror that
    # here so save/load agree for any spelling of the checkpoint name.
    return path if path.endswith(".npz") else path + ".npz"


def _map_to_arrays(m: ms.MapState, prefix: str, out: dict) -> None:
    for field, arr in zip(ms.MapState._fields, m):
        out[f"{prefix}{field}"] = np.asarray(arr)


def _map_from_arrays(data, prefix: str) -> ms.MapState:
    return ms.MapState(
        *[jnp.asarray(data[f"{prefix}{field}"]) for field in ms.MapState._fields]
    )


def save_atlas(
    path: str,
    atlas: atlas_mod.Atlas,
    extra: Optional[dict] = None,
    extra_arrays: Optional[dict] = None,
):
    """Write every map in the atlas + host bookkeeping to ``path`` (.npz)."""
    arrays: dict = dict(extra_arrays or {})
    for i, m in enumerate(atlas.maps):
        _map_to_arrays(m, f"map{i}.", arrays)
    meta = {
        "version": FORMAT_VERSION,
        "n_maps": len(atlas.maps),
        "active": atlas.active,
        "caps": list(atlas.caps),
        "imu_initialized": list(atlas.imu_initialized),
        "extra": extra or {},
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    path = _norm_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, with_arrays: bool = False):
    """Returns (Atlas, extra dict[, raw arrays])."""
    data = np.load(_norm_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")
    K, M, N, P = meta["caps"]
    atlas = atlas_mod.Atlas(K=K, M=M, N=N, P=P)
    atlas.maps = [_map_from_arrays(data, f"map{i}.") for i in range(meta["n_maps"])]
    atlas.active = meta["active"]
    atlas.imu_initialized = list(meta["imu_initialized"])
    if with_arrays:
        return atlas, meta["extra"], data
    return atlas, meta["extra"]


_INIT_FRAME_FIELDS = ("xy_ud", "octave", "angle", "desc_pm1", "valid")


def save_slam(path: str, slam) -> None:
    """Checkpoint a MonoSlam-family system: map + trajectory + ALL host state
    needed for exact resume — including the PRNG key (next stochastic op —
    init RANSAC / relocalization — would otherwise diverge), the
    RECENTLY_LOST grace counter, and the pending init frame (a checkpoint
    taken in NOT_INITIALIZED keeps its reference frame)."""
    if hasattr(slam, "flush_pipeline"):
        slam.flush_pipeline()   # resolve in-flight speculative tracking
    extra = {
        "state": slam.state,
        "n_kf": slam.n_kf,
        "kf_order": [int(s) for s in slam._kf_order],
        "kf_seq_next": int(slam._kf_seq_next),
        "T_last": np.asarray(slam.T_last).tolist(),
        "velocity": np.asarray(slam.velocity).tolist(),
        "frames_since_kf": slam.frames_since_kf,
        "n_inliers_ref": slam.n_inliers_ref,
        "lost_frames": slam.lost_frames,
        "stats": slam.stats,
        "trajectory": [
            [ts, None if T is None else np.asarray(T).tolist(), int(ref)]
            for ts, T, ref in slam.trajectory
        ],
        "traj_frozen": [
            [ts, np.asarray(T).tolist()] for ts, T in slam._traj_frozen
        ],
    }
    extra_arrays = {
        "host.key": np.asarray(slam.key),
        "host.kf_seq": np.asarray(slam.kf_seq),
    }
    if slam._init_frame is not None:
        extra["init_frame_ts"] = float(slam._init_frame.ts)
        for fld in _INIT_FRAME_FIELDS:
            extra_arrays[f"initf.{fld}"] = np.asarray(
                getattr(slam._init_frame, fld)
            )
    save_atlas(path, slam.atlas, extra, extra_arrays)


def load_slam(path: str, slam) -> None:
    """Restore a checkpoint into an already-constructed system (capacities
    must match — they are part of the checkpoint)."""
    atlas, extra, data = load_atlas(path, with_arrays=True)
    if atlas.caps != slam.atlas.caps:
        raise ValueError(
            f"capacity mismatch: checkpoint {atlas.caps} vs system {slam.atlas.caps}"
        )
    slam.atlas = atlas
    slam.state = extra["state"]
    if "kf_order" in extra:
        slam._kf_order = [int(s) for s in extra["kf_order"]]
        slam._kf_seq_next = int(extra["kf_seq_next"])
        slam.kf_seq = np.asarray(data["host.kf_seq"]).copy()
        slam.last_kf_slot = slam._kf_order[-1] if slam._kf_order else -1
    else:  # pre-lifecycle checkpoints: contiguous slots
        slam.n_kf = extra["n_kf"]
    slam.T_last = jnp.asarray(np.asarray(extra["T_last"], np.float32))
    slam.velocity = jnp.asarray(np.asarray(extra["velocity"], np.float32))
    slam.frames_since_kf = extra["frames_since_kf"]
    slam.n_inliers_ref = extra["n_inliers_ref"]
    slam.lost_frames = extra.get("lost_frames", 0)
    slam.stats = extra["stats"]
    if "host.key" in data:
        slam.key = jnp.asarray(data["host.key"])
    if "init_frame_ts" in extra:
        from eorb_slam_tpu.slam.system import FrameInput

        slam._init_frame = FrameInput(
            extra["init_frame_ts"],
            *[jnp.asarray(data[f"initf.{fld}"]) for fld in _INIT_FRAME_FIELDS],
        )
    else:
        slam._init_frame = None
    slam.trajectory = [
        (ts, None if T is None else np.asarray(T, np.float32), ref)
        for ts, T, ref in extra["trajectory"]
    ]
    slam._traj_frozen = [
        (ts, np.asarray(T, np.float64)) for ts, T in extra["traj_frozen"]
    ]
