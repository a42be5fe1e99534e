"""Fixed-capacity tensor map state.

Replacement for the reference's pointer-graph map
(Frame/KeyFrame/MapPoint/Map/Atlas, reference src/{Frame,KeyFrame,MapPoint,
Map,Atlas}.cc): keyframes, landmarks, and a landmark-major observation
table live in pre-allocated arrays with validity masks. Allocation is a
monotone cursor + masked slots — no dynamic structures, so every SLAM step
stays jittable with static shapes.

An "Atlas" (multi-map container) is simply more than one MapState value;
the event pipeline instantiates its own (reference src/Event/
EvTrackManager.cpp:39 creates a second Atlas).

Capacities (static): K keyframes, M landmarks, N features/frame,
P observations/landmark.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MapState(NamedTuple):
    # --- keyframes
    kf_T: jnp.ndarray          # (K,4,4) Tcw
    kf_valid: jnp.ndarray      # (K,) bool
    kf_ts: jnp.ndarray         # (K,) float64-as-f32 timestamp
    kf_xy: jnp.ndarray         # (K,N,2) undistorted pixel coords
    kf_octave: jnp.ndarray     # (K,N) int32
    kf_angle: jnp.ndarray      # (K,N) float32
    kf_desc_pm1: jnp.ndarray   # (K,N,256) int8
    kf_feat_valid: jnp.ndarray # (K,N) bool
    kf_feat_lm: jnp.ndarray    # (K,N) int32 landmark id or -1
    # --- landmarks
    lm_pos: jnp.ndarray        # (M,3)
    lm_valid: jnp.ndarray      # (M,) bool
    lm_desc_pm1: jnp.ndarray   # (M,256) int8 representative descriptor
    lm_nobs: jnp.ndarray       # (M,) int32
    lm_first_kf: jnp.ndarray   # (M,) int32
    # --- observation table (landmark-major, feeds BA directly)
    obs_kf: jnp.ndarray        # (M,P) int32
    obs_feat: jnp.ndarray      # (M,P) int32
    obs_valid: jnp.ndarray     # (M,P) bool

    @property
    def K(self):
        return self.kf_T.shape[0]

    @property
    def M(self):
        return self.lm_pos.shape[0]

    @property
    def N(self):
        return self.kf_xy.shape[1]

    @property
    def P(self):
        return self.obs_kf.shape[1]


def empty_map(K: int = 32, M: int = 4096, N: int = 512, P: int = 8) -> MapState:
    return MapState(
        kf_T=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_ts=jnp.zeros(K, jnp.float32),
        kf_xy=jnp.zeros((K, N, 2), jnp.float32),
        kf_octave=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N), jnp.float32),
        kf_desc_pm1=jnp.zeros((K, N, 256), jnp.int8),
        kf_feat_valid=jnp.zeros((K, N), bool),
        kf_feat_lm=jnp.full((K, N), -1, jnp.int32),
        lm_pos=jnp.zeros((M, 3), jnp.float32),
        lm_valid=jnp.zeros(M, bool),
        lm_desc_pm1=jnp.zeros((M, 256), jnp.int8),
        lm_nobs=jnp.zeros(M, jnp.int32),
        lm_first_kf=jnp.zeros(M, jnp.int32),
        obs_kf=jnp.zeros((M, P), jnp.int32),
        obs_feat=jnp.zeros((M, P), jnp.int32),
        obs_valid=jnp.zeros((M, P), bool),
    )


@jax.jit
def insert_keyframe(
    m: MapState,
    slot: jnp.ndarray,
    Tcw: jnp.ndarray,
    ts,
    xy: jnp.ndarray,
    octave: jnp.ndarray,
    angle: jnp.ndarray,
    desc_pm1: jnp.ndarray,
    feat_valid: jnp.ndarray,
    feat_lm: jnp.ndarray,
) -> MapState:
    """Write a frame into keyframe slot `slot` and register its landmark
    observations into the obs table (equivalent of KeyFrame construction +
    MapPoint::AddObservation, reference src/KeyFrame.cc, src/MapPoint.cc)."""
    m = m._replace(
        kf_T=m.kf_T.at[slot].set(Tcw),
        kf_valid=m.kf_valid.at[slot].set(True),
        kf_ts=m.kf_ts.at[slot].set(ts),
        kf_xy=m.kf_xy.at[slot].set(xy),
        kf_octave=m.kf_octave.at[slot].set(octave),
        kf_angle=m.kf_angle.at[slot].set(angle),
        kf_desc_pm1=m.kf_desc_pm1.at[slot].set(desc_pm1),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(feat_valid),
        kf_feat_lm=m.kf_feat_lm.at[slot].set(feat_lm),
    )
    # register observations: for each feature matched to a landmark, append
    # (slot, feat_idx) into that landmark's first FREE obs column (derived
    # from obs_valid occupancy, so it stays consistent after keyframe
    # culling invalidates arbitrary columns). When a row is full, overwrite
    # the OLDEST observation by its keyframe timestamp (the reference keeps
    # all observations; with a fixed P budget dropping the stalest one is
    # the bounded-memory equivalent).
    N = feat_lm.shape[0]
    P = m.P
    has_lm = (feat_lm >= 0) & feat_valid
    lm_idx = jnp.where(has_lm, feat_lm, 0)
    row_valid = m.obs_valid[lm_idx]                       # (N,P)
    first_free = jnp.argmin(row_valid, axis=1)            # first False (0 if full)
    full = row_valid.all(axis=1)
    obs_ts = m.kf_ts[m.obs_kf[lm_idx]]                    # (N,P)
    oldest = jnp.argmin(jnp.where(row_valid, obs_ts, jnp.inf), axis=1)
    cursor = jnp.where(full, oldest, first_free).astype(jnp.int32)
    feat_ids = jnp.arange(N, dtype=jnp.int32)
    m = m._replace(
        obs_kf=m.obs_kf.at[lm_idx, cursor].set(
            jnp.where(has_lm, slot, m.obs_kf[lm_idx, cursor])
        ),
        obs_feat=m.obs_feat.at[lm_idx, cursor].set(
            jnp.where(has_lm, feat_ids, m.obs_feat[lm_idx, cursor])
        ),
        obs_valid=m.obs_valid.at[lm_idx, cursor].set(
            jnp.where(has_lm, True, m.obs_valid[lm_idx, cursor])
        ),
    )
    m = m._replace(lm_nobs=jnp.sum(m.obs_valid, axis=1, dtype=jnp.int32))
    return m


def alloc_landmarks(
    m: MapState,
    new_pos: jnp.ndarray,      # (C,3) candidate positions
    new_desc: jnp.ndarray,     # (C,256) int8
    new_ok: jnp.ndarray,       # (C,) bool — candidate accepted
    kf_a: jnp.ndarray,         # () int32 keyframe slot of view A
    feat_a: jnp.ndarray,       # (C,) int32 feature idx in view A
    kf_b: jnp.ndarray,
    feat_b: jnp.ndarray,
):
    """Prefix-sum slot allocation of new landmarks into free lm slots.

    Replaces LocalMapping::CreateNewMapPoints' dynamic `new MapPoint`
    (reference src/LocalMapping.cc): free slots are enumerated with a
    cumulative sum, candidate i takes the (rank_i)-th free slot; overflow
    candidates are dropped (mask), never OOB.

    Returns (new MapState, lm_ids (C,) int32 — assigned id or -1)."""
    M = m.M
    free = ~m.lm_valid
    # rank of each free slot among free slots
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1       # (M,)
    n_free = jnp.sum(free.astype(jnp.int32))
    # rank of each candidate among accepted candidates
    cand_rank = jnp.cumsum(new_ok.astype(jnp.int32)) - 1     # (C,)
    take = new_ok & (cand_rank < n_free)

    # slot for candidate with rank r = index of r-th free slot:
    # build mapping rank -> slot via scatter
    slot_of_rank = jnp.zeros(M, jnp.int32).at[
        jnp.where(free, free_rank, M - 1)
    ].set(jnp.arange(M, dtype=jnp.int32), mode="drop")
    cand_slot = slot_of_rank[jnp.clip(cand_rank, 0, M - 1)]
    cand_slot = jnp.where(take, cand_slot, 0)

    m = m._replace(
        lm_pos=m.lm_pos.at[cand_slot].set(
            jnp.where(take[:, None], new_pos, m.lm_pos[cand_slot])
        ),
        lm_valid=m.lm_valid.at[cand_slot].set(
            jnp.where(take, True, m.lm_valid[cand_slot])
        ),
        lm_desc_pm1=m.lm_desc_pm1.at[cand_slot].set(
            jnp.where(take[:, None], new_desc, m.lm_desc_pm1[cand_slot])
        ),
        lm_first_kf=m.lm_first_kf.at[cand_slot].set(
            jnp.where(take, kf_a, m.lm_first_kf[cand_slot])
        ),
        lm_nobs=m.lm_nobs.at[cand_slot].set(
            jnp.where(take, 2, m.lm_nobs[cand_slot])
        ),
    )
    # write the two founding observations (obs slots 0 and 1) and clear any
    # stale observation rows left by a previously-culled landmark
    obs_kf = m.obs_kf.at[cand_slot, 0].set(jnp.where(take, kf_a, m.obs_kf[cand_slot, 0]))
    obs_kf = obs_kf.at[cand_slot, 1].set(jnp.where(take, kf_b, obs_kf[cand_slot, 1]))
    obs_feat = m.obs_feat.at[cand_slot, 0].set(
        jnp.where(take, feat_a, m.obs_feat[cand_slot, 0])
    )
    obs_feat = obs_feat.at[cand_slot, 1].set(
        jnp.where(take, feat_b, obs_feat[cand_slot, 1])
    )
    fresh_row = jnp.zeros(m.P, bool).at[0].set(True).at[1].set(True)
    obs_valid = m.obs_valid.at[cand_slot].set(
        jnp.where(take[:, None], fresh_row[None, :], m.obs_valid[cand_slot])
    )
    m = m._replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_valid=obs_valid)

    lm_ids = jnp.where(take, cand_slot, -1)
    # back-link the founding features in both keyframes to the new landmark
    m = m._replace(
        kf_feat_lm=m.kf_feat_lm.at[kf_a, feat_a]
        .set(jnp.where(take, lm_ids, m.kf_feat_lm[kf_a, feat_a]))
        .at[kf_b, feat_b]
        .set(jnp.where(take, lm_ids, m.kf_feat_lm[kf_b, feat_b])),
    )
    return m, lm_ids


@jax.jit
def remove_keyframe(m: MapState, slot: jnp.ndarray) -> MapState:
    """Erase keyframe `slot` from the map: invalidate the KF row, drop all
    its observations from the obs table, cull landmarks that fall below two
    observations, and clear stale feature->landmark links everywhere.

    Equivalent of KeyFrame::SetBadFlag + MapPoint::EraseObservation
    (reference src/KeyFrame.cc, src/MapPoint.cc). The slot becomes reusable:
    capacity is a sliding window, not a run-length limit."""
    K, N = m.kf_feat_lm.shape
    m = m._replace(
        kf_valid=m.kf_valid.at[slot].set(False),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(jnp.zeros(N, bool)),
        kf_feat_lm=m.kf_feat_lm.at[slot].set(jnp.full(N, -1, jnp.int32)),
        obs_valid=m.obs_valid & (m.obs_kf != slot),
    )
    nobs = jnp.sum(m.obs_valid, axis=1, dtype=jnp.int32)
    lm_valid = m.lm_valid & (nobs >= 2)
    m = m._replace(lm_nobs=nobs, lm_valid=lm_valid)
    # clear feature links to landmarks that just died
    link_ok = lm_valid[jnp.clip(m.kf_feat_lm, 0)] & (m.kf_feat_lm >= 0)
    m = m._replace(kf_feat_lm=jnp.where(link_ok, m.kf_feat_lm, -1))
    return m


@jax.jit
def keyframe_redundancy(m: MapState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-keyframe redundancy statistics for KeyFrameCulling (reference
    src/LocalMapping.cc:KeyFrameCulling — a KF is redundant when >=90% of
    its map points are observed in at least 3 other keyframes).

    Returns (frac (K,), total (K,)): the fraction of each KF's landmark
    observations whose landmark has >=4 total observations, and the KF's
    observation count."""
    K = m.kf_T.shape[0]
    nobs = jnp.sum(m.obs_valid, axis=1, dtype=jnp.int32)          # (M,)
    live = m.obs_valid & m.lm_valid[:, None]                      # (M,P)
    kf_of_obs = jnp.where(live, m.obs_kf, K)                      # (M,P)
    well_seen = (nobs[:, None] >= 4) & live
    total = jnp.zeros(K, jnp.int32).at[kf_of_obs.reshape(-1)].add(
        live.reshape(-1).astype(jnp.int32), mode="drop")
    red = jnp.zeros(K, jnp.int32).at[kf_of_obs.reshape(-1)].add(
        well_seen.reshape(-1).astype(jnp.int32), mode="drop")
    frac = red.astype(jnp.float32) / jnp.maximum(total, 1).astype(jnp.float32)
    return frac, total


@jax.jit
def median_scene_depth(lm_pos: jnp.ndarray, lm_valid: jnp.ndarray,
                       Tcw: jnp.ndarray) -> jnp.ndarray:
    """Masked median landmark depth in the given camera (reference
    KeyFrame::ComputeSceneMedianDepth). Device scalar: callers float() it
    once instead of pulling the whole landmark table to the host."""
    z = (lm_pos @ Tcw[:3, :3].T)[:, 2] + Tcw[2, 3]
    ok = lm_valid & (z > 1e-3)
    n = jnp.sum(ok)
    zs = jnp.sort(jnp.where(ok, z, jnp.inf))
    med = zs[jnp.clip(n // 2, 0, z.shape[0] - 1)]
    return jnp.where(n >= 8, med, 1.0)
