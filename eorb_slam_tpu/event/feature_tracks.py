"""Fixed-capacity persistent feature tracks (KLT-carried, landmark-linked).

Redesign of ``FeatureTrack`` (reference
include/Utils/FeatureTrack.h:21-74, src/Utils/FeatureTrack.cpp) — the
backbone of the continuous event tracker ``EvAsynchTrackerU`` (reference
src/Event/EvAsynchTrackerU.cpp:744-961: trackLastFeatures /
checkTrackedMapPoints / detectAndFuseNewFeatures / selectNewKPtsUniform).

A track owns one slot for its whole life; the slot index doubles as the
feature index in every keyframe it appears in, so two keyframes' feature
arrays are ALIGNED by construction and triangulation needs no descriptor
matching at all — the reference's per-track ``map<frameId, kpt>`` becomes
"the same row of consecutive kf_xy arrays".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from eorb_slam_tpu.event import klt
from eorb_slam_tpu.ops import fast


class TrackStore(NamedTuple):
    xy: jnp.ndarray        # (T,2) current position
    valid: jnp.ndarray     # (T,) alive
    lm: jnp.ndarray        # (T,) int32 attached landmark or -1
    age: jnp.ndarray       # (T,) int32 images survived
    birth_kf: jnp.ndarray  # (T,) int32 keyframe slot at (re)birth, -1 = none
    desc_pm1: jnp.ndarray  # (T,256) int8 descriptor at birth
    quality: jnp.ndarray   # (T,) float32 KLT NCC of the last advance

    @property
    def T(self):
        return self.xy.shape[0]


def empty_tracks(T: int) -> TrackStore:
    return TrackStore(
        xy=jnp.zeros((T, 2), jnp.float32),
        valid=jnp.zeros(T, bool),
        lm=jnp.full(T, -1, jnp.int32),
        age=jnp.zeros(T, jnp.int32),
        birth_kf=jnp.full(T, -1, jnp.int32),
        desc_pm1=jnp.zeros((T, 256), jnp.int8),
        quality=jnp.ones(T, jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("win", "levels", "iters"))
def advance(
    tr: TrackStore,
    img_prev: jnp.ndarray,
    img_cur: jnp.ndarray,
    guess_xy: jnp.ndarray = None,   # (T,2) predicted positions (optional)
    win: int = 11,
    levels: int = 3,
    iters: int = 8,
    min_ncc: float = 0.4,
):
    """KLT-advance every live track into the current image
    (trackLastFeatures, reference src/Event/EvAsynchTrackerU.cpp:744).
    Returns (TrackStore, median displacement of surviving tracks)."""
    res = klt.track(
        img_prev, img_cur, tr.xy, tr.valid,
        guess=guess_xy, win=win, levels=levels, iters=iters, min_ncc=min_ncc,
    )
    med = klt.median_displacement(res, tr.xy)
    tr = tr._replace(
        xy=jnp.where(res.ok[:, None], res.xy, tr.xy),
        valid=tr.valid & res.ok,
        age=tr.age + res.ok.astype(jnp.int32),
        quality=jnp.where(res.ok, jnp.clip(res.ncc, 0.0, 1.0), tr.quality),
    )
    return tr, med


@functools.partial(
    jax.jit, static_argnames=("cell", "per_cell", "max_new", "border")
)
def top_up(
    tr: TrackStore,
    img: jnp.ndarray,
    min_dist: float = 8.0,
    threshold: float = 0.08,
    cell: int = 24,
    per_cell: int = 2,
    max_new: int = 128,
    border: int = 6,
):
    """Detect grid-uniform FAST corners and seed them into dead slots,
    skipping detections near live tracks (detectAndFuseNewFeatures /
    selectNewKPtsUniform, reference src/Event/EvAsynchTrackerU.cpp:855-931).
    New tracks carry lm=-1, birth_kf=-1 until a keyframe adopts them."""
    xy_new, resp, v_new = fast.detect_grid(
        img, threshold=threshold, min_threshold=threshold / 3.0,
        cell=cell, per_cell=per_cell, max_kp=max_new, border=border,
    )
    # suppress candidates near existing live tracks
    d2 = jnp.sum((xy_new[:, None, :] - tr.xy[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(tr.valid[None, :], d2, jnp.inf)
    v_new = v_new & (jnp.min(d2, axis=1) >= min_dist**2)

    # prefix-sum allocation of accepted candidates into dead slots
    free = ~tr.valid
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    n_free = jnp.sum(free.astype(jnp.int32))
    cand_rank = jnp.cumsum(v_new.astype(jnp.int32)) - 1
    take = v_new & (cand_rank < n_free)
    Tcap = tr.T
    slot_of_rank = jnp.zeros(Tcap, jnp.int32).at[
        jnp.where(free, free_rank, Tcap - 1)
    ].set(jnp.arange(Tcap, dtype=jnp.int32), mode="drop")
    slot = jnp.where(take, slot_of_rank[jnp.clip(cand_rank, 0, Tcap - 1)], 0)

    tr = tr._replace(
        xy=tr.xy.at[slot].set(jnp.where(take[:, None], xy_new, tr.xy[slot])),
        valid=tr.valid.at[slot].set(jnp.where(take, True, tr.valid[slot])),
        lm=tr.lm.at[slot].set(jnp.where(take, -1, tr.lm[slot])),
        age=tr.age.at[slot].set(jnp.where(take, 0, tr.age[slot])),
        birth_kf=tr.birth_kf.at[slot].set(
            jnp.where(take, -1, tr.birth_kf[slot])
        ),
        quality=tr.quality.at[slot].set(
            jnp.where(take, 1.0, tr.quality[slot])
        ),
    )
    return tr, jnp.sum(take.astype(jnp.int32))
