"""Descriptor matching as matmul-shaped reductions.

Replaces ORBmatcher's scalar XOR/popcount loops and its 10 search variants
(reference src/ORBmatcher.cc: SearchByProjection x4, SearchByBoW,
SearchForInitialization, SearchForTriangulation, Fuse x2) with one core
primitive: a masked Hamming distance matrix computed as an int8 matmul over
{-1,+1}-unpacked descriptors, followed by masked top-2 reductions.

All gating (search windows, scale levels, epipolar bands, rotation
histograms) enters as a boolean/additive mask on the distance matrix —
the different "search functions" of the reference become mask builders.

Constants lifted from the reference (include/ORBmatcher.h): TH_LOW=50,
TH_HIGH=100, HISTO_LENGTH=30 rotation-consistency bins, NN ratio tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 10_000  # sentinel distance for masked pairs (> any Hamming distance)


def hamming_matrix(desc1_pm1: jnp.ndarray, desc2_pm1: jnp.ndarray) -> jnp.ndarray:
    """(N,256)x(M,256) {-1,+1} int8 -> (N,M) int32 Hamming distances."""
    dot = jax.lax.dot_general(
        desc1_pm1,
        desc2_pm1,
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (256 - dot) // 2


def masked_best2(dist: jnp.ndarray, mask: jnp.ndarray):
    """Per-row best and second-best over masked columns.

    Returns (best_idx (N,), best_d (N,), second_d (N,))."""
    d = jnp.where(mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second_d = jnp.min(d2, axis=1)
    return best_idx, best_d, second_d


def mutual_filter(best12: jnp.ndarray, best21: jnp.ndarray) -> jnp.ndarray:
    """Cross-check: keep match i->j only if j->i. (N,) bool."""
    return jnp.take_along_axis(best21, best12, axis=0) == jnp.arange(
        best12.shape[0]
    )


def rotation_consistency(
    angles1: jnp.ndarray,
    angles2: jnp.ndarray,
    best12: jnp.ndarray,
    matched: jnp.ndarray,
    keep_bins: int = 3,
) -> jnp.ndarray:
    """ORB-SLAM's 30-bin rotation histogram check: keep only matches whose
    angle difference falls into the `keep_bins` most popular bins
    (reference src/ORBmatcher.cc ComputeThreeMaxima)."""
    dtheta = angles1 - angles2[best12]
    dtheta = jnp.mod(dtheta, 2 * jnp.pi)
    bins = jnp.floor(dtheta / (2 * jnp.pi) * HISTO_LENGTH).astype(jnp.int32)
    bins = jnp.clip(bins, 0, HISTO_LENGTH - 1)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(
        matched.astype(jnp.int32)
    )
    _, top = jax.lax.top_k(hist, keep_bins)
    in_top = jnp.any(bins[:, None] == top[None, :], axis=1)
    return matched & in_top


@functools.partial(jax.jit, static_argnames=("mutual",))
def match_nnratio(
    desc1_pm1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2_pm1: jnp.ndarray,
    valid2: jnp.ndarray,
    pair_mask: jnp.ndarray | None = None,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.75,
    mutual: bool = True,
):
    """Generic masked NN-ratio matcher.

    Args:
      desc*_pm1: (N,256)/(M,256) int8 {-1,+1} descriptors.
      valid*: (N,)/(M,) slot validity.
      pair_mask: optional (N,M) bool of admissible pairs (search window /
        epipolar / scale gates).

    Returns (match12 (N,) int32 — index into 2 or -1, dist (N,) int32)."""
    dist = hamming_matrix(desc1_pm1, desc2_pm1)
    mask = valid1[:, None] & valid2[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    best12, d1, d2 = masked_best2(dist, mask)
    ok = (d1 <= max_dist) & (d1 <= nn_ratio * d2)
    if mutual:
        best21 = jnp.argmin(jnp.where(mask, dist, BIG).T, axis=1)
        ok = ok & (best21[best12] == jnp.arange(best12.shape[0]))
    return jnp.where(ok, best12, -1), jnp.where(ok, d1, BIG)


def window_mask(
    xy1: jnp.ndarray, xy2: jnp.ndarray, radius: float
) -> jnp.ndarray:
    """(N,M) bool: pairs within a pixel search window (projection search)."""
    d2 = jnp.sum((xy1[:, None, :] - xy2[None, :, :]) ** 2, axis=-1)
    return d2 <= radius * radius


def level_mask(
    lv1: jnp.ndarray, lv2: jnp.ndarray, max_diff: int = 1
) -> jnp.ndarray:
    """(N,M) bool: pyramid-level compatibility gate."""
    return jnp.abs(lv1[:, None] - lv2[None, :]) <= max_diff


def channel_mask(ch1: jnp.ndarray, ch2: jnp.ndarray) -> jnp.ndarray:
    """(N,M) bool: same-descriptor-channel gate for mixed ORB/AKAZE frames
    (reference MixedMatcher never compares ORB against MLDB descriptors,
    include/MixedMatcher.h:15-67)."""
    return ch1[:, None] == ch2[None, :]
