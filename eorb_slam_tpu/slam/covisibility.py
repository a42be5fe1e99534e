"""Covisibility graph as dense tensor math.

Replacement for the reference's per-KF covisibility bookkeeping
(KeyFrame::UpdateConnections / GetVectorCovisibleKeyFrames, src/KeyFrame.cc:
weighted edges between KFs sharing >= 15 map points, plus a spanning tree).
The pointer-graph becomes one matmul: with A (M,K) the landmark-observed-by-
keyframe indicator gathered from the observation table, the shared-point
count matrix is A^T A — recomputed on demand, always consistent with the map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import map_state as ms

MIN_SHARED = 15  # reference KeyFrame::UpdateConnections threshold


@jax.jit
def obs_indicator(m: ms.MapState) -> jnp.ndarray:
    """(M,K) float: landmark m observed by keyframe k."""
    A = jnp.zeros((m.M, m.K), jnp.float32)
    rows = jnp.repeat(jnp.arange(m.M), m.P)
    cols = jnp.where(m.obs_valid, m.obs_kf, 0).reshape(-1)
    vals = (m.obs_valid & m.lm_valid[:, None]).reshape(-1)
    return A.at[rows, cols].max(vals.astype(jnp.float32))


@jax.jit
def shared_counts(m: ms.MapState) -> jnp.ndarray:
    """(K,K) number of landmarks shared by each KF pair (diag = own count)."""
    A = obs_indicator(m)
    C = A.T @ A
    valid2 = m.kf_valid[:, None] & m.kf_valid[None, :]
    return jnp.where(valid2, C, 0.0)


@functools.partial(jax.jit, static_argnames=("top_k",))
def covisible_neighbors(m: ms.MapState, kf: jnp.ndarray, top_k: int = 10):
    """Best covisible KFs of `kf` (GetBestCovisibilityKeyFrames)."""
    C = shared_counts(m)
    row = C[kf].at[kf].set(0.0)
    w, idx = jax.lax.top_k(row, top_k)
    return idx, w


@jax.jit
def covisibility_mask(m: ms.MapState, kf: jnp.ndarray,
                      min_shared: float = MIN_SHARED) -> jnp.ndarray:
    """(K,) bool — KFs connected to `kf` (incl. itself). Used to exclude the
    covisibility group from loop-candidate retrieval (reference
    src/KeyFrameDatabase.cc:DetectNBestCandidates)."""
    C = shared_counts(m)
    mask = C[kf] >= min_shared
    return mask.at[kf].set(True)
