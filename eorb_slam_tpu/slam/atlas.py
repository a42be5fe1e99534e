"""Atlas: multi-map container with lost-tracking recovery and map merging.

Replacement for the reference's Atlas (src/Atlas.cc,
include/Atlas.h:49-169): active map + stored maps, `CreateNewMap` when
tracking is irrecoverably lost, merge of a stored map into the active one
when a common region is found (src/LoopClosing.cc MergeLocal :1301).

Here a "map" is one fixed-capacity MapState value, so the Atlas is a list
of MapStates + an active index; merging = Sim3-aligning the stored map's
keyframe/landmark tensors into the active frame and copying them into free
slots (all batched tensor ops, no pointer surgery). The event pipeline
instantiates its own Atlas, exactly as the reference keeps a separate event
Atlas (src/Event/EvTrackManager.cpp:39)."""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np

from ..geometry import lie
from . import map_state as ms


class Atlas:
    def __init__(self, K: int = 32, M: int = 4096, N: int = 512, P: int = 8):
        self.caps = (K, M, N, P)
        self.maps: List[ms.MapState] = [ms.empty_map(K, M, N, P)]
        self.active = 0
        # per-map bookkeeping mirrored from MonoSlam host state
        self.imu_initialized: List[bool] = [False]

    @property
    def current(self) -> ms.MapState:
        return self.maps[self.active]

    @current.setter
    def current(self, m: ms.MapState) -> None:
        self.maps[self.active] = m

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> ms.MapState:
        """Tracking lost with an established map: keep it, start fresh
        (reference Tracking::CreateMapInAtlas, src/Tracking.cc:1206-1224).
        If the active map is tiny (<10 KFs) the reference resets it instead
        — callers decide; this always stores."""
        K, M, N, P = self.caps
        self.maps.append(ms.empty_map(K, M, N, P))
        self.imu_initialized.append(False)
        self.active = len(self.maps) - 1
        return self.current

    def reset_active(self) -> ms.MapState:
        K, M, N, P = self.caps
        self.maps[self.active] = ms.empty_map(K, M, N, P)
        self.imu_initialized[self.active] = False
        return self.current

    def merge(self, stored_idx: int, R, t, s) -> ms.MapState:
        """Weld stored map `stored_idx` into the active map.

        (R,t,s): Sim3 mapping stored-map world coords into active-map world
        coords (from a sim3_ransac between a stored KF and an active KF).
        Keyframes land in free KF slots, landmarks in free landmark slots;
        observation indices are re-based. Equivalent of the reference's
        MergeLocal welding (src/LoopClosing.cc:1301) minus the duplicate
        fusion pass, which the next local BA's culling performs."""
        act = self.maps[self.active]
        sto = self.maps[stored_idx]
        K, M, N, P = self.caps

        a_kf = np.asarray(act.kf_valid)
        s_kf = np.flatnonzero(np.asarray(sto.kf_valid))
        free_kf = np.flatnonzero(~a_kf)
        n_kf = min(len(s_kf), len(free_kf))
        a_lm = np.asarray(act.lm_valid)
        s_lm = np.flatnonzero(np.asarray(sto.lm_valid))
        free_lm = np.flatnonzero(~a_lm)
        n_lm = min(len(s_lm), len(free_lm))
        if n_kf == 0:
            return act

        kf_map = np.full(K, -1, np.int64)
        kf_map[s_kf[:n_kf]] = free_kf[:n_kf]
        lm_map = np.full(M, -1, np.int64)
        lm_map[s_lm[:n_lm]] = free_lm[:n_lm]

        R = jnp.asarray(R); t = jnp.asarray(t); s = jnp.asarray(s)
        lm_new_pos = lie.sim3_apply(R, t, s, sto.lm_pos)
        # Keyframe pose re-expression. Stored pose: x_cam = Rcw x_s + tcw.
        # With x_s = S^-1(x_a) = si Ri x_a + ti, the composed map is
        # x_cam = si (Rcw Ri) x_a + (Rcw ti + tcw); projection is invariant
        # to an overall scale, so the SE3 form is [Rcw Ri | (Rcw ti + tcw)/si]
        # (same scale-folding as reference src/Optimizer.cc essential-graph
        # pose recovery: Tcw = [R | t/s]).
        Ri, ti, si = lie.sim3_inv(R, t, s)
        Rcw = sto.kf_T[:, :3, :3]; tcw = sto.kf_T[:, :3, 3]
        Rn = Rcw @ Ri[None]
        tn = ((Rcw @ ti[None, :, None])[:, :, 0] + tcw) / si
        T_new = jnp.concatenate(
            [jnp.concatenate([Rn, tn[:, :, None]], axis=2),
             jnp.tile(jnp.asarray([[[0.0, 0.0, 0.0, 1.0]]]), (K, 1, 1))],
            axis=1,
        )

        src_kf = jnp.asarray(s_kf[:n_kf]); dst_kf = jnp.asarray(free_kf[:n_kf])
        src_lm = jnp.asarray(s_lm[:n_lm]); dst_lm = jnp.asarray(free_lm[:n_lm])
        lm_map_j = jnp.asarray(lm_map)
        kf_map_j = jnp.asarray(kf_map)

        feat_lm_re = jnp.where(
            sto.kf_feat_lm >= 0, lm_map_j[jnp.clip(sto.kf_feat_lm, 0)], -1
        ).astype(jnp.int32)
        obs_kf_re = kf_map_j[jnp.clip(sto.obs_kf, 0)].astype(jnp.int32)
        obs_ok = sto.obs_valid & (obs_kf_re >= 0)

        new = act._replace(
            kf_T=act.kf_T.at[dst_kf].set(T_new[src_kf]),
            kf_valid=act.kf_valid.at[dst_kf].set(True),
            kf_ts=act.kf_ts.at[dst_kf].set(sto.kf_ts[src_kf]),
            kf_xy=act.kf_xy.at[dst_kf].set(sto.kf_xy[src_kf]),
            kf_octave=act.kf_octave.at[dst_kf].set(sto.kf_octave[src_kf]),
            kf_angle=act.kf_angle.at[dst_kf].set(sto.kf_angle[src_kf]),
            kf_desc_pm1=act.kf_desc_pm1.at[dst_kf].set(sto.kf_desc_pm1[src_kf]),
            kf_feat_valid=act.kf_feat_valid.at[dst_kf].set(
                sto.kf_feat_valid[src_kf]),
            kf_feat_lm=act.kf_feat_lm.at[dst_kf].set(feat_lm_re[src_kf]),
            lm_pos=act.lm_pos.at[dst_lm].set(lm_new_pos[src_lm]),
            lm_valid=act.lm_valid.at[dst_lm].set(True),
            lm_desc_pm1=act.lm_desc_pm1.at[dst_lm].set(sto.lm_desc_pm1[src_lm]),
            lm_nobs=act.lm_nobs.at[dst_lm].set(sto.lm_nobs[src_lm]),
            lm_first_kf=act.lm_first_kf.at[dst_lm].set(
                jnp.clip(kf_map_j[jnp.clip(sto.lm_first_kf[src_lm], 0)], 0)
                .astype(jnp.int32)),
            obs_kf=act.obs_kf.at[dst_lm].set(jnp.clip(obs_kf_re[src_lm], 0)),
            obs_feat=act.obs_feat.at[dst_lm].set(sto.obs_feat[src_lm]),
            obs_valid=act.obs_valid.at[dst_lm].set(obs_ok[src_lm]),
        )
        self.maps[self.active] = new
        del self.maps[stored_idx]
        del self.imu_initialized[stored_idx]
        if stored_idx < self.active:
            self.active -= 1
        return self.current
