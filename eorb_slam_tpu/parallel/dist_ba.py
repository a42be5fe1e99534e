"""Distributed bundle adjustment: landmarks sharded over the device mesh.

Replacement for the reference's single-threaded g2o BA
(src/Optimizer.cc LocalBundleAdjustment/GlobalBundleAdjustemnt): each device
owns a shard of the landmark-major observation table, computes its partial
reduced camera system (Schur pieces), psums it over the interconnect, solves the dense
6Kx6K system redundantly-replicated, and back-substitutes its own landmark
shard locally. Communication per LM iteration is exactly one psum of
(K,K,6,6) + (K,6) — independent of the number of landmarks/observations.

Scaling model: throughput scales with devices until the replicated camera
solve dominates; for SLAM-sized K (tens to hundreds) that point is far
beyond a pod slice.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eorb_slam_tpu.optim import schur_ba
from eorb_slam_tpu.parallel.mesh_utils import LM_AXIS


def problem_specs() -> schur_ba.BAProblem:
    """PartitionSpec pytree for a BAProblem sharded on the landmark axis."""
    return schur_ba.BAProblem(
        cam_params=P(),
        kf_T=P(),
        kf_fixed=P(),
        kf_valid=P(),
        lm_pos=P(LM_AXIS),
        lm_valid=P(LM_AXIS),
        obs_kf=P(LM_AXIS),
        obs_uv=P(LM_AXIS),
        obs_inv_sigma=P(LM_AXIS),
        obs_valid=P(LM_AXIS),
    )


def result_specs() -> schur_ba.BAResult:
    return schur_ba.BAResult(
        kf_T=P(),
        lm_pos=P(LM_AXIS),
        obs_inlier=P(LM_AXIS),
        cost0=P(),
        cost=P(),
    )


def shard_problem(p: schur_ba.BAProblem, mesh: Mesh) -> schur_ba.BAProblem:
    """Place a host-resident problem onto the mesh with the BA shardings."""
    return jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        p,
        problem_specs(),
    )


@functools.partial(jax.jit, static_argnames=("mesh", "iters"))
def dist_bundle_adjust(
    p: schur_ba.BAProblem, mesh: Mesh, iters: int = 10, lam0: float = 1e-4
) -> schur_ba.BAResult:
    """LM bundle adjustment over a landmark-sharded problem.

    The landmark capacity M must be divisible by the mesh size."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(problem_specs(),),
        out_specs=result_specs(),
    )
    def run(p_local: schur_ba.BAProblem) -> schur_ba.BAResult:
        return schur_ba._lm_loop(p_local, iters, lam0, axis_name=LM_AXIS)

    return run(p)
