"""Event-stream data parallelism: shard the event batch across the mesh,
splat each shard into a private accumulator, all-reduce the [H,W] image.

This is the long-sequence axis the reference does not have
(SURVEY §5.7): its event windows are consumed serially on one CPU thread
(src/Event/EvImBuilder.cpp:1300-1515). Here the Gaussian-splat accumulator
is a sum over events, so the event axis shards freely — each device
contracts its slice of the separable weight matrices and a single
``psum`` of the (H,W) accumulator (~169 KiB at 240x180 f32) merges the
partial images over NVLink (all to all, so the flat 1-D mesh fits). Payload is independent of the event count, so
scaling efficiency grows with window size.

The same pattern extends to every event-window reduction (contrast scores,
gen-rate, warped-MCI candidates): anything of the form sum_i f(event_i)
shards on the event axis with one small psum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from eorb_slam_tpu.event import tensorize
from eorb_slam_tpu.parallel import mesh_utils


def splat_gauss_sharded(
    mesh: Mesh,
    xy: jnp.ndarray,      # (N,2) event pixel coords, N divisible by mesh size
    valid: jnp.ndarray,   # (N,)
    pol: jnp.ndarray,     # (N,) +-1 polarity
    H: int,
    W: int,
    sigma: float = 1.0,
    stencil: int = 5,
    use_polarity: bool = False,
) -> jnp.ndarray:
    """Event-sharded ``tensorize.splat_gauss``: identical output, event axis
    split over the mesh, accumulator psum-reduced."""
    axis = mesh_utils.LM_AXIS
    trunc = stencil / 2.0

    def local(xy_s, v_s, p_s):
        w_ev = jnp.where(use_polarity, p_s, 1.0) * v_s.astype(xy_s.dtype)
        acc = tensorize._splat_gauss_separable(xy_s, w_ev, H, W, sigma, trunc)
        return jax.lax.psum(acc, axis)

    f = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(),
    ))
    return f(xy, valid, pol)


@functools.partial(jax.jit, static_argnames=("H", "W", "sigma", "mesh"))
def _window_scores_sharded(mesh, ev, valid, dt, H, W, sigma):
    """Event-sharded window statistics: plain-histogram accumulator plus the
    window's event generation rate, one fused shard_map (the builder's
    gen-rate gate + histogram candidate on the sharded axis)."""
    axis = mesh_utils.LM_AXIS

    def local(ev_s, v_s):
        acc = tensorize._splat_gauss_separable(
            ev_s[:, 1:3], v_s.astype(ev_s.dtype), H, W, sigma, 2.5)
        n = jnp.sum(v_s.astype(jnp.float32))
        return jax.lax.psum(acc, axis), jax.lax.psum(n, axis)

    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(axis), P(axis)), out_specs=(P(), P()))
    acc, n = f(ev, valid)
    rate = n / jnp.maximum(dt, 1e-9) / (H * W)
    return acc, rate
