"""Multi-host initialization + distributed-BA launch helpers.

The reference is a single process (SURVEY.md §5.8); this engine's
scale-out axis is the device mesh, extended across hosts with
``jax.distributed``. One call per process wires the coordination service;
the landmark axis of the BA mesh then spans every host's devices and the
per-iteration psum of the reduced camera system runs over NVLink within a
host and the network across hosts (see parallel/dist_ba.py — the payload is
the dense (K,K,6,6)+(K,6) camera system, independent of the landmark
count).

Typical use (one line near the top of each process):

    from eorb_slam_tpu.parallel import multihost
    multihost.init(coordinator="10.0.0.1:8476", num_processes=2,
                   process_id=int(os.environ["RANK"]))
    mesh = multihost.global_mesh()
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init(coordinator: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids=None) -> None:
    """Initialize jax.distributed for this process.

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); where
    no cluster environment announces them, pass all three.
    """
    import jax

    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)


def global_mesh(axis: str = "lm"):
    """1-D mesh over ALL processes' devices (the landmark axis of the
    distributed BA)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_problem_global(prob, mesh):
    """Build a GLOBALLY-sharded BAProblem from per-process numpy data.

    The multi-process analog of dist_ba.shard_problem: landmark-axis leaves
    are assembled with jax.make_array_from_process_local_data (each process
    contributes its addressable slice), replicated leaves are provided in
    full by every process."""
    import jax
    import jax.tree_util as jtu
    from jax.sharding import NamedSharding, PartitionSpec as P

    from eorb_slam_tpu.parallel import dist_ba

    specs = dist_ba.problem_specs()
    n_proc = jax.process_count()
    pid = jax.process_index()

    def make(x, spec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        if spec == P():
            local = x
        else:
            # a non-divisible landmark axis would leave tail rows owned by
            # no process while the global shape still includes them — the
            # caller must pad (see dist_ba.pad_problem / __graft_entry__)
            if x.shape[0] % n_proc != 0:
                raise ValueError(
                    f"landmark axis {x.shape[0]} not divisible by "
                    f"process_count {n_proc}; pad the problem first"
                )
            chunk = x.shape[0] // n_proc
            local = x[pid * chunk : (pid + 1) * chunk]
        return jax.make_array_from_process_local_data(sh, local, x.shape)

    return jtu.tree_map(make, prob, specs)


def comm_report(K: int, M: int, P: int, n_devices: int) -> dict:
    """Per-LM-iteration communication vs compute for the distributed BA
    (see dist_ba.dist_bundle_adjust: ONE psum of the reduced camera system
    per iteration; landmark work stays local).

    Returns bytes moved per iteration per device, local FLOPs, and the
    comm/compute ratio — the quantity that decides whether a cross-host
    network keeps up."""
    # psum payload: S (K,K,6,6) + b (K,6) + cost scalars, float32
    comm_bytes = 4 * (K * K * 36 + K * 6 + 4)
    # local compute: per-observation residual/Jacobian (~2.5k flops) +
    # Schur contraction (P^2 * 36 per landmark) + landmark solves
    m_loc = M // max(n_devices, 1)
    flops = m_loc * P * 2500 + m_loc * P * P * 36 + m_loc * 27 * 4
    return {
        "psum_bytes_per_iter": comm_bytes,
        "local_flops_per_iter": flops,
        "flops_per_byte": flops / comm_bytes,
    }
