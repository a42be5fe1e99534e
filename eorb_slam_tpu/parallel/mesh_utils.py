"""Device-mesh helpers.

The reference has no distributed computing (single process, 9 threads —
SURVEY.md §2.10/§5.8). This engine scales the *data axes* instead:
landmarks/observations shard over the mesh for bundle adjustment, event
batches shard for tensorization. One flat 1-D "lm" axis covers both (every
GPU of a host reaches every other over NVLink at the same rate, so the mesh
needs no topology); multi-host runs extend it across hosts via
jax.distributed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LM_AXIS = "lm"


def make_mesh(n_devices: int | None = None, axis: str = LM_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def lm_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (landmark) axis, replicate the rest."""
    return NamedSharding(mesh, P(LM_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
