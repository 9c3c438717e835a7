"""Device-mesh helpers: path-parallel data distribution over devices.

The reference parallelised paths with a multiprocessing.Pool
(backend/simulation.py:982-1010); here the paths axis is a sharded array
dimension on a `jax.sharding.Mesh`. The kernel itself is sharding-oblivious:
every per-path quantity is elementwise over the batch axis, and the summary
reductions (means, sorts for percentiles, histogram counts) are `jnp` ops
that XLA lowers to collectives (psum / all-gather) under jit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PATHS_AXIS = "paths"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: all local devices), axis 'paths'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (PATHS_AXIS,))


def paths_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading (paths) axis across the mesh."""
    return NamedSharding(mesh, P(PATHS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_paths(mesh: Mesh, array: jax.Array) -> jax.Array:
    """Place ``array`` with its leading axis sharded over the mesh."""
    return jax.device_put(array, paths_sharding(mesh))


def pad_to_devices(n_paths: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` that is >= ``n_paths``."""
    return ((n_paths + n_devices - 1) // n_devices) * n_devices


def constrain_paths_axis(mesh: Mesh, tree):
    """Constrain every array leaf's leading axis to the 'paths' mesh axis.

    Applied inside jit, this makes XLA partition the whole simulation SPMD
    over the mesh: the per-path state vectors and the counter-based RNG iota
    split by rows, and downstream reductions (success means, percentile
    sorts) lower to collectives.
    """
    sharding = NamedSharding(mesh, P(PATHS_AXIS))

    def _constrain(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            return jax.lax.with_sharding_constraint(x, sharding)
        return x

    return jax.tree_util.tree_map(_constrain, tree)
