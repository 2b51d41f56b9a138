"""Device mesh & collectives layer.

The reference has no distributed backend at all (SURVEY.md §2.9); this is
the new framework's first-class replacement: a flat, named
`jax.sharding.Mesh` over the visible devices, with `shard_map`-partitioned
kernels communicating via XLA collectives (psum / pmin / all_gather).  On
a multi-GPU host every card reaches every other one over NVLink at the
same rate, so a 1-D mesh loses nothing to topology.

Axis convention:
  "lm"  — landmark/database parallelism: landmark tables, BA landmark
          blocks and the loop-closure descriptor database are sharded
          here (the "context parallelism" of SLAM: map size scales with
          device count).
Multi-host extends the same mesh via jax.distributed.initialize; nothing
in the kernels changes (collectives are mesh-topology-agnostic).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "lm") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def shard_rows(mesh: Mesh, axis_name: str = "lm") -> NamedSharding:
    """Sharding that splits the leading axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad the leading axis so it divides evenly across devices."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width, constant_values=fill), n
