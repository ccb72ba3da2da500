"""Device-mesh scale-out: batched safe-MPC / episodes sharded over devices.

The reference has NO parallelism of any kind (single-process CPU — SURVEY.md
§2.9). The scale-out axes are:

  * **episodes/problems (DP)**: vmap across independent safe-MPC problem
    instances or episodes, sharded over the mesh with ``NamedSharding`` — XLA
    SPMD partitions the whole program; no collectives needed in the forward
    rollout (embarrassingly parallel), so the interconnect stays idle. This
    is BASELINE config 3 (256 vmapped episodes).
  * **large-N GP (a TP analog)**: shard the N-dimension of the inducing-point
    Gram/cross-covariance work (models/sparse_gp.py) with one ``psum``
    reduction per refit — see parallel/sharded_gp.py.

Meshes are 1-D and follow the algorithm; on GPUs joined all to all (NVLink)
every device reaches every other at the same rate.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "batched_solves"]

EPISODE_AXIS = "episodes"


def make_mesh(n_devices: int | None = None, axis: str = EPISODE_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices).reshape(-1), (axis,))


def shard_batch(tree, mesh: Mesh, axis: str = EPISODE_AXIS):
    """Place a batch pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


def batched_solves(fn: Callable, mesh: Mesh, axis: str = EPISODE_AXIS):
    """jit(vmap(fn)) with leading-axis input/output shardings over the mesh.

    ``fn`` is a single-instance function (e.g. one safe-MPC solve or one episode
    rollout step); the result maps a batch across all chips via XLA SPMD.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.jit(
        jax.vmap(fn), in_shardings=sharding, out_shardings=sharding
    )
