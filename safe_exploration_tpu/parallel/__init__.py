"""Multi-device scale-out (mesh/sharding). The reference is single-process CPU
(SURVEY.md §2.9); these are the framework's parallelism deliverables."""

from safe_exploration_tpu.parallel.mesh import (
    EPISODE_AXIS,
    batched_solves,
    make_mesh,
    shard_batch,
)
from safe_exploration_tpu.parallel.sharded_gp import (
    DATA_AXIS,
    shard_sparse_gp,
    sparse_gp_refit_sharded,
)

__all__ = [
    "EPISODE_AXIS",
    "DATA_AXIS",
    "make_mesh",
    "shard_batch",
    "batched_solves",
    "shard_sparse_gp",
    "sparse_gp_refit_sharded",
]
