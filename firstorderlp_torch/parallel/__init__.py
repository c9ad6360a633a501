"""Multi-device solves: solver meshes, the block-partitioned constraint
operator's placement and sharded_optimize (parallel/sharded.py),
torch.distributed process groups (parallel/distributed.py), and
row-sharded ingest, where each process loads only its rows
(parallel/shard_ingest.py: host_sharded_optimize)."""

from .mesh import solver_mesh, default_solver_mesh
from .sharded import make_placement, pad_problem, sharded_optimize

__all__ = [
    "solver_mesh",
    "default_solver_mesh",
    "make_placement",
    "pad_problem",
    "sharded_optimize",
]
