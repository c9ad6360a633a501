"""Multi-device solves: solver meshes, the block-partitioned constraint
operator's placement and sharded_optimize (parallel/sharded.py), and
torch.distributed process groups (parallel/distributed.py)."""

from .mesh import solver_mesh, default_solver_mesh
from .sharded import make_placement, pad_problem, sharded_optimize

__all__ = [
    "solver_mesh",
    "default_solver_mesh",
    "make_placement",
    "pad_problem",
    "sharded_optimize",
]
