"""Multi-device solves: problem padding, placement and
`sharded_optimize`, the port's counterpart of the JAX package's
``parallel/sharded.py``.

Strategy: the constraint matrix is a (D, P) grid of blocks over a
solver mesh (ops/routed_sharded.py) and every vector lies whole on the
process's home device, so the solvers run unchanged; only A x and A' y
cross devices. (The JAX package shards every vector as well and leaves
the collectives to GSPMD.)

Padding (`pad_problem`, also used by batch.solve_batch) adds
fixed-at-zero variables (l = u = 0, c = 0, zero columns of A and of Q)
and always-satisfied trailing inequality rows (all-zero coefficients,
rhs 0). Both are exact no-ops for every quantity the solver computes
(residuals, norms, restarts, trust regions), so a padded solve gives
the same iterates.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..problem import QuadraticProgrammingProblem
from ..saddle_point import SaddlePointOutput


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_problem(
    problem: QuadraticProgrammingProblem,
    row_multiple: int,
    col_multiple: int,
) -> Tuple[QuadraticProgrammingProblem, int, int]:
    """Pads to (m', n'), the smallest multiples of `row_multiple` and
    `col_multiple` that hold (m, n) (at least one multiple each).
    Returns the padded problem and the original (m, n) for slicing
    results back."""
    m, n = problem.constraint_matrix.shape
    new_m = max(_round_up(m, row_multiple), row_multiple)
    new_n = max(_round_up(n, col_multiple), col_multiple)
    if (new_m, new_n) == (m, n):
        return copy.deepcopy(problem), m, n

    a = sp.csc_matrix(problem.constraint_matrix)
    a = sp.csc_matrix(
        sp.vstack(
            [
                sp.hstack([a, sp.csc_matrix((m, new_n - n))]),
                sp.csc_matrix((new_m - m, new_n)),
            ]
        )
    )
    q = sp.csc_matrix(problem.objective_matrix)
    q = sp.csc_matrix(
        sp.vstack(
            [
                sp.hstack([q, sp.csc_matrix((n, new_n - n))]),
                sp.csc_matrix((new_n - n, new_n)),
            ]
        )
    )
    padded = QuadraticProgrammingProblem(
        variable_lower_bound=np.concatenate(
            [problem.variable_lower_bound, np.zeros(new_n - n)]
        ),
        variable_upper_bound=np.concatenate(
            [problem.variable_upper_bound, np.zeros(new_n - n)]
        ),
        objective_matrix=q,
        objective_vector=np.concatenate(
            [problem.objective_vector, np.zeros(new_n - n)]
        ),
        objective_constant=problem.objective_constant,
        constraint_matrix=a,
        right_hand_side=np.concatenate(
            [problem.right_hand_side, np.zeros(new_m - m)]
        ),
        num_equalities=problem.num_equalities,
    )
    return padded, m, n


def _operator(obj) -> bool:
    from ..ops.linops import CsrOp, DenseOp
    from ..ops.routed import RoutedOp
    from ..ops.routed_sharded import ShardedRoutedOp

    return isinstance(obj, (CsrOp, DenseOp, RoutedOp, ShardedRoutedOp))


def _to_device(obj, device: torch.device):
    """`obj` with every tensor it holds moved to `device`, through
    dataclasses and named tuples; operators stay where they were
    built."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if _operator(obj):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, device) for v in obj))
    return obj


def make_placement(mesh):
    """A placement hook for optimize(): puts every vector and scalar of
    the device bundle and of the solver state whole on the mesh's home
    device. The constraint operator's blocks stay on their cells'
    devices, where build_sharded_routed_op put them."""
    home = mesh.home_device

    def placement(bundle, state):
        return _to_device(bundle, home), _to_device(state, home)

    return placement


def sharded_optimize(params, problem: QuadraticProgrammingProblem,
                     mesh) -> SaddlePointOutput:
    """Multi-device solve: pads the problem to the mesh, builds the
    constraint operator as a (D, P) grid of blocks over it
    (ops/routed_sharded.py) in the layout build_linop chooses on the
    whole matrix (the f32 kernel operator, B2 or B5 per block, for
    matrix_format="routed", or "auto" with an f32 solve and
    nnz >= ROUTED_NNZ_THRESHOLD on a CUDA home device), runs the
    solver's own loop with every vector on the home device, and returns
    the solution cut back to the problem's own m rows and n columns."""
    from ..models import api
    from ..ops.routed_sharded import plan_routed_shards

    if params.matrix_format == "routed" and params.dtype != "float32":
        raise ValueError(
            "matrix_format='routed' requires dtype='float32' "
            "(the kernel operator computes in f32)"
        )
    plan = plan_routed_shards(
        problem.num_constraints, problem.num_variables,
        problem.constraint_matrix.nnz, mesh,
    )
    padded, m, n = pad_problem(problem, plan.row_multiple, plan.col_multiple)
    output = api.optimize(params, padded, _placement=make_placement(mesh),
                          _shard_plan=plan)
    return SaddlePointOutput(
        primal_solution=np.asarray(output.primal_solution)[:n],
        dual_solution=np.asarray(output.dual_solution)[:m],
        termination_reason=output.termination_reason,
        termination_string=output.termination_string,
        iteration_count=output.iteration_count,
        iteration_stats=output.iteration_stats,
    )
