"""Problem padding, the part of the JAX package's parallel/sharded.py
(firstorderlp_tpu/parallel/sharded.py:32-84) that heterogeneous fleets
need: batch.solve_batch pads every instance to the fleet's largest
(m, n).

Padding adds fixed-at-zero variables (l = u = 0, c = 0, zero columns of
A and of Q) and always-satisfied trailing inequality rows (all-zero
coefficients, rhs 0). Both are exact no-ops for every quantity the
solver computes (residuals, norms, restarts, trust regions), so a padded
solve gives the same iterates.

The rest of that module (meshes, placements, sharded_optimize) waits for
the port of the multi-device path (A14 in ROADMAP.md).
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..problem import QuadraticProgrammingProblem


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
