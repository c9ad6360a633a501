"""The benchmark's own form of a linear program: plain NumPy and SciPy
arrays, handed alike to the program (through its problem constructor)
and to the reference."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Lp:
    """min c'x + const  s.t.  A x = b (the first `num_equalities`
    rows), A x >= b (the rest), lb <= x <= ub."""

    constraint_matrix: sp.csr_matrix  # f64, sorted indices, no duplicates
    right_hand_side: np.ndarray
    objective_vector: np.ndarray
    variable_lower_bound: np.ndarray
    variable_upper_bound: np.ndarray
    objective_constant: float
    num_equalities: int

    @property
    def shape(self):
        return self.constraint_matrix.shape
