"""Relative KKT residuals of an answer (x, y) on the original LP,
recomputed in f64: the solver's own definitions (FirstOrderLp.jl's
termination criteria in the l2 norm), so that an answer the program
calls OPTIMAL at tolerance eps reads at most eps on each of the three:

    ||primal violation||_2 / (1 + ||b||_2)
    ||dual violation||_2 / (1 + ||c||_2)
    |primal obj - dual obj| / (1 + |primal obj| + |dual obj|)

(eps_optimal_absolute = eps_optimal_relative = eps makes
eps_abs + eps_rel ||v|| the same test as ||.|| / (1 + ||v||) <= eps.)
"""

from __future__ import annotations

import numpy as np

from ..lp import Lp


def _norm(v: np.ndarray) -> float:
    return float(np.sqrt(np.sum(v * v)))


def residuals(lp: Lp, x: np.ndarray, y: np.ndarray) -> dict:
    a = lp.constraint_matrix
    b, c = lp.right_hand_side, lp.objective_vector
    lb, ub = lp.variable_lower_bound, lp.variable_upper_bound
    meq = lp.num_equalities
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ax = a @ x
    viol = np.concatenate([
        (b - ax)[:meq],
        np.maximum(b - ax, 0.0)[meq:],
        np.maximum(lb - x, 0.0),
        np.maximum(x - ub, 0.0),
    ])
    g = c - a.T @ y
    bound = np.where(g > 0.0, lb, ub)
    rc = np.where(np.isfinite(bound), g, 0.0)
    dual_viol = np.concatenate([np.maximum(-y[meq:], 0.0), g - rc])
    primal_obj = lp.objective_constant + float(np.sum(c * x))
    active = rc != 0.0
    dual_obj = (float(np.sum(b * y)) + lp.objective_constant
                + float(np.sum(np.where(active, bound, 0.0) * rc)))
    return {
        "rel_primal_residual": _norm(viol) / (1.0 + _norm(b)),
        "rel_dual_residual": _norm(dual_viol) / (1.0 + _norm(c)),
        "rel_gap": abs(primal_obj - dual_obj)
        / (1.0 + abs(primal_obj) + abs(dual_obj)),
    }
