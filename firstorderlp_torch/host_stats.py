"""Host-side (numpy/scipy, strict float64) convergence and infeasibility
statistics on the ORIGINAL problem.

Numerically identical counterpart of the device functions in
iteration_stats.py (reference: src/iteration_stats_utils.jl:24-349).
The refinement loop certifies iterates that are already numpy arrays
on the host, a handful of times per solve: a scipy product plus numpy
reductions there is natively f64 and needs no transfer. Copied from the
JAX package's host_stats.py, which is numpy/scipy only.

Functions take the host QuadraticProgrammingProblem (scipy matrices)
directly and return the SAME namedtuples the device paths produce
(fields as python/numpy float64 scalars), so downstream consumers
(termination checks, to_host_stats) are shared.
"""

from __future__ import annotations

import numpy as np

from .iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
)
from .termination import (
    CachedQuadraticProgramInfo,
    OptimalityNorm,
)


def _linf(x):
    return float(np.max(np.abs(x), initial=0.0))


def _l2sq(x):
    return float(np.sum(np.asarray(x, np.float64) ** 2))


def _is_equality(problem):
    m = problem.constraint_matrix.shape[0]
    return np.arange(m) < problem.num_equalities


def host_primal_residual_norms(problem, primal):
    """Port of iteration_stats.primal_residual_norms (reference
    src/iteration_stats_utils.jl:24-63)."""
    b = np.asarray(problem.right_hand_side, np.float64)
    activities = problem.constraint_matrix @ primal
    is_eq = _is_equality(problem)
    eq_violation = np.where(is_eq, b - activities, 0.0)
    ineq_violation = np.where(
        is_eq, 0.0, np.maximum(b - activities, 0.0)
    )
    lower_violation = np.maximum(
        np.asarray(problem.variable_lower_bound, np.float64) - primal, 0.0
    )
    upper_violation = np.maximum(
        primal - np.asarray(problem.variable_upper_bound, np.float64), 0.0
    )
    linf = max(
        _linf(eq_violation), _linf(ineq_violation),
        _linf(lower_violation), _linf(upper_violation),
    )
    l2 = float(
        np.sqrt(
            _l2sq(eq_violation)
            + _l2sq(ineq_violation)
            + _l2sq(lower_violation)
            + _l2sq(upper_violation)
        )
    )
    return linf, l2


def _reduced_costs(lb, ub, primal_gradient):
    """Port of reduced_costs_from_primal_gradient (reference
    src/iteration_stats_utils.jl:119-147)."""
    bound = np.where(primal_gradient > 0.0, lb, ub)
    return np.where(np.isfinite(bound), primal_gradient, 0.0)


def _reduced_costs_dual_contribution(lb, ub, rc):
    """Port of reduced_costs_dual_objective_contribution (reference
    src/iteration_stats_utils.jl:84-117)."""
    bound = np.where(rc > 0.0, lb, ub)
    active = rc != 0.0
    if np.any(active & ~np.isfinite(bound)):
        return -np.inf
    safe_bound = np.where(active & np.isfinite(bound), bound, 0.0)
    return float(np.sum(safe_bound * np.where(active, rc, 0.0)))


def _host_dual_stats(problem, dual, primal_gradient, qx_dot_x,
                     objective_constant=None):
    """Port of compute_dual_stats (reference l.149-197). Returns
    (dual_objective, linf_dual_residual, l2_dual_residual,
    linf_reduced_costs)."""
    b = np.asarray(problem.right_hand_side, np.float64)
    const = (
        float(problem.objective_constant)
        if objective_constant is None
        else objective_constant
    )
    lb = np.asarray(problem.variable_lower_bound, np.float64)
    ub = np.asarray(problem.variable_upper_bound, np.float64)
    rc = _reduced_costs(lb, ub, primal_gradient)
    dual_sign_violation = np.where(
        _is_equality(problem), 0.0, np.maximum(-dual, 0.0)
    )
    rc_violation = primal_gradient - rc
    linf = max(_linf(dual_sign_violation), _linf(rc_violation))
    l2 = float(np.sqrt(_l2sq(dual_sign_violation) + _l2sq(rc_violation)))
    dual_objective = (
        float(np.sum(b * dual)) + const - 0.5 * qx_dot_x
        + _reduced_costs_dual_contribution(lb, ub, rc)
    )
    return dual_objective, linf, l2, _linf(rc)


def host_convergence_information(
    problem, primal, dual, eps_ratio
) -> DeviceConvergenceInfo:
    """Port of compute_convergence_information (reference l.224-280),
    strict f64 on host."""
    x = np.asarray(primal, np.float64)
    y = np.asarray(dual, np.float64)
    cache = host_qp_cache(problem)
    linf_pr, l2_pr = host_primal_residual_norms(problem, x)
    qx = problem.objective_matrix @ x
    c = np.asarray(problem.objective_vector, np.float64)
    qx_dot_x = float(np.sum(x * qx))
    primal_objective = (
        float(problem.objective_constant) + float(np.sum(c * x))
        + 0.5 * qx_dot_x
    )
    primal_gradient = qx + c - problem.constraint_matrix.T @ y
    dual_objective, linf_dr, l2_dr, _ = _host_dual_stats(
        problem, y, primal_gradient, qx_dot_x
    )
    corrected_dual_objective = (
        dual_objective if linf_dr == 0.0 else -np.inf
    )
    gap = abs(primal_objective - dual_objective)
    abs_obj = abs(primal_objective) + abs(dual_objective)
    return DeviceConvergenceInfo(
        primal_objective=primal_objective,
        dual_objective=dual_objective,
        corrected_dual_objective=corrected_dual_objective,
        l_inf_primal_residual=linf_pr,
        l2_primal_residual=l2_pr,
        l_inf_dual_residual=linf_dr,
        l2_dual_residual=l2_dr,
        relative_l_inf_primal_residual=linf_pr
        / (eps_ratio + cache.l_inf_norm_primal_right_hand_side),
        relative_l2_primal_residual=l2_pr
        / (eps_ratio + cache.l2_norm_primal_right_hand_side),
        relative_l_inf_dual_residual=linf_dr
        / (eps_ratio + cache.l_inf_norm_primal_linear_objective),
        relative_l2_dual_residual=l2_dr
        / (eps_ratio + cache.l2_norm_primal_linear_objective),
        relative_optimality_gap=gap / (eps_ratio + abs_obj),
        l_inf_primal_variable=_linf(x),
        l2_primal_variable=float(np.sqrt(_l2sq(x))),
        l_inf_dual_variable=_linf(y),
        l2_dual_variable=float(np.sqrt(_l2sq(y))),
    )


def host_infeasibility_information(
    problem, primal_ray_estimate, dual_ray_estimate
) -> DeviceInfeasibilityInfo:
    """Port of compute_infeasibility_information (reference l.282-349),
    strict f64 on host."""
    xr = np.asarray(primal_ray_estimate, np.float64)
    yr = np.asarray(dual_ray_estimate, np.float64)
    lb = np.asarray(problem.variable_lower_bound, np.float64)
    ub = np.asarray(problem.variable_upper_bound, np.float64)
    is_eq = _is_equality(problem)

    primal_ray_norm = _linf(xr)
    primal_ray = xr if primal_ray_norm == 0.0 else xr / primal_ray_norm

    hom_lb = np.where(np.isfinite(lb), 0.0, -np.inf)
    hom_ub = np.where(np.isfinite(ub), 0.0, np.inf)
    activities = problem.constraint_matrix @ primal_ray
    eq_violation = np.where(is_eq, -activities, 0.0)
    ineq_violation = np.where(is_eq, 0.0, np.maximum(-activities, 0.0))
    lower_violation = np.maximum(hom_lb - primal_ray, 0.0)
    upper_violation = np.maximum(primal_ray - hom_ub, 0.0)
    max_primal_ray_infeasibility = max(
        _linf(eq_violation), _linf(ineq_violation),
        _linf(lower_violation), _linf(upper_violation),
    )
    c = np.asarray(problem.objective_vector, np.float64)
    primal_ray_linear_objective = float(np.sum(c * primal_ray))
    primal_ray_quadratic_norm = _linf(problem.objective_matrix @ primal_ray)

    hom_primal_gradient = -(problem.constraint_matrix.T @ yr)
    dual_objective, linf_dr, _, linf_rc = _host_dual_stats(
        problem, yr, hom_primal_gradient, 0.0, objective_constant=0.0
    )
    scaling_factor = max(_linf(yr), linf_rc)
    if scaling_factor == 0.0:
        max_dual_ray_infeasibility = 0.0
        dual_ray_objective = 0.0
    else:
        max_dual_ray_infeasibility = linf_dr / scaling_factor
        dual_ray_objective = dual_objective / scaling_factor
    return DeviceInfeasibilityInfo(
        max_primal_ray_infeasibility=max_primal_ray_infeasibility,
        primal_ray_linear_objective=primal_ray_linear_objective,
        primal_ray_quadratic_norm=primal_ray_quadratic_norm,
        max_dual_ray_infeasibility=max_dual_ray_infeasibility,
        dual_ray_objective=dual_ray_objective,
    )


def host_qp_cache(problem) -> CachedQuadraticProgramInfo:
    from .termination import cached_quadratic_program_info

    return cached_quadratic_program_info(problem)


def host_optimality_met(criteria, conv, cache) -> bool:
    """Port of termination.optimality_criteria_met (reference
    src/termination.jl:160-193) on host scalars."""
    abs_tol = criteria.eps_optimal_absolute
    rel_tol = criteria.eps_optimal_relative
    abs_obj = abs(conv.primal_objective) + abs(conv.dual_objective)
    gap = abs(conv.primal_objective - conv.dual_objective)
    if criteria.optimality_norm == OptimalityNorm.L_INF:
        primal_err = conv.l_inf_primal_residual
        primal_err_baseline = cache.l_inf_norm_primal_right_hand_side
        dual_err = conv.l_inf_dual_residual
        dual_err_baseline = cache.l_inf_norm_primal_linear_objective
    else:
        primal_err = conv.l2_primal_residual
        primal_err_baseline = cache.l2_norm_primal_right_hand_side
        dual_err = conv.l2_dual_residual
        dual_err_baseline = cache.l2_norm_primal_linear_objective
    return bool(
        (dual_err < abs_tol + rel_tol * dual_err_baseline)
        and (primal_err < abs_tol + rel_tol * primal_err_baseline)
        and (gap < abs_tol + rel_tol * abs_obj)
    )
