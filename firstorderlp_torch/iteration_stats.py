"""Iteration statistics: residuals, objectives, infeasibility certificates.

Device-side functions returning namedtuples of torch tensors (always
computed on the unscaled original problem). Every reduction is over dim
0, so a vector (dim,) gives 0-d results and a fleet's lanes (dim, B),
with per-lane bounds, objective constant and norm cache, give (B,)
results (batch.py);
plus host-side conversion to solve_log.IterationStats and the console
display table.

Reference semantics: src/iteration_stats_utils.jl.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .saddle_point import compute_primal_gradient_from_dual_product
from .solve_log import (
    ConvergenceInformation,
    InfeasibilityInformation,
    IterationStats,
    PointType,
    RestartChoice,
)


class DeviceConvergenceInfo(NamedTuple):
    primal_objective: torch.Tensor
    dual_objective: torch.Tensor
    corrected_dual_objective: torch.Tensor
    l_inf_primal_residual: torch.Tensor
    l2_primal_residual: torch.Tensor
    l_inf_dual_residual: torch.Tensor
    l2_dual_residual: torch.Tensor
    relative_l_inf_primal_residual: torch.Tensor
    relative_l2_primal_residual: torch.Tensor
    relative_l_inf_dual_residual: torch.Tensor
    relative_l2_dual_residual: torch.Tensor
    relative_optimality_gap: torch.Tensor
    l_inf_primal_variable: torch.Tensor
    l2_primal_variable: torch.Tensor
    l_inf_dual_variable: torch.Tensor
    l2_dual_variable: torch.Tensor


class DeviceInfeasibilityInfo(NamedTuple):
    max_primal_ray_infeasibility: torch.Tensor
    primal_ray_linear_objective: torch.Tensor
    primal_ray_quadratic_norm: torch.Tensor
    max_dual_ray_infeasibility: torch.Tensor
    dual_ray_objective: torch.Tensor


def _linf(x):
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    return torch.amax(torch.abs(x), dim=0)


def _l2sq(x):
    return torch.sum(x * x, dim=0)


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


def primal_residual_norms(problem, primal, right_hand_side=None):
    """Norms of the primal residual vector [eq viol; ineq viol; bound viol].

    Reference: compute_primal_residual (src/iteration_stats_utils.jl:24-63).
    """
    b = (
        problem.right_hand_side
        if right_hand_side is None
        else right_hand_side
    )
    activities = problem.ax(primal)
    eq_violation = torch.where(problem.is_equality, b - activities, 0.0)
    ineq_violation = torch.where(
        problem.is_equality, 0.0, torch.clamp_min(b - activities, 0.0)
    )
    lower_violation = torch.clamp_min(
        problem.variable_lower_bound - primal, 0.0
    )
    upper_violation = torch.clamp_min(
        primal - problem.variable_upper_bound, 0.0
    )
    linf = torch.maximum(
        torch.maximum(_linf(eq_violation), _linf(ineq_violation)),
        torch.maximum(_linf(lower_violation), _linf(upper_violation)),
    )
    l2 = torch.sqrt(
        _l2sq(eq_violation)
        + _l2sq(ineq_violation)
        + _l2sq(lower_violation)
        + _l2sq(upper_violation)
    )
    return linf, l2


class DualStats(NamedTuple):
    dual_objective: torch.Tensor
    l_inf_dual_residual: torch.Tensor
    l2_dual_residual: torch.Tensor
    l_inf_reduced_costs: torch.Tensor


def reduced_costs_from_primal_gradient(lb, ub, primal_gradient):
    """Reference: src/iteration_stats_utils.jl:119-147.

    rc_i = pg_i if the bound the gradient sign points to is finite, else 0.
    """
    bound = torch.where(primal_gradient > 0.0, lb, ub)
    return torch.where(torch.isfinite(bound), primal_gradient, 0.0)


def reduced_costs_dual_objective_contribution(lb, ub, reduced_costs):
    """Reference: src/iteration_stats_utils.jl:84-117. -inf if any needed
    bound is infinite."""
    bound = torch.where(reduced_costs > 0.0, lb, ub)
    active = reduced_costs != 0.0
    needs_infinite = active & ~torch.isfinite(bound)
    safe_bound = torch.where(active & torch.isfinite(bound), bound, 0.0)
    contribution = torch.sum(
        safe_bound * torch.where(active, reduced_costs, 0.0), dim=0
    )
    return torch.where(
        torch.any(needs_infinite, dim=0), -torch.inf, contribution
    )


def compute_dual_stats(
    problem,
    primal,
    dual,
    primal_gradient,
    qx_dot_x,
    right_hand_side=None,
    objective_constant=None,
) -> DualStats:
    """Dual objective (objective linearized at `primal`) and residuals.

    Reference: src/iteration_stats_utils.jl:149-197. `primal_gradient` is
    Qx + c - A'y for the (possibly homogeneous) problem being measured and
    qx_dot_x = x'Qx for it.
    """
    b = (
        problem.right_hand_side
        if right_hand_side is None
        else right_hand_side
    )
    const = (
        problem.objective_constant
        if objective_constant is None
        else objective_constant
    )
    rc = reduced_costs_from_primal_gradient(
        problem.variable_lower_bound, problem.variable_upper_bound,
        primal_gradient,
    )
    dual_sign_violation = torch.where(
        problem.is_equality, 0.0, torch.clamp_min(-dual, 0.0)
    )
    rc_violation = primal_gradient - rc
    linf = torch.maximum(_linf(dual_sign_violation), _linf(rc_violation))
    l2 = torch.sqrt(_l2sq(dual_sign_violation) + _l2sq(rc_violation))

    base_dual_objective = torch.sum(b * dual, dim=0) + const - 0.5 * qx_dot_x
    dual_objective = (
        base_dual_objective
        + reduced_costs_dual_objective_contribution(
            problem.variable_lower_bound, problem.variable_upper_bound, rc
        )
    )
    return DualStats(
        dual_objective=dual_objective,
        l_inf_dual_residual=linf,
        l2_dual_residual=l2,
        l_inf_reduced_costs=_linf(rc),
    )


def compute_convergence_information(
    problem, qp_cache, primal, dual, eps_ratio
) -> DeviceConvergenceInfo:
    """Reference: src/iteration_stats_utils.jl:224-280."""
    linf_pr, l2_pr = primal_residual_norms(problem, primal)
    qx = problem.qx(primal)
    primal_objective = (
        problem.objective_constant
        + torch.sum(problem.objective_vector * primal, dim=0)
        + 0.5 * torch.sum(primal * qx, dim=0)
    )
    primal_gradient = compute_primal_gradient_from_dual_product(
        problem, primal, problem.aty(dual), qx
    )
    dual_stats = compute_dual_stats(
        problem, primal, dual, primal_gradient, torch.sum(primal * qx, dim=0)
    )
    corrected_dual_objective = torch.where(
        dual_stats.l_inf_dual_residual == 0.0,
        dual_stats.dual_objective,
        -torch.inf,
    )
    gap = torch.abs(primal_objective - dual_stats.dual_objective)
    abs_obj = torch.abs(primal_objective) + torch.abs(
        dual_stats.dual_objective
    )
    return DeviceConvergenceInfo(
        primal_objective=primal_objective,
        dual_objective=dual_stats.dual_objective,
        corrected_dual_objective=corrected_dual_objective,
        l_inf_primal_residual=linf_pr,
        l2_primal_residual=l2_pr,
        l_inf_dual_residual=dual_stats.l_inf_dual_residual,
        l2_dual_residual=dual_stats.l2_dual_residual,
        relative_l_inf_primal_residual=linf_pr
        / (eps_ratio + qp_cache.l_inf_norm_primal_right_hand_side),
        relative_l2_primal_residual=l2_pr
        / (eps_ratio + qp_cache.l2_norm_primal_right_hand_side),
        relative_l_inf_dual_residual=dual_stats.l_inf_dual_residual
        / (eps_ratio + qp_cache.l_inf_norm_primal_linear_objective),
        relative_l2_dual_residual=dual_stats.l2_dual_residual
        / (eps_ratio + qp_cache.l2_norm_primal_linear_objective),
        relative_optimality_gap=gap / (eps_ratio + abs_obj),
        l_inf_primal_variable=_linf(primal),
        l2_primal_variable=torch.sqrt(_l2sq(primal)),
        l_inf_dual_variable=_linf(dual),
        l2_dual_variable=torch.sqrt(_l2sq(dual)),
    )


def compute_infeasibility_information(
    problem, primal_ray_estimate, dual_ray_estimate
) -> DeviceInfeasibilityInfo:
    """Certificates on the homogeneous problems.

    Reference: src/iteration_stats_utils.jl:282-349.
    """
    primal_ray_norm = _linf(primal_ray_estimate)
    primal_ray = torch.where(
        primal_ray_norm == 0.0,
        primal_ray_estimate,
        primal_ray_estimate
        / torch.where(primal_ray_norm == 0, 1.0, primal_ray_norm),
    )

    # Homogeneous primal: finite bounds -> 0, rhs -> 0, objective dropped.
    hom_lb = torch.where(
        torch.isfinite(problem.variable_lower_bound), 0.0, -torch.inf
    ).to(primal_ray.dtype)
    hom_ub = torch.where(
        torch.isfinite(problem.variable_upper_bound), 0.0, torch.inf
    ).to(primal_ray.dtype)
    activities = problem.ax(primal_ray)
    eq_violation = torch.where(problem.is_equality, -activities, 0.0)
    ineq_violation = torch.where(
        problem.is_equality, 0.0, torch.clamp_min(-activities, 0.0)
    )
    lower_violation = torch.clamp_min(hom_lb - primal_ray, 0.0)
    upper_violation = torch.clamp_min(primal_ray - hom_ub, 0.0)
    max_primal_ray_infeasibility = torch.maximum(
        torch.maximum(_linf(eq_violation), _linf(ineq_violation)),
        torch.maximum(_linf(lower_violation), _linf(upper_violation)),
    )
    primal_ray_linear_objective = torch.sum(
        problem.objective_vector * primal_ray, dim=0
    )
    primal_ray_quadratic_norm = _linf(problem.qx(primal_ray))

    # Homogeneous dual: objective (linear + quadratic) set to zero; original
    # bounds and rhs kept.
    hom_primal_gradient = -problem.aty(dual_ray_estimate)
    zero = _zero(primal_ray_estimate)
    hom_dual_stats = compute_dual_stats(
        problem,
        primal_ray_estimate,
        dual_ray_estimate,
        hom_primal_gradient,
        zero,
        objective_constant=zero,
    )
    scaling_factor = torch.maximum(
        _linf(dual_ray_estimate), hom_dual_stats.l_inf_reduced_costs
    )
    safe_scale = torch.where(scaling_factor == 0, 1.0, scaling_factor)
    linf_dual_res = torch.sqrt(
        hom_dual_stats.l_inf_dual_residual**2
    )  # already linf
    max_dual_ray_infeasibility = torch.where(
        scaling_factor == 0.0, 0.0, linf_dual_res / safe_scale
    )
    dual_ray_objective = torch.where(
        scaling_factor == 0.0, 0.0, hom_dual_stats.dual_objective / safe_scale
    )
    return DeviceInfeasibilityInfo(
        max_primal_ray_infeasibility=max_primal_ray_infeasibility,
        primal_ray_linear_objective=primal_ray_linear_objective,
        primal_ray_quadratic_norm=primal_ray_quadratic_norm,
        max_dual_ray_infeasibility=max_dual_ray_infeasibility,
        dual_ray_objective=dual_ray_objective,
    )


# ---------------------------------------------------------------------------
# Host assembly and display
# ---------------------------------------------------------------------------


def to_host_stats(
    conv: DeviceConvergenceInfo,
    infeas: DeviceInfeasibilityInfo,
    iteration_number: int,
    cumulative_kkt_matrix_passes: float,
    cumulative_time_sec: float,
    restart_used: RestartChoice,
    step_size: float,
    primal_weight: float,
    method_specific_stats,
    candidate_type: PointType = PointType.POINT_TYPE_AVERAGE_ITERATE,
) -> IterationStats:
    conv_host = ConvergenceInformation(
        candidate_type=candidate_type,
        **{k: float(v) for k, v in conv._asdict().items()},
    )
    infeas_host = InfeasibilityInformation(
        candidate_type=candidate_type,
        **{k: float(v) for k, v in infeas._asdict().items()},
    )
    return IterationStats(
        iteration_number=int(iteration_number),
        convergence_information=[conv_host],
        infeasibility_information=[infeas_host],
        cumulative_kkt_matrix_passes=float(cumulative_kkt_matrix_passes),
        cumulative_rejected_steps=0,
        cumulative_time_sec=float(cumulative_time_sec),
        restart_used=restart_used,
        step_size=float(step_size),
        primal_weight=float(primal_weight),
        method_specific_stats=dict(method_specific_stats),
    )


def print_to_screen_this_iteration(
    termination_reason, iteration, verbosity, termination_evaluation_frequency
) -> bool:
    """Display-frequency schedule (reference l.453-490)."""
    if verbosity < 2:
        return False
    if termination_reason is not False and termination_reason is not None:
        return True
    num_of_evaluations = (iteration - 1) / termination_evaluation_frequency
    if verbosity >= 9:
        display_frequency = 1
    elif verbosity >= 6:
        display_frequency = 3
    elif verbosity >= 5:
        display_frequency = 10
    elif verbosity >= 4:
        display_frequency = 20
    elif verbosity >= 3:
        display_frequency = 50
    else:
        return iteration == 1
    return num_of_evaluations % display_frequency == 0


def display_iteration_stats_heading(verbosity: int) -> None:
    if verbosity >= 7:
        _display_heading(True)
    elif verbosity >= 2:
        _display_heading(False)


def _display_heading(show_infeasibility: bool) -> None:
    line = (
        f"{'runtime':<24} | {'residuals':<26} | "
        f"{' solution information':<26} | {'relative residuals':<23} |"
    )
    if show_infeasibility:
        line += f" {'primal ray':<27} | {'dual ray':<18} |"
    print(line)
    line = (
        f"{'#iter':<7} {'#kkt':<8} {'seconds':<7} | "
        f"{'pr norm':<8} {'du norm':<8}  {'gap':<7} | "
        f"{' pr obj':<9} {'pr norm':<8} {'du norm':<7} | "
        f"{'rel pr':<7} {'rel du':<7} {'rel gap':<7} |"
    )
    if show_infeasibility:
        line += (
            f" {'pr norm':<9} {'linear':<8} {'qu norm':<8} | "
            f"{'du norm':<9} {'dual obj':<8} |"
        )
    print(line)


def _lpad_float(number: float) -> str:
    return f"{number:.1e}".rjust(8)


def display_iteration_stats(stats: IterationStats, verbosity: int) -> None:
    show_infeasibility = verbosity >= 7
    ci = stats.convergence_information[0]
    line = (
        f"{str(stats.iteration_number):<6}  "
        f"{stats.cumulative_kkt_matrix_passes:.1e}  "
        f"{stats.cumulative_time_sec:.1e} | "
        f"{ci.l2_primal_residual:.1e}  {ci.l2_dual_residual:.1e}  "
        f"{_lpad_float(ci.primal_objective - ci.dual_objective)} | "
        f"{_lpad_float(ci.primal_objective)}  "
        f"{ci.l2_primal_variable:.1e}  {ci.l2_dual_variable:.1e} | "
        f"{ci.relative_l2_primal_residual:.1e} "
        f"{ci.relative_l2_dual_residual:.1e} "
        f"{ci.relative_optimality_gap:.1e} |"
    )
    if show_infeasibility and stats.infeasibility_information:
        ii = stats.infeasibility_information[0]
        line += (
            f" {ii.max_primal_ray_infeasibility:.1e}  "
            f"{_lpad_float(ii.primal_ray_linear_objective)}  "
            f"{ii.primal_ray_quadratic_norm:.1e}  | "
            f"{ii.max_dual_ray_infeasibility:.1e}  "
            f"{_lpad_float(ii.dual_ray_objective)}  |"
        )
    print(line)
