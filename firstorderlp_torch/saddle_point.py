"""Shared saddle-point runtime: projections, iterate averaging, restart
schemes and primal-weight balancing.

Reference semantics: src/saddle_point.jl. Every value is a tensor on
the solve's device: vectors, floating scalars, and the counters and
flags (average counts, restart lengths, `has_gap`) as 0-d tensors. The
restart decision is a device select, as in the JAX package, so an
evaluation reads nothing back.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, NamedTuple

import numpy as np
import torch

from .solve_log import (
    IterationStats,
    RestartChoice,
    TerminationReason,
    termination_reason_to_string,
)
from .trust_region import (
    ObjectiveBound,
    bound_optimal_objective,
    bound_optimal_objective_euclidean_batched,
)


@dataclasses.dataclass
class SaddlePointOutput:
    """Reference: src/saddle_point.jl:18-53."""

    primal_solution: np.ndarray
    dual_solution: np.ndarray
    termination_reason: TerminationReason
    termination_string: str
    iteration_count: int
    iteration_stats: List[IterationStats]


def fetch_global(x: torch.Tensor, mesh=None) -> np.ndarray:
    """The global value of `x` as a host array (reference
    saddle_point.py:51-66, which all-gathers a cross-process-sharded
    jax.Array).

    The port keeps vectors whole on each process's home device, so with
    no `mesh`, or a single-process mesh, `x` is the whole value and this
    is a host copy. Under a process group (`mesh.rank` set) `x` is this
    rank's piece of a row-blocked vector, for example its row block's
    constraint scaling: the pieces are gathered with
    parallel.distributed.gather_in_rank_order and concatenated in rank
    order, the pieces of ranks (d, 0) only on a 2-D mesh (ranks (d, p)
    hold the same row block)."""
    if mesh is None or mesh.rank is None:
        return x.detach().cpu().numpy()
    from .parallel.distributed import concat_row_blocks

    return concat_row_blocks({mesh.rank // mesh.n_primal: x},
                             mesh).cpu().numpy()


def unscaled_saddle_point_output(
    scaled_problem,
    primal_solution,
    dual_solution,
    termination_reason: TerminationReason,
    iterations_completed: int,
    iteration_stats: List[IterationStats],
) -> SaddlePointOutput:
    """Unscales the iterates on the host (reference l.55-77)."""
    original_primal = primal_solution.cpu().numpy() / np.asarray(
        scaled_problem.variable_rescaling
    )
    original_dual = dual_solution.cpu().numpy() / np.asarray(
        scaled_problem.constraint_rescaling
    )
    return SaddlePointOutput(
        primal_solution=original_primal,
        dual_solution=original_dual,
        termination_reason=termination_reason,
        termination_string=termination_reason_to_string(termination_reason),
        iteration_count=iterations_completed,
        iteration_stats=iteration_stats,
    )


# ---------------------------------------------------------------------------
# Projections and norms
# ---------------------------------------------------------------------------


def project_primal(primal, problem):
    """Clamp onto variable bounds (reference l.79-106)."""
    return torch.clamp(
        primal, problem.variable_lower_bound, problem.variable_upper_bound
    )


def project_dual(dual, problem):
    """Inequality duals clamped to >= 0 (reference l.108-117)."""
    return torch.where(problem.is_equality, dual, torch.clamp_min(dual, 0.0))


def weighted_norm(vec, weights):
    """sqrt(sum_i w_i v_i^2) (reference l.119-129), over dim 0: per lane
    for a fleet's (dim, B) vectors."""
    return torch.sqrt(torch.sum(weights * vec * vec, dim=0))


# ---------------------------------------------------------------------------
# Weighted average of iterates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolutionWeightedAverage:
    """Reference: src/saddle_point.jl:215-301."""

    sum_primal_solutions: torch.Tensor
    sum_dual_solutions: torch.Tensor
    sum_primal_solutions_count: torch.Tensor  # 0-d int64
    sum_dual_solutions_count: torch.Tensor  # 0-d int64
    sum_primal_solution_weights: torch.Tensor  # 0-d
    sum_dual_solution_weights: torch.Tensor  # 0-d


def initialize_solution_weighted_average(
    primal_size: int, dual_size: int, dtype=torch.float64, device=None
) -> SolutionWeightedAverage:
    return SolutionWeightedAverage(
        sum_primal_solutions=torch.zeros(primal_size, dtype=dtype,
                                         device=device),
        sum_dual_solutions=torch.zeros(dual_size, dtype=dtype, device=device),
        sum_primal_solutions_count=torch.zeros((), dtype=torch.int64,
                                               device=device),
        sum_dual_solutions_count=torch.zeros((), dtype=torch.int64,
                                             device=device),
        sum_primal_solution_weights=torch.zeros((), dtype=dtype,
                                                device=device),
        sum_dual_solution_weights=torch.zeros((), dtype=dtype, device=device),
    )


def reset_solution_weighted_average(
    avg: SolutionWeightedAverage,
) -> SolutionWeightedAverage:
    """Every field zero, a fleet's per lane."""
    return SolutionWeightedAverage(*(
        torch.zeros_like(getattr(avg, f.name))
        for f in dataclasses.fields(SolutionWeightedAverage)
    ))


def add_to_primal_solution_weighted_average(
    avg: SolutionWeightedAverage, primal, weight
) -> SolutionWeightedAverage:
    return dataclasses.replace(
        avg,
        sum_primal_solutions=avg.sum_primal_solutions + primal * weight,
        sum_primal_solutions_count=avg.sum_primal_solutions_count + 1,
        sum_primal_solution_weights=avg.sum_primal_solution_weights + weight,
    )


def add_to_dual_solution_weighted_average(
    avg: SolutionWeightedAverage, dual, weight
) -> SolutionWeightedAverage:
    return dataclasses.replace(
        avg,
        sum_dual_solutions=avg.sum_dual_solutions + dual * weight,
        sum_dual_solutions_count=avg.sum_dual_solutions_count + 1,
        sum_dual_solution_weights=avg.sum_dual_solution_weights + weight,
    )


def add_to_solution_weighted_average(
    avg: SolutionWeightedAverage, primal, dual, weight
) -> SolutionWeightedAverage:
    avg = add_to_primal_solution_weighted_average(avg, primal, weight)
    avg = add_to_dual_solution_weighted_average(avg, dual, weight)
    return avg


def compute_average(avg: SolutionWeightedAverage):
    """(primal, dual) weighted averages (reference l.283-301). A fleet's
    (dim, B) sums divide by their (B,) weights. An empty average (weight
    0) gives zeros where the reference divides 0 by 0: the restart scheme
    and the evaluations read it only where it is not empty, and a NaN
    must not reach a fleet's batched trust-region solve."""
    return (
        avg.sum_primal_solutions / torch.where(
            avg.sum_primal_solution_weights > 0,
            avg.sum_primal_solution_weights, 1.0,
        ),
        avg.sum_dual_solutions / torch.where(
            avg.sum_dual_solution_weights > 0,
            avg.sum_dual_solution_weights, 1.0,
        ),
    )


# ---------------------------------------------------------------------------
# Restart schemes
# ---------------------------------------------------------------------------


class RestartScheme(enum.Enum):
    """Reference: src/saddle_point.jl:303-325."""

    NO_RESTARTS = "no_restarts"
    FIXED_FREQUENCY = "fixed_frequency"
    ADAPTIVE_NORMALIZED = "adaptive_normalized"
    ADAPTIVE_LOCALIZED = "adaptive_localized"
    ADAPTIVE_DISTANCE = "adaptive_distance"


class RestartToCurrentMetric(enum.Enum):
    """Reference: src/saddle_point.jl:327-340."""

    NO_RESTART_TO_CURRENT = "no_restart_to_current"
    GAP_OVER_DISTANCE = "gap_over_distance"
    GAP_OVER_DISTANCE_SQUARED = "gap_over_distance_squared"


@dataclasses.dataclass(frozen=True)
class RestartParameters:
    """Reference: src/saddle_point.jl:342-400 (static per solve)."""

    restart_scheme: RestartScheme
    restart_to_current_metric: RestartToCurrentMetric
    restart_frequency_if_fixed: int
    artificial_restart_threshold: float
    sufficient_reduction_for_restart: float
    necessary_reduction_for_restart: float
    primal_weight_update_smoothing: float
    use_approximate_localized_duality_gap: bool


def construct_restart_parameters(
    restart_scheme: RestartScheme,
    restart_to_current_metric: RestartToCurrentMetric,
    restart_frequency_if_fixed: int,
    artificial_restart_threshold: float,
    sufficient_reduction_for_restart: float,
    necessary_reduction_for_restart: float,
    primal_weight_update_smoothing: float,
    use_approximate_localized_duality_gap: bool,
) -> RestartParameters:
    """Validated constructor (reference l.402-430)."""
    assert restart_frequency_if_fixed > 1
    assert 0.0 < artificial_restart_threshold <= 1.0
    assert (
        0.0
        < sufficient_reduction_for_restart
        <= necessary_reduction_for_restart
        <= 1.0
    )
    assert 0.0 <= primal_weight_update_smoothing <= 1.0
    return RestartParameters(
        restart_scheme=restart_scheme,
        restart_to_current_metric=restart_to_current_metric,
        restart_frequency_if_fixed=restart_frequency_if_fixed,
        artificial_restart_threshold=artificial_restart_threshold,
        sufficient_reduction_for_restart=sufficient_reduction_for_restart,
        necessary_reduction_for_restart=necessary_reduction_for_restart,
        primal_weight_update_smoothing=primal_weight_update_smoothing,
        use_approximate_localized_duality_gap=(
            use_approximate_localized_duality_gap
        ),
    )


@dataclasses.dataclass(frozen=True)
class RestartInfo:
    """Reference: src/saddle_point.jl:158-213. The localized gap of the
    last restart is stored by value; has_gap says whether there was one."""

    primal_solution: torch.Tensor
    dual_solution: torch.Tensor
    has_gap: torch.Tensor  # 0-d bool
    gap: torch.Tensor  # 0-d
    last_restart_length: torch.Tensor  # 0-d int64
    primal_distance_moved_last_restart_period: torch.Tensor  # 0-d
    dual_distance_moved_last_restart_period: torch.Tensor  # 0-d
    gap_reduction_ratio_last_trial: torch.Tensor  # 0-d


def create_last_restart_info(primal, dual) -> RestartInfo:
    def scalar(v):
        return torch.full((), v, dtype=primal.dtype, device=primal.device)

    return RestartInfo(
        primal_solution=primal,
        dual_solution=dual,
        has_gap=torch.zeros((), dtype=torch.bool, device=primal.device),
        gap=scalar(0.0),
        last_restart_length=torch.ones((), dtype=torch.int64,
                                       device=primal.device),
        primal_distance_moved_last_restart_period=scalar(0.0),
        dual_distance_moved_last_restart_period=scalar(0.0),
        gap_reduction_ratio_last_trial=scalar(1.0),
    )


def _distance(primal, dual, center: RestartInfo, primal_w, dual_w):
    return torch.sqrt(
        weighted_norm(primal - center.primal_solution, primal_w) ** 2
        + weighted_norm(dual - center.dual_solution, dual_w) ** 2
    )


def compute_localized_duality_gap(
    problem,
    primal_solution,
    dual_solution,
    primal_norm_params,
    dual_norm_params,
    distance_to_optimality,
    use_approximate: bool,
) -> ObjectiveBound:
    """Euclidean-ball localized gap (reference l.131-156)."""
    return bound_optimal_objective(
        problem,
        primal_solution,
        dual_solution,
        primal_norm_params,
        dual_norm_params,
        distance_to_optimality,
        use_max_norm=False,
        solve_approximately=use_approximate,
    )


class LocalizedDualityGaps(NamedTuple):
    gap_at_average: ObjectiveBound
    distance_traveled_by_average: torch.Tensor
    gap_at_current: ObjectiveBound
    distance_traveled_by_current: torch.Tensor


def compute_localized_duality_gaps(
    problem,
    current_primal,
    current_dual,
    avg_primal,
    avg_dual,
    primal_norm_params,
    dual_norm_params,
    restart_info: RestartInfo,
    use_approximate: bool,
) -> LocalizedDualityGaps:
    """The localized gaps at the average and at the current point, each
    in the ball through the last restart point (reference
    src/saddle_point.jl:432-496). run_restart_scheme computes the same
    gaps in one batched solve."""
    dist_avg = _distance(avg_primal, avg_dual, restart_info,
                         primal_norm_params, dual_norm_params)
    dist_cur = _distance(current_primal, current_dual, restart_info,
                         primal_norm_params, dual_norm_params)
    return LocalizedDualityGaps(
        gap_at_average=compute_localized_duality_gap(
            problem, avg_primal, avg_dual, primal_norm_params,
            dual_norm_params, dist_avg, use_approximate,
        ),
        distance_traveled_by_average=dist_avg,
        gap_at_current=compute_localized_duality_gap(
            problem, current_primal, current_dual, primal_norm_params,
            dual_norm_params, dist_cur, use_approximate,
        ),
        distance_traveled_by_current=dist_cur,
    )


def should_reset_to_average(
    gap_current: ObjectiveBound,
    dist_current,
    gap_average: ObjectiveBound,
    dist_average,
    metric: RestartToCurrentMetric,
):
    """Reference: src/saddle_point.jl:498-547. Returns a bool tensor."""
    current_norm_gap = gap_current.gap / dist_current
    average_norm_gap = gap_average.gap / dist_average
    if metric == RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED:
        return (
            current_norm_gap / dist_current >= average_norm_gap / dist_average
        )
    if metric == RestartToCurrentMetric.GAP_OVER_DISTANCE:
        return current_norm_gap >= average_norm_gap
    return torch.ones((), dtype=torch.bool, device=dist_current.device)


class RestartSchemeResult(NamedTuple):
    restart_choice: torch.Tensor  # 0-d int32 RestartChoice code
    primal_solution: torch.Tensor
    dual_solution: torch.Tensor
    avg: SolutionWeightedAverage
    restart_info: RestartInfo


def select_fields(cond, a, b):
    """`a` where the bool `cond`, else `b`, leaf by leaf through
    dataclasses and named tuples (the JAX package's tree_map of
    jnp.where); a fleet's (B,) condition broadcasts over a (dim, B)
    leaf's trailing axis."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: select_fields(cond, getattr(a, f.name),
                                  getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    if isinstance(a, tuple):
        return type(a)(*(select_fields(cond, u, v) for u, v in zip(a, b)))
    return torch.where(cond, a, b)


def distance_last_restart(restart_info: RestartInfo, primal_weight):
    """The weighted distance the last restart period moved (per lane
    for a fleet)."""
    return torch.sqrt(
        restart_info.primal_distance_moved_last_restart_period**2
        * primal_weight
        + restart_info.dual_distance_moved_last_restart_period**2
        / primal_weight
    )


def run_restart_scheme(
    problem,
    avg: SolutionWeightedAverage,
    current_primal,
    current_dual,
    restart_info: RestartInfo,
    iterations_completed,
    primal_norm_params,
    dual_norm_params,
    primal_weight,
    restart_params: RestartParameters,
) -> RestartSchemeResult:
    """Decides whether to restart and applies the restart.

    Reference: src/saddle_point.jl:651-846; the JAX package's
    run_restart_scheme (saddle_point.py:423-689 there): the scheme and
    the metric are static, every decision is a 0-d device tensor and the
    results are chosen by torch.where, so nothing is read back.
    `iterations_completed` and the average's counts are 0-d int64
    tensors.
    """
    device = current_primal.device
    no_restart = RestartSchemeResult(
        restart_choice=torch.full(
            (), int(RestartChoice.RESTART_CHOICE_NO_RESTART),
            dtype=torch.int32, device=device),
        primal_solution=current_primal,
        dual_solution=current_dual,
        avg=avg,
        restart_info=restart_info,
    )
    has_average = (avg.sum_primal_solutions_count > 0) & (
        avg.sum_dual_solutions_count > 0
    )
    # An empty average divides by 1 (its result is not used then).
    safe_avg_primal, safe_avg_dual = compute_average(avg)

    restart_length = avg.sum_primal_solutions_count
    do_restart = restart_length.to(torch.float64) >= (
        restart_params.artificial_restart_threshold
        * iterations_completed.to(torch.float64)
    )
    false = torch.zeros((), dtype=torch.bool, device=device)

    scheme = restart_params.restart_scheme
    if scheme == RestartScheme.NO_RESTARTS:
        reset_to_average = false
        zero = torch.zeros((), dtype=current_primal.dtype, device=device)
        candidate_gap = ObjectiveBound(zero, zero, zero)
        candidate_distance = zero
    else:
        # All localized-gap evaluations the scheme needs (average, current
        # and, for ADAPTIVE_NORMALIZED, the last restart point) go through
        # one batched trust-region solve.
        dist_avg = _distance(
            safe_avg_primal, safe_avg_dual, restart_info,
            primal_norm_params, dual_norm_params,
        )
        dist_cur = _distance(
            current_primal, current_dual, restart_info,
            primal_norm_params, dual_norm_params,
        )
        batch_primals = [safe_avg_primal, current_primal]
        batch_duals = [safe_avg_dual, current_dual]
        batch_radii = [dist_avg, dist_cur]
        if scheme == RestartScheme.ADAPTIVE_NORMALIZED:
            dist_last_restart = distance_last_restart(restart_info,
                                                       primal_weight)
            batch_primals.append(restart_info.primal_solution)
            batch_duals.append(restart_info.dual_solution)
            batch_radii.append(dist_last_restart)
        bounds = bound_optimal_objective_euclidean_batched(
            problem,
            torch.stack(batch_primals),
            torch.stack(batch_duals),
            primal_norm_params,
            dual_norm_params,
            torch.stack(batch_radii),
            restart_params.use_approximate_localized_duality_gap,
        )

        def bound_row(i):
            return ObjectiveBound(
                lagrangian_value=bounds.lagrangian_value[i],
                lower_bound_value=bounds.lower_bound_value[i],
                upper_bound_value=bounds.upper_bound_value[i],
            )

        gap_avg, gap_cur = bound_row(0), bound_row(1)
        reset_to_average = should_reset_to_average(
            gap_cur, dist_cur, gap_avg, dist_avg,
            restart_params.restart_to_current_metric,
        )
        candidate_gap = ObjectiveBound(
            *(
                torch.where(reset_to_average, a, c)
                for a, c in zip(gap_avg, gap_cur)
            )
        )
        candidate_distance = torch.where(reset_to_average, dist_avg, dist_cur)

    gap_ratio_update = restart_info.gap_reduction_ratio_last_trial
    if scheme == RestartScheme.ADAPTIVE_NORMALIZED:
        last_restart_gap = bound_row(2)
        normalized_candidate = candidate_gap.gap / candidate_distance
        normalized_last = last_restart_gap.gap / dist_last_restart
        gap_reduction_ratio = normalized_candidate / normalized_last
        do_restart = do_restart | (
            (
                gap_reduction_ratio
                < restart_params.necessary_reduction_for_restart
            ) & (
                (
                    gap_reduction_ratio
                    < restart_params.sufficient_reduction_for_restart
                )
                | (gap_reduction_ratio
                   > restart_info.gap_reduction_ratio_last_trial)
            )
        )
        gap_ratio_update = gap_reduction_ratio
    elif scheme in (
        RestartScheme.ADAPTIVE_LOCALIZED,
        RestartScheme.ADAPTIVE_DISTANCE,
    ):
        if scheme == RestartScheme.ADAPTIVE_LOCALIZED:
            new_potential = candidate_gap.gap / restart_length
            old_potential = restart_info.gap / restart_info.last_restart_length
        else:
            new_potential = candidate_distance / restart_length
            old_potential = (
                distance_last_restart(restart_info, primal_weight)
                / restart_info.last_restart_length
            )
        scheme_restart = (
            new_potential / old_potential
            < restart_params.necessary_reduction_for_restart
        )
        # Automatically restart if no restart has occurred yet.
        do_restart = do_restart | torch.where(
            restart_info.has_gap, scheme_restart, ~false
        )
    elif scheme == RestartScheme.FIXED_FREQUENCY:
        do_restart = do_restart | (
            restart_params.restart_frequency_if_fixed <= restart_length
        )
    do_restart = do_restart & has_average

    to_average = do_restart & reset_to_average
    new_primal = torch.where(to_average, safe_avg_primal, current_primal)
    new_dual = torch.where(to_average, safe_avg_dual, current_dual)
    sqrt_weight = torch.sqrt(primal_weight)
    updated_info = RestartInfo(
        primal_solution=new_primal,
        dual_solution=new_dual,
        has_gap=torch.full((), scheme != RestartScheme.NO_RESTARTS,
                           dtype=torch.bool, device=device),
        gap=candidate_gap.gap,
        last_restart_length=restart_length,
        primal_distance_moved_last_restart_period=weighted_norm(
            safe_avg_primal - restart_info.primal_solution, primal_norm_params
        )
        / sqrt_weight,
        dual_distance_moved_last_restart_period=weighted_norm(
            safe_avg_dual - restart_info.dual_solution, dual_norm_params
        )
        * sqrt_weight,
        gap_reduction_ratio_last_trial=gap_ratio_update,
    )
    # gap_reduction_ratio_last_trial is updated on every
    # ADAPTIVE_NORMALIZED trial, restart or not (reference l.590); the
    # other fields change only on a restart.
    kept_info = dataclasses.replace(
        restart_info, gap_reduction_ratio_last_trial=gap_ratio_update
    )
    restart_choice = torch.where(
        ~do_restart,
        int(RestartChoice.RESTART_CHOICE_NO_RESTART),
        torch.where(
            reset_to_average,
            int(RestartChoice.RESTART_CHOICE_RESTART_TO_AVERAGE),
            int(RestartChoice.RESTART_CHOICE_WEIGHTED_AVERAGE_RESET),
        ),
    ).to(torch.int32)
    result = RestartSchemeResult(
        restart_choice=restart_choice,
        primal_solution=new_primal,
        dual_solution=new_dual,
        avg=select_fields(do_restart, reset_solution_weighted_average(avg),
                          avg),
        restart_info=select_fields(do_restart, updated_info, kept_info),
    )
    # If there is no average at all, nothing happens (reference l.703-709).
    return select_fields(has_average, result, no_restart)


def compute_new_primal_weight(
    restart_info: RestartInfo,
    primal_weight,
    primal_weight_update_smoothing: float,
):
    """Exponentially smoothed (in log space) primal weight update.

    Reference: src/saddle_point.jl:848-891.
    """
    primal_distance = restart_info.primal_distance_moved_last_restart_period
    dual_distance = restart_info.dual_distance_moved_last_restart_period
    eps = float(np.finfo(np.float64).eps)
    valid = (primal_distance > eps) & (dual_distance > eps)
    safe_primal = torch.where(valid, primal_distance, 1.0)
    safe_dual = torch.where(valid, dual_distance, 1.0)
    new_estimate = safe_dual / safe_primal
    log_primal_weight = primal_weight_update_smoothing * torch.log(
        new_estimate
    ) + (1 - primal_weight_update_smoothing) * torch.log(primal_weight)
    return torch.where(valid, torch.exp(log_primal_weight), primal_weight)


def select_initial_primal_weight(
    problem,
    primal_norm_params,
    dual_norm_params,
    primal_importance: float,
):
    """Scale-invariant initial primal weight: primal_importance times
    ||c|| / ||b|| in the weighted norms, or primal_importance when
    either norm is 0 (reference src/saddle_point.jl:1049-1075). The
    solvers use models/common.initial_primal_weight_host, its host form
    with all-ones weights."""
    rhs_norm = weighted_norm(problem.right_hand_side, dual_norm_params)
    obj_norm = weighted_norm(problem.objective_vector, primal_norm_params)
    use_ratio = (obj_norm > 0.0) & (rhs_norm > 0.0)
    return torch.where(
        use_ratio,
        primal_importance
        * (obj_norm / torch.where(rhs_norm > 0, rhs_norm, 1.0)),
        torch.full_like(obj_norm, primal_importance),
    )


def update_objective_bound_estimates(
    problem, primal, dual, primal_norm_weights, dual_norm_weights
):
    """Estimated optimal-objective range via a MAX_NORM localized gap.

    Reference: src/saddle_point.jl:1015-1047. Returns (lagrangian, lower,
    upper) scalars for method_specific_stats.
    """
    est_primal_dist = torch.clamp_min(
        weighted_norm(primal, primal_norm_weights), 1e-8
    )
    est_dual_dist = torch.clamp_min(
        weighted_norm(dual, dual_norm_weights), 1e-8
    )
    bound = bound_optimal_objective(
        problem,
        primal,
        dual,
        primal_norm_weights / est_primal_dist**2,
        dual_norm_weights / est_dual_dist**2,
        1.0,
        use_max_norm=True,
        solve_approximately=False,
    )
    return (
        bound.lagrangian_value,
        bound.lower_bound_value,
        bound.upper_bound_value,
    )


# ---------------------------------------------------------------------------
# Lagrangian gradients
# ---------------------------------------------------------------------------
#
# The solvers, their evaluations and the fleets' restart code compute
# these terms through the functions below, passing the products they
# already hold (`qx`, `aty`, `ax`). The vectors may be a single
# instance's (n,) / (m,) or a fleet's (n, B) / (m, B); sums run over
# dim 0. For an LP the Q x terms are left out: they add exact zeros.


def compute_primal_gradient_from_dual_product(problem, primal, dual_product,
                                              qx=None):
    """Q x + c - A'y given the cached A'y (reference l.1093-1100); `qx`
    passes a cached Q x."""
    if problem.objective_matrix is None:
        return problem.objective_vector - dual_product
    if qx is None:
        qx = problem.qx(primal)
    return qx + problem.objective_vector - dual_product


def compute_primal_gradient(problem, primal, dual):
    return compute_primal_gradient_from_dual_product(
        problem, primal, problem.aty(dual)
    )


def compute_dual_gradient(problem, primal, ax=None):
    """b - A x (reference l.1102-1107); `ax` passes a cached A x."""
    return problem.right_hand_side - (problem.ax(primal) if ax is None
                                      else ax)


def compute_lagrangian_value(problem, primal, dual, aty=None, qx=None):
    """0.5 x'Qx + c'x - x'A'y + b'y + const (reference l.1109-1120);
    `aty` and `qx` pass cached products."""
    if aty is None:
        aty = problem.aty(dual)
    value = torch.sum(primal * problem.objective_vector, dim=0)
    if problem.objective_matrix is not None:
        if qx is None:
            qx = problem.qx(primal)
        value = 0.5 * torch.sum(primal * qx, dim=0) + value
    return (
        value
        - torch.sum(primal * aty, dim=0)
        + torch.sum(dual * problem.right_hand_side, dim=0)
        + problem.objective_constant
    )
