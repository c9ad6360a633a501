"""Shared pieces of the PDHG / Mirror Prox solve loops.

The solvers run as a host loop over *dispatches* of up to
`evaluations_per_dispatch` segments: each segment performs one
termination/restart evaluation followed by the steps up to the next
evaluation point (reference loop structure,
src/primal_dual_hybrid_gradient.jl:885-1048). An evaluation runs on the
device and reads nothing back; the host reads its scalars in one
transfer once a dispatch (host_floats), when it needs them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
    compute_convergence_information,
    compute_infeasibility_information,
)
from ..saddle_point import compute_average
from ..solve_log import TerminationReason
from ..termination import (
    TerminationCriteria,
    check_termination_criteria,
)


class EvalResult(NamedTuple):
    """Per-evaluation scalars: 0-d device tensors, or host numbers after
    host_floats."""

    conv: DeviceConvergenceInfo
    infeas: DeviceInfeasibilityInfo
    lagrangian_value: torch.Tensor
    estimated_lower_bound: torch.Tensor
    estimated_upper_bound: torch.Tensor
    termination_reason: torch.Tensor  # int32, 0 = keep going
    restart_used: torch.Tensor  # int32 RestartChoice code
    iteration: torch.Tensor  # int64, the iteration evaluated (ref: iter - 1)
    cumulative_kkt_passes: torch.Tensor  # float64
    step_size: torch.Tensor
    primal_weight: torch.Tensor


def evaluate_unscaled_stats(
    bundle,
    criteria: TerminationCriteria,
    avg_primal,
    avg_dual,
    numerical_error,
    iteration_number,
    cumulative_kkt_passes,
    elapsed_time,
):
    """Unscales the iterates and evaluates stats + termination on the
    ORIGINAL problem (reference src/iteration_stats_utils.jl:408-451 and
    the termination block of the solve loops). `numerical_error`, the
    iteration, the KKT passes and `elapsed_time` may be 0-d device
    tensors; nothing is read back."""
    original_primal = avg_primal / bundle.variable_rescaling
    original_dual = avg_dual / bundle.constraint_rescaling
    # Julia division semantics: 0/0 -> NaN, x/0 -> Inf (not an exception).
    with np.errstate(divide="ignore", invalid="ignore"):
        eps_ratio = float(
            np.float64(criteria.eps_optimal_absolute)
            / np.float64(criteria.eps_optimal_relative)
        )
    conv = compute_convergence_information(
        bundle.original, bundle.qp_cache, original_primal, original_dual,
        eps_ratio,
    )
    if (
        criteria.eps_primal_infeasible == 0.0
        and criteria.eps_dual_infeasible == 0.0
    ):
        # Infeasibility detection disabled (both tolerances exactly 0):
        # skip the certificate evaluation - roughly half the matvecs of
        # an evaluation - and record zeros.
        zero = torch.zeros(
            (), dtype=original_primal.dtype, device=original_primal.device
        )
        infeas = DeviceInfeasibilityInfo(
            max_primal_ray_infeasibility=zero,
            primal_ray_linear_objective=zero,
            primal_ray_quadratic_norm=zero,
            max_dual_ray_infeasibility=zero,
            dual_ray_objective=zero,
        )
    else:
        infeas = compute_infeasibility_information(
            bundle.original, original_primal, original_dual
        )
    reason = check_termination_criteria(
        criteria,
        bundle.qp_cache,
        conv,
        infeas,
        iteration_number,
        cumulative_kkt_passes,
        elapsed_time,
    )
    reason = torch.where(
        (reason == 0) & numerical_error,
        int(TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR),
        reason,
    ).to(torch.int32)
    return conv, infeas, reason


def matrix_inf_norm_entrywise(matrix: sp.spmatrix) -> float:
    """Max |a_ij| (Julia's norm(A, Inf) on sparse treats A as a vector of
    entries; used for the initial step size, reference pdhg.jl:823)."""
    if matrix.nnz == 0:
        return 0.0
    return float(np.max(np.abs(matrix.tocoo().data)))


def power_method_failure_probability(
    dimension: int, epsilon: float, k: int
) -> float:
    """Reference: src/primal_dual_hybrid_gradient.jl:372-391."""
    if k < 2 or epsilon <= 0.0:
        return 1.0
    return (
        min(0.824, 0.354 / np.sqrt(epsilon * (k - 1)))
        * np.sqrt(dimension)
        * (1.0 - epsilon) ** (k - 0.5)
    )


def estimate_maximum_singular_value(
    matrix: sp.spmatrix,
    probability_of_failure: float = 0.01,
    desired_relative_error: float = 0.1,
    seed: int = 1,
):
    """Power method on A'A with a rigorous failure-probability bound.

    Reference: src/primal_dual_hybrid_gradient.jl:393-440. Runs host-side
    (it is a one-time setup cost); the seeded numpy Generator replaces the
    seeded MersenneTwister.
    """
    epsilon = 1.0 - (1.0 - desired_relative_error) ** 2
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(matrix.shape[1])
    csr = sp.csr_matrix(matrix)
    csr_t = sp.csr_matrix(matrix.T)
    number_of_power_iterations = 0
    while (
        power_method_failure_probability(
            matrix.shape[1], epsilon, number_of_power_iterations
        )
        > probability_of_failure
    ):
        x = x / np.linalg.norm(x, 2)
        x = csr_t @ (csr @ x)
        number_of_power_iterations += 1
    sigma_sq = float(x @ (csr_t @ (csr @ x))) / float(np.linalg.norm(x, 2)) ** 2
    return np.sqrt(sigma_sq), number_of_power_iterations


def initial_primal_weight_host(
    scaled_qp, primal_importance: float, scale_invariant: bool, verbosity: int
) -> float:
    """Host-side select_initial_primal_weight (reference
    src/saddle_point.jl:1049-1075) with all-ones norm weights."""
    if not scale_invariant:
        return float(primal_importance)
    obj_norm = float(np.linalg.norm(scaled_qp.objective_vector, 2))
    rhs_norm = float(np.linalg.norm(scaled_qp.right_hand_side, 2))
    if obj_norm > 0.0 and rhs_norm > 0.0:
        primal_weight = primal_importance * (obj_norm / rhs_norm)
    else:
        primal_weight = primal_importance
    if verbosity >= 6:
        print(f"Initial primal weight = {primal_weight}")
    return float(primal_weight)


def next_eval_iteration(iteration: int, config) -> int:
    """The first evaluation iteration after `iteration` (host ints): the
    iteration at which a segment that starts at `iteration` ends."""
    if iteration + 1 <= 10:
        return iteration + 1
    freq = config.termination_evaluation_frequency
    following = iteration + freq - (iteration - 1) % freq
    limit = int(config.criteria.iteration_limit) + 1
    return min(following, limit) if limit > iteration else following


def evaluation_point(state, primal, dual):
    """The point an evaluation judges: the state's weighted average
    where it has one (and no numerical error), else (`primal`, `dual`),
    its current iterate; per lane for a fleet's state."""
    avg = state.avg
    has_avg = (~state.numerical_error
               & (avg.sum_primal_solutions_count > 0)
               & (avg.sum_dual_solutions_count > 0))
    avg_primal, avg_dual = compute_average(avg)
    return (torch.where(has_avg, avg_primal, primal),
            torch.where(has_avg, avg_dual, dual))


def graph_key(solver: str, config) -> tuple:
    """A solver's config as the key of the CUDA graphs captured for it
    (ops/graphs.cached): every number a graph bakes in (the criteria,
    the restart parameters, the step rule, the evaluation frequency)."""
    return (solver, dataclasses.astuple(config.criteria),
            config.restart_params, getattr(config, "step_policy", None),
            config.termination_evaluation_frequency,
            config.need_bound_estimates)


def device_counters(state, counter_dtypes):
    """`state` (a solver state) with every counter and flag a 0-d tensor
    of its dtype on the state's device: the fields named in
    `counter_dtypes`, the average's counts and the restart info's flag
    and length. Host numbers, as a caller or an old checkpoint may give
    them, are filled in on the device. Runs once a solve."""
    device = state.step_size.device

    def scalar(value, dtype):
        if isinstance(value, torch.Tensor):
            return value.to(device=device, dtype=dtype)
        return torch.full((), value, dtype=dtype, device=device)

    avg, info = state.avg, state.restart_info
    return dataclasses.replace(
        state,
        avg=dataclasses.replace(
            avg,
            sum_primal_solutions_count=scalar(
                avg.sum_primal_solutions_count, torch.int64),
            sum_dual_solutions_count=scalar(
                avg.sum_dual_solutions_count, torch.int64),
        ),
        restart_info=dataclasses.replace(
            info,
            has_gap=scalar(info.has_gap, torch.bool),
            last_restart_length=scalar(info.last_restart_length,
                                       torch.int64),
        ),
        **{name: scalar(getattr(state, name), dtype)
           for name, dtype in counter_dtypes.items()},
    )


def select_average(cond, a, b):
    """SolutionWeightedAverage `a` where the 0-d bool `cond`, else `b`,
    field by field."""
    return type(a)(*(
        torch.where(cond, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    ))


def torch_dtype(name: str) -> torch.dtype:
    """The compute or stats dtype a parameter names: float32 or float64."""
    dtype = getattr(torch, str(name), None)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {name!r}")
    return dtype


def host_floats(result: EvalResult):
    """The evaluation's scalars on the host, read back in one transfer:
    floats, and ints for the reason, the restart and the iteration."""
    values = [*result.conv, *result.infeas, result.lagrangian_value,
              result.estimated_lower_bound, result.estimated_upper_bound,
              result.step_size, result.primal_weight,
              result.cumulative_kkt_passes, result.termination_reason,
              result.restart_used, result.iteration]
    host = torch.stack(
        [torch.as_tensor(v).reshape(()).to(torch.float64) for v in values]
    ).tolist()
    nc, ni = len(result.conv), len(result.infeas)
    k = nc + ni
    return result._replace(
        conv=DeviceConvergenceInfo(*host[:nc]),
        infeas=DeviceInfeasibilityInfo(*host[nc:k]),
        lagrangian_value=host[k],
        estimated_lower_bound=host[k + 1],
        estimated_upper_bound=host[k + 2],
        step_size=host[k + 3],
        primal_weight=host[k + 4],
        cumulative_kkt_passes=host[k + 5],
        termination_reason=int(host[k + 6]),
        restart_used=int(host[k + 7]),
        iteration=int(host[k + 8]),
    )
