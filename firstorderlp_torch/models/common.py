"""Shared pieces of the PDHG / Mirror Prox solve loops.

The solvers run as a host loop over *segments*: each segment performs one
termination/restart evaluation followed by the steps up to the next
evaluation point (reference loop structure,
src/primal_dual_hybrid_gradient.jl:885-1048). The stats scalars of an
evaluation are read back to the host in one transfer.
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
from ..solve_log import TerminationReason
from ..termination import (
    TerminationCriteria,
    check_termination_criteria,
)


class EvalResult(NamedTuple):
    """Per-evaluation scalars shipped to the host."""

    conv: DeviceConvergenceInfo
    infeas: DeviceInfeasibilityInfo
    lagrangian_value: torch.Tensor
    estimated_lower_bound: torch.Tensor
    estimated_upper_bound: torch.Tensor
    termination_reason: int  # 0 = keep going
    restart_used: int  # RestartChoice code
    iteration: int  # the iteration evaluated (ref: iter - 1)
    cumulative_kkt_passes: float
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
    the termination block of the solve loops)."""
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
    if numerical_error:
        reason = torch.where(
            reason == 0,
            int(TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR),
            reason,
        )
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
    """The evaluation's float scalars, read back in one transfer."""
    values = [*result.conv, *result.infeas, result.lagrangian_value,
              result.estimated_lower_bound, result.estimated_upper_bound,
              result.step_size, result.primal_weight]
    host = torch.stack(
        [v.reshape(()).to(torch.float64) for v in values]
    ).tolist()
    nc, ni = len(result.conv), len(result.infeas)
    return result._replace(
        conv=DeviceConvergenceInfo(*host[:nc]),
        infeas=DeviceInfeasibilityInfo(*host[nc:nc + ni]),
        lagrangian_value=host[nc + ni],
        estimated_lower_bound=host[nc + ni + 1],
        estimated_upper_bound=host[nc + ni + 2],
        step_size=host[nc + ni + 3],
        primal_weight=host[nc + ni + 4],
    )
