"""Shared pieces of the PDHG / Mirror Prox solves: the ingest
(`ingest`, `PreparedProblem`), the host loop (`solve`) and the
evaluation's statistics.

The solvers run as a host loop over *dispatches* of up to
`evaluations_per_dispatch` segments: each segment performs one
termination/restart evaluation followed by the steps up to the next
evaluation point (reference loop structure,
src/primal_dual_hybrid_gradient.jl:885-1048). An evaluation runs on the
device and reads nothing back; the host reads its scalars in one
transfer once a dispatch (host_floats), when it needs them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import spans
from ..iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
    compute_convergence_information,
    compute_infeasibility_information,
    display_iteration_stats,
    display_iteration_stats_heading,
    print_to_screen_this_iteration,
    to_host_stats,
)
from ..ops import eval_stats
from ..ops.device import resolve_device
from ..ops.device_problem import DeviceScaledQp, to_device, to_device_scaled
from ..ops.routed import RoutedOp
from ..ops.routed_sharded import agreed_seconds
from ..preprocess import rescale_problem
from ..problem import validate
from ..saddle_point import SaddlePointOutput, compute_average
from ..solve_log import PointType, RestartChoice, TerminationReason
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
    tensors; nothing is read back. On the f32 kernel operator
    (fused_statistics) the work is evaluate_fused_statistics'."""
    if fused_statistics(bundle, avg_primal):
        return evaluate_fused_statistics(
            bundle, criteria, avg_primal, avg_dual, None, numerical_error,
            iteration_number, cumulative_kkt_passes, elapsed_time)[2:]
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


def evaluate_statistics(bundle, criteria: TerminationCriteria, state,
                        primal, dual, iteration_number,
                        cumulative_kkt_passes, elapsed_time):
    """An evaluation's point and statistics, as the solvers' _eval_block
    take them: (avg_primal, avg_dual) = evaluation_point(state, primal,
    dual) and evaluate_unscaled_stats' (conv, infeas, reason) there,
    with the state's numerical-error flag; on the f32 kernel operator
    (fused_statistics) both are evaluate_fused_statistics' kernels."""
    if fused_statistics(bundle, primal):
        return evaluate_fused_statistics(
            bundle, criteria, primal, dual, state.avg, state.numerical_error,
            iteration_number, cumulative_kkt_passes, elapsed_time)
    avg_primal, avg_dual = evaluation_point(state, primal, dual)
    return (avg_primal, avg_dual, *evaluate_unscaled_stats(
        bundle, criteria, avg_primal, avg_dual, state.numerical_error,
        iteration_number, cumulative_kkt_passes, elapsed_time))


def fused_statistics(bundle, primal) -> bool:
    """Whether an evaluation of the point `primal` on `bundle` runs
    evaluate_fused_statistics: the original copy's constraint operator is
    the kernel operator (RoutedOp, CSR or tile plan), it is an LP, its
    vectors and the rescaling are f32, and the point is one f32 vector.
    f64, QPs, meshes (ShardedRoutedOp) and fleets run the eager
    statistics."""
    original = bundle.original
    return (
        isinstance(original.constraint_matrix, RoutedOp)
        and original.objective_matrix is None
        and original.objective_vector.dtype == torch.float32
        and bundle.variable_rescaling.dtype == torch.float32
        and primal.dtype == torch.float32
        and primal.dim() == 1
    )


def evaluate_fused_statistics(bundle, criteria: TerminationCriteria, primal,
                              dual, average, numerical_error,
                              iteration_number, cumulative_kkt_passes,
                              elapsed_time):
    """evaluation_point and evaluate_unscaled_stats on the f32 kernel
    operator (fused_statistics) as three kernels around three products
    of the original operator (ops/eval_stats.py): F2d (the point: the
    `average`, a SolutionWeightedAverage, where it has one and
    `numerical_error` is not set, else (`primal`, `dual`); with `average`
    None, the point given), A x and A'y, F2e, A ray (where infeasibility
    is detected), F2f. Returns (the scaled point, None without an
    average, conv, infeas, reason); nothing is read back."""
    original = bundle.original
    op = original.constraint_matrix
    rules = eval_stats.criteria_of(criteria)
    if average is not None:
        average = eval_stats.Average(
            average.sum_primal_solutions, average.sum_dual_solutions,
            average.sum_primal_solutions_count,
            average.sum_dual_solutions_count,
            average.sum_primal_solution_weights,
            average.sum_dual_solution_weights, numerical_error)
    point = eval_stats.stats_point(primal, dual, bundle.variable_rescaling,
                                   bundle.constraint_rescaling, average)
    ax = op.mv(point.primal)
    aty = op.rmv(point.dual)
    ray, primal_totals = eval_stats.stats_primal(
        point.primal, aty, original.objective_vector,
        original.variable_lower_bound, original.variable_upper_bound,
        point.primal_norm, rules.ray)
    aray = op.mv(ray) if rules.ray else None
    cache = bundle.qp_cache
    scalars = eval_stats.Scalars(
        objective_constant=original.objective_constant,
        norm_c_inf=cache.l_inf_norm_primal_linear_objective,
        norm_b_inf=cache.l_inf_norm_primal_right_hand_side,
        norm_c_2=cache.l2_norm_primal_linear_objective,
        norm_b_2=cache.l2_norm_primal_right_hand_side,
        numerical_error=numerical_error, iteration=iteration_number,
        kkt_passes=cumulative_kkt_passes, elapsed=elapsed_time)
    _, conv, infeas, reason = eval_stats.stats_dual(
        point.dual, ax, aray, original.right_hand_side,
        original.is_equality, primal_totals, point.primal_norm, scalars,
        rules)
    return (point.scaled_primal, point.scaled_dual,
            DeviceConvergenceInfo(*conv.unbind()),
            DeviceInfeasibilityInfo(*infeas.unbind()), reason)


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
    """The evaluation's scalars on the host, read back in one transfer
    (a read-back in spans.COUNTS): floats, and ints for the reason, the
    restart and the iteration."""
    values = [*result.conv, *result.infeas, result.lagrangian_value,
              result.estimated_lower_bound, result.estimated_upper_bound,
              result.step_size, result.primal_weight,
              result.cumulative_kkt_passes, result.termination_reason,
              result.restart_used, result.iteration]
    spans.COUNTS["read_backs"] += 1
    with spans.span("folp.read_back"):
        host = torch.stack(
            [torch.as_tensor(v).reshape(()).to(torch.float64)
             for v in values]
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


# ---------------------------------------------------------------------------
# Ingest and host loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreparedProblem:
    """An ingested problem for a solver's `optimize`: the host rescaling
    (a ScaledQpProblem), the device bundle, the solver's initial state
    and the device the solve runs on."""

    scaled_problem: object
    bundle: DeviceScaledQp
    initial_state: object
    device: torch.device


def ingest(params, original_problem, device=None, _reuse=None,
           _shard_plan=None):
    """What both solvers' prepare_problem do before their own initial
    state (reference: the rescaling step of optimize, pdhg.jl:769-819,
    mirror_prox.jl:627-688): validates `original_problem`, rescales it
    on the host and moves the scaled and the original copy to `device`.
    Returns (scaled_problem, bundle, device).

    `device` defaults to CUDA and raises when no GPU is present.

    _reuse: a PreparedProblem for the SAME problem from an earlier phase
    (refine.py). The solve stays on its device. When its original
    (stats) bundle has this phase's stats dtype, its host
    ScaledQpProblem (rescaling does not depend on the dtype) and that
    bundle are reused, and only the scaled bundle is rebuilt.

    _shard_plan: a RoutedShardPlan (parallel.sharded): the constraint
    operator is built block-partitioned over the plan's mesh, the rest
    on `device` (default: the mesh's home device)."""
    if _reuse is not None:
        device = _reuse.device
    else:
        if _shard_plan is not None and device is None:
            device = _shard_plan.mesh.home_device
        device = resolve_device(device)
    validate(original_problem)
    dtype = torch_dtype(params.dtype)
    stats_dtype = (
        torch_dtype(params.stats_dtype) if params.stats_dtype else None
    )
    if _reuse is not None and (
        _reuse.bundle.original.objective_vector.dtype
        == (stats_dtype or dtype)
    ):
        scaled_problem = _reuse.scaled_problem
        with spans.timed("folp.ingest.to_device"):
            bundle = dataclasses.replace(
                _reuse.bundle,
                scaled=to_device(
                    scaled_problem.scaled_qp, dtype, params.matrix_format,
                    device, shard_plan=_shard_plan,
                ),
            )
        return scaled_problem, bundle, device
    with spans.timed("folp.ingest.rescale"):
        scaled_problem = rescale_problem(
            params.l_inf_ruiz_iterations,
            params.l2_norm_rescaling,
            params.pock_chambolle_alpha,
            params.verbosity,
            original_problem,
            bound_width_rescaling_flag=params.bound_width_rescaling,
        )
    with spans.timed("folp.ingest.to_device"):
        bundle = to_device_scaled(
            scaled_problem,
            dtype,
            params.matrix_format,
            device,
            stats_dtype=stats_dtype,
            stats_format=params.stats_matrix_format,
            shard_plan=_shard_plan,
        )
    return scaled_problem, bundle, device


def scaled_warm_start(scaled_problem, warm_start, dtype, device):
    """(x0, y0): a warm start (primal, dual) given in UNSCALED space,
    mapped into the solver's scaled space, in `dtype` on `device`."""
    primal0, dual0 = warm_start
    x0 = torch.as_tensor(
        np.asarray(primal0) * np.asarray(scaled_problem.variable_rescaling),
        device=device,
    ).to(dtype)
    y0 = torch.as_tensor(
        np.asarray(dual0) * np.asarray(scaled_problem.constraint_rescaling),
        device=device,
    ).to(dtype)
    return x0, y0


def solve(params, original_problem, prepared: PreparedProblem, config, *,
          begin, dispatch, final_bound_estimates, output_iteration,
          unscale, context=None, final_log=None, elapsed_offset: float = 0.0,
          placement=None) -> SaddlePointOutput:
    """A solver's host loop (reference optimize, pdhg.jl:885-1048,
    mirror_prox.jl:700-919) on a prepared problem: the checkpoint's
    resume and cadence, one dispatch after another until a termination
    reason, the statistics of each dispatch the parameters record or
    display, and the answer unscaled. What the solver does its own way:

    - begin(state) -> state: the state made ready for the loop (its
      counters on the device), once, inside the folp.solve span;
    - dispatch(bundle, state, elapsed, num_segments) -> (state, the last
      EvalResult, its termination reason as a host int);
    - final_bound_estimates(bundle, state, result) -> (lagrangian, lower,
      upper): the bound estimates an evaluation skipped when
      `config.need_bound_estimates` is off, for the final statistics;
    - output_iteration(state, result) -> the iteration count the output
      reports (`result` holds host numbers);
    - unscale: saddle_point.unscaled_saddle_point_output as the solver's
      module names it, so that replacing it there (lpbench's fault tests)
      reaches every answer of that solver;
    - context: a context manager around the solve (PDHG's profiler);
    - final_log(scaled_problem, output): printed after the answer.

    `elapsed_offset` pre-charges the time-limit clock. `placement`: a
    function (bundle, state) -> (bundle, state) applied before the loop
    starts. Under a process group the time limit reads rank 0's clock on
    every rank (ops/routed_sharded.agreed_seconds)."""
    scaled_problem = prepared.scaled_problem
    bundle = prepared.bundle
    state = prepared.initial_state

    problem_fp = None
    if params.checkpoint_path or params.resume_from_checkpoint:
        from ..checkpoint import problem_fingerprint

        problem_fp = problem_fingerprint(original_problem)
    elapsed_offset = float(elapsed_offset)
    if params.resume_from_checkpoint:
        from ..checkpoint import load_state

        state, elapsed_offset, _ = load_state(
            params.resume_from_checkpoint, state, fingerprint=problem_fp
        )
        # The previous run's termination (e.g. its iteration limit) does
        # not apply to this run's criteria; re-evaluate from scratch.
        state = dataclasses.replace(
            state,
            termination_reason=torch.zeros_like(state.termination_reason))
    if placement is not None:
        bundle, state = placement(bundle, state)

    def checkpoint(state, metadata):
        from ..checkpoint import save_state

        save_state(
            params.checkpoint_path,
            state,
            elapsed_time=time.time() - start_time,
            metadata=metadata,
            fingerprint=problem_fp,
        )

    display_iteration_stats_heading(params.verbosity)

    spans.COUNTS["solves"] += 1
    with context or contextlib.nullcontext(), \
            spans.span("folp.solve", {"solve": spans.COUNTS["solves"]}):
        iteration_stats = []
        start_time = time.time() - elapsed_offset
        basic_algorithm_time = 0.0
        evals_per_dispatch = max(1, int(params.evaluations_per_dispatch))
        checkpoint_every = max(1, int(params.checkpoint_every_n_dispatches))
        dispatch_count = 0
        state = begin(state)
        while True:
            elapsed = agreed_seconds(
                bundle.scaled.constraint_matrix, time.time() - start_time
            )
            segment_start = time.time()
            state, result, reason = dispatch(
                bundle, state, elapsed, evals_per_dispatch)
            terminated = reason != 0
            basic_algorithm_time += time.time() - segment_start
            dispatch_count += 1
            if not (
                terminated
                or params.record_iteration_stats
                or params.verbosity > 0
            ):
                if params.checkpoint_path and (
                    dispatch_count % checkpoint_every == 0
                ):
                    checkpoint(state, {"iteration": -1})
                continue
            with spans.span("folp.finalize"):
                if terminated and not config.need_bound_estimates:
                    # The eval block skipped the diagnostics-only bound
                    # estimates; recover them once so the final stats
                    # entry keeps parity with the reference's
                    # method_specific_stats (saddle_point.jl:1015).
                    lagr, est_lb, est_ub = final_bound_estimates(
                        bundle, state, result)
                    result = result._replace(
                        lagrangian_value=lagr,
                        estimated_lower_bound=est_lb,
                        estimated_upper_bound=est_ub,
                    )
                result = host_floats(result)
                # = displayed iteration - 1
                eval_iteration = result.iteration
                if params.checkpoint_path and (
                    dispatch_count % checkpoint_every == 0 or terminated
                ):
                    checkpoint(state, {"iteration": eval_iteration + 1})
                method_specific_stats = {
                    "time_spent_doing_basic_algorithm":
                        basic_algorithm_time,
                    "lagrangian_value": result.lagrangian_value,
                    "estimated_lower_bound": result.estimated_lower_bound,
                    "estimated_upper_bound": result.estimated_upper_bound,
                }
                stats = to_host_stats(
                    result.conv,
                    result.infeas,
                    eval_iteration,
                    result.cumulative_kkt_passes,
                    elapsed,
                    RestartChoice(result.restart_used)
                    if result.restart_used != 0
                    else RestartChoice.RESTART_CHOICE_UNSPECIFIED,
                    result.step_size,
                    result.primal_weight,
                    method_specific_stats,
                    PointType.POINT_TYPE_AVERAGE_ITERATE,
                )
            if params.record_iteration_stats or terminated:
                iteration_stats.append(stats)
            if print_to_screen_this_iteration(
                terminated,
                eval_iteration + 1,
                params.verbosity,
                params.termination_evaluation_frequency,
            ):
                display_iteration_stats(stats, params.verbosity)

            if terminated:
                reason = TerminationReason(result.termination_reason)
                if params.verbosity >= 1:
                    from ..solve_log import termination_reason_to_string

                    print(
                        f"Terminated after {eval_iteration + 1} iterations: "
                        f"{termination_reason_to_string(reason)}"
                    )
                with spans.span("folp.unscale"):
                    output = unscale(
                        scaled_problem,
                        state.avg_primal_out,
                        state.avg_dual_out,
                        reason,
                        output_iteration(state, result),
                        iteration_stats,
                    )
                if final_log is not None:
                    final_log(scaled_problem, output)
                if params.verbosity >= 7:
                    # generic_final_log (reference saddle_point.jl:1004-1012)
                    from ..problem import (
                        print_variable_and_constraint_hardness,
                    )

                    print_variable_and_constraint_hardness(
                        scaled_problem.original_qp,
                        output.primal_solution,
                        output.dual_solution,
                    )
                return output
