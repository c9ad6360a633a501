"""Primal-dual hybrid gradient (PDHG / PDLP) solver in PyTorch.

Reference semantics: src/primal_dual_hybrid_gradient.jl, as ported by the
JAX package's models/pdhg.py. The step rules, restart machinery and
KKT-pass accounting are the same; the execution model is eager PyTorch:

- the problem and the solver state are dataclasses of tensors on one
  device; between segments the loop counters and flags are Python
  values on the host,
- each *segment* is one termination/restart evaluation, then the step
  trials up to the next evaluation iteration on the device, as the JAX
  package's while_loop runs them: masked trials (torch.where over the
  state, the counters 0-d tensors) in rounds with one read-back a round
  (_run_trials); Malitsky-Pock's line search keeps a host loop,
- on the f32 LP path with the kernel operator, each adaptive trial runs
  the fused CUDA kernels of ops/routed.py (mv_dual_step, rmv_stats), and
  on a CUDA device each trial is a replay of a CUDA graph captured once
  on the device bundle (ops/graphs.py).

Step rules (tau = step/omega, sigma = step*omega; reference pdhg.jl:100-107):
    x+ = proj_[l,u](x - tau (Qx + c - A'y))
    y+ = proj_{>=0 on ineq}(y + sigma (b - A(2x+ - x)))
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
    display_iteration_stats,
    display_iteration_stats_heading,
    print_to_screen_this_iteration,
    to_host_stats,
)
from ..ops import graphs
from ..ops.device import resolve_device
from ..ops.device_problem import DeviceScaledQp, to_device, to_device_scaled
from ..ops.routed import RoutedOp
from ..ops.routed_sharded import agreed_seconds
from ..preprocess import rescale_problem
from ..problem import QuadraticProgrammingProblem, validate
from ..saddle_point import (
    RestartInfo,
    RestartParameters,
    SaddlePointOutput,
    SolutionWeightedAverage,
    add_to_primal_solution_weighted_average,
    add_to_solution_weighted_average,
    compute_average,
    compute_dual_gradient,
    compute_new_primal_weight,
    compute_primal_gradient_from_dual_product,
    create_last_restart_info,
    initialize_solution_weighted_average,
    project_dual,
    project_primal,
    run_restart_scheme,
    unscaled_saddle_point_output,
    update_objective_bound_estimates,
)
from ..solve_log import PointType, RestartChoice, TerminationReason
from ..termination import TerminationCriteria, validate_termination_criteria
from .common import (
    EvalResult,
    estimate_maximum_singular_value,
    evaluate_unscaled_stats,
    host_floats,
    initial_primal_weight_host,
    matrix_inf_norm_entrywise,
    next_eval_iteration,
    select_average,
    torch_dtype,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MalitskyPockStepsizeParameters:
    """Reference: pdhg.jl:15-41."""

    downscaling_factor: float
    breaking_factor: float
    interpolation_coefficient: float


@dataclasses.dataclass(frozen=True)
class AdaptiveStepsizeParams:
    """Reference: pdhg.jl:43-63."""

    reduction_exponent: float
    growth_exponent: float


@dataclasses.dataclass(frozen=True)
class ConstantStepsizeParams:
    """Reference: pdhg.jl:65-68."""


StepsizePolicy = Union[
    MalitskyPockStepsizeParameters, AdaptiveStepsizeParams,
    ConstantStepsizeParams,
]


@dataclasses.dataclass
class PdhgParameters:
    """Reference: pdhg.jl:70-199, plus the JAX package's knobs (dtype,
    matrix layout, evaluations per dispatch, stats precision)."""

    l_inf_ruiz_iterations: int
    l2_norm_rescaling: bool
    pock_chambolle_alpha: Optional[float]
    primal_importance: float
    scale_invariant_initial_primal_weight: bool
    verbosity: int
    record_iteration_stats: bool
    termination_evaluation_frequency: int
    termination_criteria: TerminationCriteria
    restart_params: RestartParameters
    step_size_policy_params: StepsizePolicy
    dtype: str = "float64"
    matrix_format: str = "auto"  # "auto" | "dense" | "sparse" | "routed"
    # Evaluation segments per "dispatch": the elapsed time fed to the
    # time-limit check is refreshed, and stats are reported, once per
    # dispatch (the JAX package's cadence; 1 = every evaluation).
    evaluations_per_dispatch: int = 1
    # Checkpoint/resume (checkpoint.py): the state is written to
    # `checkpoint_path` every `checkpoint_every_n_dispatches` dispatches
    # and at termination; `resume_from_checkpoint` starts from a file.
    checkpoint_path: Optional[str] = None
    checkpoint_every_n_dispatches: int = 1
    resume_from_checkpoint: Optional[str] = None
    # Precision of termination/stats evaluation (None = same as dtype).
    stats_dtype: Optional[str] = None
    # Matrix layout of the ORIGINAL (stats) problem copy (None = same as
    # matrix_format).
    stats_matrix_format: Optional[str] = None
    # Bound-width column rescaling before Ruiz/L2/PC
    # (preprocess.bound_width_rescaling). Off by default.
    bound_width_rescaling: bool = False
    # A torch.profiler trace of the solve is written to this directory
    # as PROFILER_TRACE_FILE (a Chrome trace) when set.
    profiler_trace_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class _PdhgConfig:
    criteria: TerminationCriteria
    restart_params: RestartParameters
    step_policy: StepsizePolicy
    termination_evaluation_frequency: int
    # The estimated objective bounds are diagnostics only; skip their
    # trust-region solve in the loop when nothing records them.
    need_bound_estimates: bool = True


# The Chrome trace that `profiler_trace_dir` receives.
PROFILER_TRACE_FILE = "pdhg_trace.json"


@contextlib.contextmanager
def _profiler_trace(trace_dir: Optional[str], device: torch.device):
    """torch.profiler around the solve's host loop when `trace_dir` is
    set (the JAX package starts jax.profiler at the same point): CPU
    activity, and CUDA activity on a CUDA device. The trace stops however
    the loop ends and is written as a Chrome trace to
    `trace_dir`/PROFILER_TRACE_FILE. When unset, no profiler exists."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    profiler = profile(activities=activities)
    try:
        with profiler:
            yield
    finally:
        profiler.export_chrome_trace(
            os.path.join(trace_dir, PROFILER_TRACE_FILE)
        )


# ---------------------------------------------------------------------------
# Solver state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PdhgState:
    """Reference: PdhgSolverState (pdhg.jl:201-258) + loop bookkeeping.
    Field names follow the JAX package's PdhgState. The counters, the
    flag and the average's counts are host values between segments and
    0-d tensors in a segment's trials (_device_counters)."""

    current_primal_solution: torch.Tensor
    current_dual_solution: torch.Tensor
    delta_primal: torch.Tensor
    delta_dual: torch.Tensor
    current_dual_product: torch.Tensor  # cache of A' y
    avg: SolutionWeightedAverage
    restart_info: RestartInfo
    step_size: torch.Tensor  # 0-d
    primal_weight: torch.Tensor  # 0-d
    numerical_error: bool
    cumulative_kkt_passes: float
    total_number_iterations: int  # includes rejected trials
    ratio_step_sizes: torch.Tensor  # 0-d, Malitsky-Pock only
    iteration: int  # outer iteration due for processing
    termination_reason: int  # 0 = running
    avg_primal_out: torch.Tensor  # scaled-space candidate at last eval
    avg_dual_out: torch.Tensor


def _initial_state(bundle: DeviceScaledQp, dtype, device) -> PdhgState:
    n = bundle.scaled.num_variables
    m = bundle.scaled.num_constraints

    def zeros(size):
        return torch.zeros(size, dtype=dtype, device=device)

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    return PdhgState(
        current_primal_solution=zeros(n),
        current_dual_solution=zeros(m),
        delta_primal=zeros(n),
        delta_dual=zeros(m),
        current_dual_product=zeros(n),
        avg=initialize_solution_weighted_average(n, m, dtype, device),
        restart_info=create_last_restart_info(zeros(n), zeros(m)),
        step_size=scalar(0.0),
        primal_weight=scalar(1.0),
        numerical_error=False,
        cumulative_kkt_passes=0.0,
        total_number_iterations=0,
        ratio_step_sizes=scalar(1.0),
        iteration=1,
        termination_reason=0,
        avg_primal_out=zeros(n),
        avg_dual_out=zeros(m),
    )


# ---------------------------------------------------------------------------
# Step computations
# ---------------------------------------------------------------------------


def _compute_next_primal(problem, x, dual_product, step_size, primal_weight):
    """Reference: compute_next_primal_solution (pdhg.jl:442-470)."""
    gradient = compute_primal_gradient_from_dual_product(
        problem, x, dual_product
    )
    return project_primal(x - (step_size / primal_weight) * gradient, problem)


def _compute_next_dual(problem, x, next_x, y, step_size, primal_weight,
                       extrapolation_coefficient=None):
    """Reference: compute_next_dual_solution (pdhg.jl:472-494); the
    extrapolation coefficient is 1 when None."""
    if extrapolation_coefficient is None:
        extrapolated = next_x + (next_x - x)
    else:
        extrapolated = next_x + extrapolation_coefficient * (next_x - x)
    gradient = compute_dual_gradient(problem, extrapolated)
    next_y = project_dual(
        y + (primal_weight * step_size) * gradient, problem
    )
    return next_y, problem.aty(next_y)


def _accept_solution(state: PdhgState, next_x, next_y, next_aty) -> PdhgState:
    """update_solution_in_solver_state (pdhg.jl:496-519): the averaging
    weight is the step size held in the state at entry to the step."""
    return dataclasses.replace(
        state,
        delta_primal=next_x - state.current_primal_solution,
        delta_dual=next_y - state.current_dual_solution,
        current_primal_solution=next_x,
        current_dual_solution=next_y,
        current_dual_product=next_aty,
        avg=add_to_solution_weighted_average(
            state.avg, next_x, next_y, state.step_size
        ),
    )


def _interaction_and_movement(problem, state, next_x, next_y, next_aty):
    """Reference: compute_interaction_and_movement (pdhg.jl:521-549)."""
    dx = next_x - state.current_primal_solution
    dy = next_y - state.current_dual_solution
    if problem.objective_matrix is None:
        primal_objective_interaction = torch.zeros(
            (), dtype=dx.dtype, device=dx.device
        )
    else:
        primal_objective_interaction = 0.5 * torch.sum(dx * problem.qx(dx))
    primal_dual_interaction = torch.sum(
        dx * (next_aty - state.current_dual_product)
    )
    interaction = torch.abs(primal_dual_interaction) + torch.abs(
        primal_objective_interaction
    )
    movement = 0.5 * state.primal_weight * torch.sum(dx * dx) + (
        0.5 / state.primal_weight
    ) * torch.sum(dy * dy)
    return interaction, movement


def _step_size_factors(total, params: AdaptiveStepsizeParams, dtype):
    """(1 - (total + 1)^-reduction, 1 + (total + 1)^-growth) from the
    device counter `total` (a 0-d int64 tensor), on its device in the
    working precision, as batch._pdhg_step_size_factors (the JAX package
    uses XLA's pow, which can differ in the last bit)."""
    t1 = total.to(dtype) + 1.0
    return (1 - t1 ** (-params.reduction_exponent),
            1 + t1 ** (-params.growth_exponent))


def _accepted_where(take, state: PdhgState, next_x, next_y,
                    next_aty) -> PdhgState:
    """The state after an accepted step (_accept_solution, `iteration`
    one on) where the 0-d bool `take`, else `state` bitwise: the JAX
    package's tree_map(jnp.where) over the fields a step moves."""
    accepted = _accept_solution(state, next_x, next_y, next_aty)
    return dataclasses.replace(
        state,
        **{
            name: torch.where(take, getattr(accepted, name),
                              getattr(state, name))
            for name in ("delta_primal", "delta_dual",
                         "current_primal_solution", "current_dual_solution",
                         "current_dual_product")
        },
        avg=select_average(take, accepted.avg, state.avg),
        iteration=torch.where(take, state.iteration + 1, state.iteration),
    )


def _take_step_adaptive(
    problem, state: PdhgState, params: AdaptiveStepsizeParams, active
) -> PdhgState:
    """ONE accept/reject trial of the PDLP adaptive step-size rule
    (reference pdhg.jl:649-731), with no read-back. Each trial costs one
    KKT pass. Accept iff step_size <= movement / interaction; on accept
    the iterate and `iteration` advance, on reject only the step size
    shrinks. The KKT-pass and total_number_iterations accounting is the
    reference's inner loop's.

    Every field is chosen by torch.where: a trial where the 0-d bool
    `active` is false leaves the state bitwise as it was. The counters
    (`iteration`, `total_number_iterations`, `cumulative_kkt_passes`,
    the average's counts) and `numerical_error` are 0-d tensors on the
    device (_device_counters)."""
    step_size = state.step_size
    x = state.current_primal_solution
    total = state.total_number_iterations + 1
    next_x = _compute_next_primal(
        problem, x, state.current_dual_product, step_size,
        state.primal_weight,
    )
    use_fused = (
        isinstance(problem.constraint_matrix, RoutedOp)
        and problem.objective_matrix is None
        and x.dtype == torch.float32
    )
    if use_fused:
        # Fused hot path: the dual step's projection and the
        # interaction/movement reductions run inside the kernels.
        op = problem.constraint_matrix
        z = 2.0 * next_x - x
        sigma = state.primal_weight * step_size
        next_y, y_next_layout, dy2 = op.mv_dual_step(
            z,
            state.current_dual_solution,
            problem.right_hand_side,
            problem.is_equality_f32,
            sigma,
        )
        dx = next_x - x
        next_aty, pd_interaction, dx2 = op.rmv_stats(
            y_next_layout, dx, state.current_dual_product
        )
        interaction = torch.abs(pd_interaction)
        movement = 0.5 * state.primal_weight * dx2 + (
            0.5 / state.primal_weight
        ) * dy2
    else:
        next_y, next_aty = _compute_next_dual(
            problem, x, next_x, state.current_dual_solution, step_size,
            state.primal_weight,
        )
        interaction, movement = _interaction_and_movement(
            problem, state, next_x, next_y, next_aty
        )
    numerical_error = movement == 0.0
    step_size_limit = torch.where(
        interaction > 0,
        movement / torch.where(interaction > 0, interaction, 1.0),
        torch.inf,
    )
    accept = (step_size <= step_size_limit) & ~numerical_error

    shrink, grow = _step_size_factors(total, params, x.dtype)
    new_step_size = torch.where(
        numerical_error,
        step_size,
        torch.minimum(
            shrink * step_size_limit, grow * step_size
        ),
    )
    state = _accepted_where(active & accept, state, next_x, next_y,
                            next_aty)
    return dataclasses.replace(
        state,
        step_size=torch.where(active, new_step_size, step_size),
        numerical_error=torch.where(active, numerical_error,
                                    state.numerical_error),
        total_number_iterations=torch.where(
            active, total, state.total_number_iterations),
        cumulative_kkt_passes=torch.where(
            active, state.cumulative_kkt_passes + 1.0,
            state.cumulative_kkt_passes),
    )


def _take_step_constant(
    problem, state: PdhgState, params: ConstantStepsizeParams, active
) -> PdhgState:
    """Reference: pdhg.jl:733-767: always accepted, one KKT pass; a step
    where the 0-d bool `active` is false leaves the state bitwise as it
    was (counters on the device, as in _take_step_adaptive)."""
    next_x = _compute_next_primal(
        problem, state.current_primal_solution, state.current_dual_product,
        state.step_size, state.primal_weight,
    )
    next_y, next_aty = _compute_next_dual(
        problem, state.current_primal_solution, next_x,
        state.current_dual_solution, state.step_size, state.primal_weight,
    )
    stepped = _accepted_where(active, state, next_x, next_y, next_aty)
    return dataclasses.replace(
        stepped,
        cumulative_kkt_passes=torch.where(
            active, state.cumulative_kkt_passes + 1.0,
            state.cumulative_kkt_passes),
        total_number_iterations=torch.where(
            active, state.total_number_iterations + 1,
            state.total_number_iterations),
    )


MALITSKY_POCK_MAX_TRIALS = 60


def _take_step_malitsky_pock(
    problem, state: PdhgState, params: MalitskyPockStepsizeParameters
) -> PdhgState:
    """Malitsky-Pock linesearch, LP only (reference pdhg.jl:551-647).

    The dual-side linesearch accepts iff
    step_size ||A'(y+ - y)|| <= breaking_factor ||y+ - y||; at most 60
    inner trials (half a KKT pass each, after half a pass for the primal
    step), otherwise a numerical error is flagged. Each trial's decision
    is read back to the host, as in the adaptive rule."""
    entry_step = state.step_size
    x = state.current_primal_solution
    y = state.current_dual_solution
    next_x = _compute_next_primal(
        problem, x, state.current_dual_product, entry_step,
        state.primal_weight,
    )
    kkt = state.cumulative_kkt_passes + 0.5
    total = state.total_number_iterations
    step_size = entry_step + params.interpolation_coefficient * (
        torch.sqrt(1.0 + state.ratio_step_sizes) - 1.0
    ) * entry_step
    accepted = False
    for _ in range(MALITSKY_POCK_MAX_TRIALS):
        total += 1
        kkt += 0.5
        ratio = step_size / entry_step
        next_y, next_aty = _compute_next_dual(
            problem, x, next_x, y, step_size, state.primal_weight,
            extrapolation_coefficient=ratio,
        )
        delta_dual = next_y - y
        delta_aty = next_aty - state.current_dual_product
        accept = step_size * torch.sqrt(
            torch.sum(delta_aty * delta_aty)
        ) <= params.breaking_factor * torch.sqrt(
            torch.sum(delta_dual * delta_dual)
        )
        if bool(accept.item()):
            accepted = True
            break
        step_size = step_size * params.downscaling_factor
    if not accepted:
        # 60 rejections: flag a numerical error and leave the iterates,
        # the step size and the ratio as they were (reference
        # pdhg.jl:640-643).
        return dataclasses.replace(
            state,
            numerical_error=True,
            total_number_iterations=total,
            cumulative_kkt_passes=kkt,
        )
    if state.avg.sum_primal_solutions_count == 0:
        # Nonsymmetric averaging: the very first accepted step also adds
        # the pre-step primal iterate with weight step_size * ratio
        # (reference pdhg.jl:617-627).
        state = dataclasses.replace(
            state,
            avg=add_to_primal_solution_weighted_average(
                state.avg, x, step_size * ratio
            ),
        )
    return dataclasses.replace(
        _accept_solution(state, next_x, next_y, next_aty),
        step_size=step_size,
        ratio_step_sizes=ratio,
        iteration=state.iteration + 1,
        total_number_iterations=total,
        cumulative_kkt_passes=kkt,
    )


def _trial(problem, state: PdhgState, policy, active) -> PdhgState:
    """One masked trial of the adaptive or the constant step rule."""
    if isinstance(policy, AdaptiveStepsizeParams):
        return _take_step_adaptive(problem, state, policy, active)
    return _take_step_constant(problem, state, policy, active)


# ---------------------------------------------------------------------------
# Evaluation block and segment
# ---------------------------------------------------------------------------

KKT_PASSES_PER_TERMINATION_EVALUATION = 2.0


def _is_eval_iteration(iteration, config: _PdhgConfig):
    """Host ints or 0-d tensors alike."""
    freq = config.termination_evaluation_frequency
    return (
        ((iteration - 1) % freq == 0)
        | (iteration == config.criteria.iteration_limit + 1)
        | (iteration <= 10)
    )


def _norm_params(state: PdhgState):
    """define_norms (reference pdhg.jl:260-276)."""
    primal = (
        (1.0 / state.step_size)
        * state.primal_weight
        * torch.ones_like(state.current_primal_solution)
    )
    dual = (
        (1.0 / state.step_size)
        / state.primal_weight
        * torch.ones_like(state.current_dual_solution)
    )
    return primal, dual


def _eval_block(bundle: DeviceScaledQp, state: PdhgState, elapsed_time,
                config: _PdhgConfig):
    kkt = state.cumulative_kkt_passes + KKT_PASSES_PER_TERMINATION_EVALUATION
    avg = state.avg
    has_avg = (
        not state.numerical_error
        and avg.sum_primal_solutions_count > 0
        and avg.sum_dual_solutions_count > 0
    )
    if has_avg:
        avg_primal, avg_dual = compute_average(avg)
    else:
        avg_primal = state.current_primal_solution
        avg_dual = state.current_dual_solution

    conv, infeas, reason_t = evaluate_unscaled_stats(
        bundle,
        config.criteria,
        avg_primal,
        avg_dual,
        state.numerical_error,
        state.iteration - 1,
        kkt,
        elapsed_time,
    )
    primal_norm_params, dual_norm_params = _norm_params(state)
    if config.need_bound_estimates:
        lagrangian, est_lb, est_ub = update_objective_bound_estimates(
            bundle.scaled, avg_primal, avg_dual, primal_norm_params,
            dual_norm_params,
        )
    else:
        zero = torch.zeros((), dtype=avg_primal.dtype, device=avg_primal.device)
        lagrangian, est_lb, est_ub = zero, zero, zero

    reason = int(reason_t.item())
    if reason != 0:
        new_state = state
        restart_used = int(RestartChoice.RESTART_CHOICE_UNSPECIFIED)
    else:
        restart = run_restart_scheme(
            bundle.scaled,
            state.avg,
            state.current_primal_solution,
            state.current_dual_solution,
            state.restart_info,
            state.iteration - 1,
            primal_norm_params,
            dual_norm_params,
            state.primal_weight,
            config.restart_params,
        )
        restart_used = restart.restart_choice
        restarted = (
            restart.restart_choice
            != RestartChoice.RESTART_CHOICE_NO_RESTART
        )
        new_state = dataclasses.replace(
            state,
            current_primal_solution=restart.primal_solution,
            current_dual_solution=restart.dual_solution,
            avg=restart.avg,
            restart_info=restart.restart_info,
        )
        if restarted:
            new_state = dataclasses.replace(
                new_state,
                primal_weight=compute_new_primal_weight(
                    restart.restart_info,
                    state.primal_weight,
                    config.restart_params.primal_weight_update_smoothing,
                ),
                ratio_step_sizes=torch.ones_like(state.ratio_step_sizes),
            )
        if (
            restart.restart_choice
            == RestartChoice.RESTART_CHOICE_RESTART_TO_AVERAGE
        ):
            new_state = dataclasses.replace(
                new_state,
                current_dual_product=bundle.scaled.aty(
                    restart.dual_solution
                ),
            )
    new_state = dataclasses.replace(
        new_state,
        cumulative_kkt_passes=kkt,
        termination_reason=reason,
        avg_primal_out=avg_primal,
        avg_dual_out=avg_dual,
    )
    result = EvalResult(
        conv=conv,
        infeas=infeas,
        lagrangian_value=lagrangian,
        estimated_lower_bound=est_lb,
        estimated_upper_bound=est_ub,
        termination_reason=reason,
        restart_used=restart_used,
        iteration=state.iteration - 1,
        cumulative_kkt_passes=kkt,
        step_size=state.step_size,
        primal_weight=state.primal_weight,
    )
    return new_state, result


# The PdhgState fields a trial reads or writes (ops/graphs.StepGraph).
TRIAL_FIELDS = (
    "current_primal_solution", "current_dual_solution", "delta_primal",
    "delta_dual", "current_dual_product", "avg", "step_size",
    "primal_weight", "numerical_error", "cumulative_kkt_passes",
    "total_number_iterations", "iteration",
)


def _device_counters(state: PdhgState) -> PdhgState:
    """The state with its counters and flag as 0-d tensors on its
    device, for the masked trials."""
    device = state.step_size.device
    avg = state.avg

    def scalar(value, dtype):
        return torch.full((), value, dtype=dtype, device=device)

    return dataclasses.replace(
        state,
        avg=dataclasses.replace(
            avg,
            sum_primal_solutions_count=scalar(
                int(avg.sum_primal_solutions_count), torch.int64),
            sum_dual_solutions_count=scalar(
                int(avg.sum_dual_solutions_count), torch.int64),
        ),
        numerical_error=scalar(bool(state.numerical_error), torch.bool),
        cumulative_kkt_passes=scalar(float(state.cumulative_kkt_passes),
                                     torch.float64),
        total_number_iterations=scalar(int(state.total_number_iterations),
                                       torch.int64),
        iteration=scalar(int(state.iteration), torch.int64),
    )


def _trial_active(state: PdhgState, start, config: _PdhgConfig):
    """The JAX package's while predicate over a segment's trials, on the
    device; its termination_reason term is the host's (trials run only
    while the reason is 0)."""
    return ~state.numerical_error & (
        (state.iteration == start)
        | ~_is_eval_iteration(state.iteration, config)
    )


def _masked_trial(problem, config: _PdhgConfig, state: PdhgState, start):
    return _trial(problem, state, config.step_policy,
                  _trial_active(state, start, config))


def _read_back(state: PdhgState, start, target: int, config: _PdhgConfig):
    """One transfer: (active, accepted steps still needed, iteration,
    total_number_iterations, cumulative_kkt_passes, numerical_error,
    the average's two counts). f64 holds every counter exactly."""
    avg = state.avg
    values = (
        _trial_active(state, start, config), target - state.iteration,
        state.iteration, state.total_number_iterations,
        state.cumulative_kkt_passes, state.numerical_error,
        avg.sum_primal_solutions_count, avg.sum_dual_solutions_count,
    )
    return torch.stack([v.to(torch.float64) for v in values]).tolist()


def _run_trials(bundle: DeviceScaledQp, state: PdhgState,
                config: _PdhgConfig, _eager: bool = False) -> PdhgState:
    """The step trials of one segment, from its evaluation iteration to
    the next (the JAX package's while_loop in _segment_core), in rounds
    as batch.run_segment: `need` masked trials back to back with no
    read-back, `need` being the accepted steps still needed (the whole
    segment at first), then one read-back of the predicate, `need` and
    the counters. A segment with no rejection makes one read-back.

    On the f32 kernel operator on a CUDA device (ops/graphs.graphable)
    each trial is a replay of the bundle's captured trial; everything
    else runs the same masked trials eagerly. `_eager` runs them eagerly
    there too, for the smoke's parity phase only. The state comes back
    with host counters, as it came in."""
    problem = bundle.scaled
    start = state.iteration
    target = next_eval_iteration(start, config)
    dstate = _device_counters(state)
    start_t = torch.full((), start, dtype=torch.int64,
                         device=dstate.step_size.device)
    graph = None
    if graphs.graphable(problem) and not _eager:
        key = ("pdhg", config.step_policy,
               config.termination_evaluation_frequency,
               int(config.criteria.iteration_limit))
        graph = graphs.cached(bundle, key, lambda: graphs.StepGraph(
            functools.partial(_masked_trial, problem, config), dstate,
            TRIAL_FIELDS, (start_t,)))
        graph.load(dstate, start_t)
    need, read_backs = target - start, 0
    while True:
        if graph is not None:
            graph.replay(need)
            current = graph.view(dstate)
        else:
            for _ in range(need):
                dstate = _masked_trial(problem, config, dstate, start_t)
            current = dstate
        graphs.COUNTS["steps"] += need
        values = _read_back(current, start_t, target, config)
        read_backs += 1
        if not values[0]:
            break
        need = int(values[1])
    graphs.COUNTS["segments"] += 1
    graphs.COUNTS["read_backs"] += read_backs
    if graph is not None:
        dstate = graph.unload(dstate)
    (_, _, iteration, total, kkt, error, count_primal,
     count_dual) = values
    return dataclasses.replace(
        dstate,
        avg=dataclasses.replace(
            dstate.avg,
            sum_primal_solutions_count=int(count_primal),
            sum_dual_solutions_count=int(count_dual),
        ),
        numerical_error=bool(error),
        cumulative_kkt_passes=kkt,
        total_number_iterations=int(total),
        iteration=int(iteration),
    )


def _segment_core(bundle: DeviceScaledQp, state: PdhgState, elapsed_time,
                  config: _PdhgConfig, _eager: bool = False):
    """One evaluation + the step trials up to the next evaluation point:
    at least one accepted step, since the segment begins at an
    evaluation iteration. Malitsky-Pock's line search keeps its host
    loop (a read-back a trial); the other rules run _run_trials."""
    state, result = _eval_block(bundle, state, elapsed_time, config)
    if state.termination_reason != 0 or state.numerical_error:
        return state, result
    if not isinstance(config.step_policy, MalitskyPockStepsizeParameters):
        return _run_trials(bundle, state, config, _eager), result
    start_iteration = state.iteration
    while not state.numerical_error and (
        state.iteration == start_iteration
        or not _is_eval_iteration(state.iteration, config)
    ):
        state = _take_step_malitsky_pock(bundle.scaled, state,
                                         config.step_policy)
    return state, result


def _final_bound_estimates(bundle, avg_primal, avg_dual, step_size,
                           primal_weight):
    """One-shot recovery of the objective-bound estimates for the final
    stats entry when config.need_bound_estimates skipped them in-loop."""
    primal_norm_params = (
        (1.0 / step_size) * primal_weight * torch.ones_like(avg_primal)
    )
    dual_norm_params = (
        (1.0 / step_size) / primal_weight * torch.ones_like(avg_dual)
    )
    return update_objective_bound_estimates(
        bundle.scaled, avg_primal, avg_dual, primal_norm_params,
        dual_norm_params,
    )


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreparedProblem:
    """Ingested problem (rescaled + device bundle + initial state)."""

    scaled_problem: object
    bundle: DeviceScaledQp
    initial_state: PdhgState
    device: torch.device


def prepare_problem(
    params: PdhgParameters,
    original_problem: QuadraticProgrammingProblem,
    warm_start=None,
    device=None,
    _reuse: "PreparedProblem | None" = None,
    _shard_plan=None,
) -> PreparedProblem:
    """Validates, rescales and moves `original_problem` to `device` for
    `optimize` (reference: the rescaling step of optimize, pdhg.jl:
    769-819, split out for reuse). `device` defaults to CUDA and raises
    when no GPU is present.

    warm_start: optional (primal, dual) in UNSCALED space; the solver
    starts from that point instead of zeros.

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
    elif _shard_plan is not None and device is None:
        device = _shard_plan.mesh.home_device
    else:
        device = resolve_device(device)
    validate(original_problem)
    if isinstance(
        params.step_size_policy_params, MalitskyPockStepsizeParameters
    ) and original_problem.objective_matrix.nnz > 0:
        raise ValueError(
            "Malitsky and Pock linesearch is only supported for linear"
            " programming problems."
        )
    dtype = torch_dtype(params.dtype)
    stats_dtype = (
        torch_dtype(params.stats_dtype) if params.stats_dtype else None
    )
    if _reuse is not None and (
        _reuse.bundle.original.objective_vector.dtype
        == (stats_dtype or dtype)
    ):
        scaled_problem = _reuse.scaled_problem
        bundle = dataclasses.replace(
            _reuse.bundle,
            scaled=to_device(
                scaled_problem.scaled_qp, dtype, params.matrix_format,
                device, shard_plan=_shard_plan,
            ),
        )
    else:
        scaled_problem = rescale_problem(
            params.l_inf_ruiz_iterations,
            params.l2_norm_rescaling,
            params.pock_chambolle_alpha,
            params.verbosity,
            original_problem,
            bound_width_rescaling_flag=params.bound_width_rescaling,
        )
        bundle = to_device_scaled(
            scaled_problem,
            dtype,
            params.matrix_format,
            device,
            stats_dtype=stats_dtype,
            stats_format=params.stats_matrix_format,
            shard_plan=_shard_plan,
        )

    state = _initial_state(bundle, dtype, device)
    cumulative_kkt_passes = 0.0
    if isinstance(
        params.step_size_policy_params,
        (AdaptiveStepsizeParams, MalitskyPockStepsizeParameters),
    ):
        cumulative_kkt_passes += 0.5
        inf_norm = matrix_inf_norm_entrywise(
            scaled_problem.scaled_qp.constraint_matrix
        )
        step_size = 1.0 / inf_norm if inf_norm > 0 else 1.0
    else:
        desired_relative_error = 0.2
        max_singular_value, num_iters = estimate_maximum_singular_value(
            scaled_problem.scaled_qp.constraint_matrix,
            probability_of_failure=0.001,
            desired_relative_error=desired_relative_error,
        )
        step_size = (1.0 - desired_relative_error) / max_singular_value
        cumulative_kkt_passes += num_iters

    primal_weight = initial_primal_weight_host(
        scaled_problem.scaled_qp,
        params.primal_importance,
        params.scale_invariant_initial_primal_weight,
        params.verbosity,
    )
    state = dataclasses.replace(
        state,
        step_size=torch.full((), float(step_size), dtype=dtype,
                             device=device),
        primal_weight=torch.full((), float(primal_weight), dtype=dtype,
                                 device=device),
        cumulative_kkt_passes=float(cumulative_kkt_passes),
    )
    if warm_start is not None:
        primal0, dual0 = warm_start
        x0 = torch.as_tensor(
            np.asarray(primal0)
            * np.asarray(scaled_problem.variable_rescaling),
            device=device,
        ).to(dtype)
        y0 = torch.as_tensor(
            np.asarray(dual0)
            * np.asarray(scaled_problem.constraint_rescaling),
            device=device,
        ).to(dtype)
        state = dataclasses.replace(
            state,
            current_primal_solution=x0,
            current_dual_solution=y0,
            current_dual_product=bundle.scaled.aty(y0),
            restart_info=create_last_restart_info(x0, y0),
            cumulative_kkt_passes=state.cumulative_kkt_passes + 0.5,
        )
    return PreparedProblem(
        scaled_problem=scaled_problem,
        bundle=bundle,
        initial_state=state,
        device=device,
    )


def _make_config(params: PdhgParameters) -> _PdhgConfig:
    return _PdhgConfig(
        criteria=params.termination_criteria,
        restart_params=params.restart_params,
        step_policy=params.step_size_policy_params,
        termination_evaluation_frequency=int(
            params.termination_evaluation_frequency
        ),
        need_bound_estimates=bool(
            params.record_iteration_stats or params.verbosity > 0
        ),
    )


def optimize(
    params: PdhgParameters,
    original_problem: QuadraticProgrammingProblem,
    prepared: "PreparedProblem | None" = None,
    device=None,
    _elapsed_offset: float = 0.0,
    _placement=None,
    _shard_plan=None,
) -> SaddlePointOutput:
    """Solves a QP with PDHG (reference optimize, pdhg.jl:769-1049).

    Runs on CUDA unless `device` names another device; raises when no
    GPU is present and no device was asked for. `prepared` (from
    prepare_problem on the SAME problem and params) skips ingest.
    `_elapsed_offset` pre-charges the time-limit clock (refine.py: a
    sub-solve's budget is what remains of the caller's declared
    time_sec_limit).

    `_placement` (parallel.sharded.make_placement): a function
    (bundle, state) -> (bundle, state) applied before the loop starts.
    `_shard_plan` (parallel.sharded): the constraint operator is built
    block-partitioned over the plan's mesh at ingest. Under a process
    group the time limit reads rank 0's clock on every rank
    (ops/routed_sharded.agreed_seconds)."""
    validate_termination_criteria(params.termination_criteria)
    if params.primal_importance <= 0 or not np.isfinite(
        params.primal_importance
    ):
        raise ValueError("primal_importance must be positive and finite")
    if prepared is None:
        prepared = prepare_problem(params, original_problem, device=device,
                                   _shard_plan=_shard_plan)
    scaled_problem = prepared.scaled_problem
    bundle = prepared.bundle
    state = prepared.initial_state
    config = _make_config(params)

    problem_fp = None
    if params.checkpoint_path or params.resume_from_checkpoint:
        from ..checkpoint import problem_fingerprint

        problem_fp = problem_fingerprint(original_problem)
    elapsed_offset = float(_elapsed_offset)
    if params.resume_from_checkpoint:
        from ..checkpoint import load_state

        state, elapsed_offset, _ = load_state(
            params.resume_from_checkpoint, state, fingerprint=problem_fp
        )
        # The previous run's termination (e.g. its iteration limit) does
        # not apply to this run's criteria; re-evaluate from scratch.
        state = dataclasses.replace(state, termination_reason=0)
    if _placement is not None:
        bundle, state = _placement(bundle, state)

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

    with _profiler_trace(params.profiler_trace_dir, prepared.device):
        iteration_stats = []
        start_time = time.time() - elapsed_offset
        basic_algorithm_time = 0.0
        evals_per_dispatch = max(1, int(params.evaluations_per_dispatch))
        checkpoint_every = max(1, int(params.checkpoint_every_n_dispatches))
        dispatch_count = 0
        while True:
            elapsed = agreed_seconds(
                bundle.scaled.constraint_matrix, time.time() - start_time
            )
            segment_start = time.time()
            state, result = _segment_core(bundle, state, elapsed, config)
            k = 1
            while result.termination_reason == 0 and k < evals_per_dispatch:
                state, result = _segment_core(bundle, state, elapsed, config)
                k += 1
            terminated = result.termination_reason != 0
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
            if terminated and not config.need_bound_estimates:
                # The eval block skipped the diagnostics-only bound estimates;
                # recover them once for the final stats entry.
                lagr, est_lb, est_ub = _final_bound_estimates(
                    bundle,
                    state.avg_primal_out,
                    state.avg_dual_out,
                    result.step_size,
                    result.primal_weight,
                )
                result = result._replace(
                    lagrangian_value=lagr,
                    estimated_lower_bound=est_lb,
                    estimated_upper_bound=est_ub,
                )
            result = host_floats(result)
            eval_iteration = result.iteration  # = displayed iteration - 1
            if params.checkpoint_path and (
                dispatch_count % checkpoint_every == 0 or terminated
            ):
                checkpoint(state, {"iteration": eval_iteration + 1})
            method_specific_stats = {
                "time_spent_doing_basic_algorithm": basic_algorithm_time,
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
                True if terminated else False,
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
                output = unscaled_saddle_point_output(
                    scaled_problem,
                    state.avg_primal_out,
                    state.avg_dual_out,
                    reason,
                    eval_iteration,
                    iteration_stats,
                )
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
