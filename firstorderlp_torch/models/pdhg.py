"""Primal-dual hybrid gradient (PDHG / PDLP) solver in PyTorch.

Reference semantics: src/primal_dual_hybrid_gradient.jl, as ported by the
JAX package's models/pdhg.py. The step rules, restart machinery and
KKT-pass accounting are the same; the execution model is eager PyTorch:

- the problem and the solver state are dataclasses of tensors on one
  device; the loop counters and flags are 0-d tensors there too,
- a *dispatch* runs up to `evaluations_per_dispatch` segments, as the
  JAX package's _run_segments does: each segment is one termination /
  restart evaluation (_eval_block, every decision a torch.where), then
  the masked step trials up to the next evaluation iteration in rounds
  (_run_trials), with one read-back a round that also carries the
  evaluation's termination reason; Malitsky-Pock's line search keeps a
  host loop,
- on the f32 LP path with the kernel operator, each trial is four
  CUDA kernels: F1a (ops/pdhg_step.primal_step), the fused dual step
  and A'y+ with the step-control sums (ops/routed.py: mv_dual_step,
  rmv_stats), and F1b (ops/pdhg_step.trial_epilogue); on a CUDA device
  the evaluation and each trial are replays of two CUDA graphs captured
  once on the device bundle, on one set of buffers that holds the state
  for the whole dispatch (ops/graphs.py).

Step rules (tau = step/omega, sigma = step*omega; reference pdhg.jl:100-107):
    x+ = proj_[l,u](x - tau (Qx + c - A'y))
    y+ = proj_{>=0 on ineq}(y + sigma (b - A(2x+ - x)))
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from .. import spans
from ..ops import graphs, pdhg_step
from ..ops.device_problem import DeviceScaledQp
from ..ops.routed import RoutedOp
from ..problem import QuadraticProgrammingProblem
from ..saddle_point import (
    RestartInfo,
    RestartParameters,
    SaddlePointOutput,
    SolutionWeightedAverage,
    add_to_primal_solution_weighted_average,
    add_to_solution_weighted_average,
    compute_dual_gradient,
    compute_new_primal_weight,
    compute_primal_gradient_from_dual_product,
    create_last_restart_info,
    initialize_solution_weighted_average,
    project_dual,
    project_primal,
    run_restart_scheme,
    select_fields,
    unscaled_saddle_point_output,
    update_objective_bound_estimates,
)
from ..solve_log import RestartChoice
from ..termination import TerminationCriteria, validate_termination_criteria
from .common import (
    EvalResult,
    PreparedProblem,
    estimate_maximum_singular_value,
    device_counters,
    evaluate_statistics,
    graph_key,
    ingest,
    initial_primal_weight_host,
    matrix_inf_norm_entrywise,
    next_eval_iteration,
    scaled_warm_start,
    select_average,
    solve,
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
    flags and the average's counts are 0-d tensors on the state's device
    (_device_counters)."""

    current_primal_solution: torch.Tensor
    current_dual_solution: torch.Tensor
    delta_primal: torch.Tensor
    delta_dual: torch.Tensor
    current_dual_product: torch.Tensor  # cache of A' y
    avg: SolutionWeightedAverage
    restart_info: RestartInfo
    step_size: torch.Tensor  # 0-d
    primal_weight: torch.Tensor  # 0-d
    numerical_error: torch.Tensor  # 0-d bool
    cumulative_kkt_passes: torch.Tensor  # 0-d float64
    total_number_iterations: torch.Tensor  # 0-d int64, rejected trials too
    ratio_step_sizes: torch.Tensor  # 0-d, Malitsky-Pock only
    iteration: torch.Tensor  # 0-d int64, outer iteration due for processing
    termination_reason: torch.Tensor  # 0-d int32, 0 = running
    avg_primal_out: torch.Tensor  # scaled-space candidate at last eval
    avg_dual_out: torch.Tensor


def _initial_state(bundle: DeviceScaledQp, dtype, device) -> PdhgState:
    n = bundle.scaled.num_variables
    m = bundle.scaled.num_constraints

    def zeros(size):
        return torch.zeros(size, dtype=dtype, device=device)

    def scalar(v, kind=dtype):
        return torch.full((), v, dtype=kind, device=device)

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
        numerical_error=scalar(False, torch.bool),
        cumulative_kkt_passes=scalar(0.0, torch.float64),
        total_number_iterations=scalar(0, torch.int64),
        ratio_step_sizes=scalar(1.0),
        iteration=scalar(1, torch.int64),
        termination_reason=scalar(0, torch.int32),
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
    return _next_dual_at(problem, extrapolated, y,
                         primal_weight * step_size)


def _next_dual_at(problem, extrapolated, y, sigma):
    """(y+, A'y+) with y+ = proj(y + sigma (b - A extrapolated))."""
    next_y = project_dual(
        y + sigma * compute_dual_gradient(problem, extrapolated), problem
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
    return pdhg_step.step_size_factors(total, params.reduction_exponent,
                                       params.growth_exponent, dtype)


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
    (reference pdhg.jl:649-731), with no read-back, on the eager paths
    (the f32 kernel operator's LP trial is _fused_trial). Each trial
    costs one KKT pass. Accept iff step_size <= movement / interaction;
    on accept the iterate and `iteration` advance, on reject only the
    step size shrinks. The KKT-pass and total_number_iterations
    accounting is the reference's inner loop's.

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


def _malitsky_pock_step(
    problem, state: PdhgState, params: MalitskyPockStepsizeParameters
):
    """Malitsky-Pock linesearch, LP only (reference pdhg.jl:551-647).

    The dual-side linesearch accepts iff
    step_size ||A'(y+ - y)|| <= breaking_factor ||y+ - y||; at most 60
    inner trials (half a KKT pass each, after half a pass for the primal
    step), otherwise a numerical error is flagged. Each trial's decision
    is read back to the host. Returns (state, accepted) with `accepted`
    a host bool; the counters stay 0-d device tensors."""
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
        total = total + 1
        kkt = kkt + 0.5
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
            numerical_error=torch.ones_like(state.numerical_error),
            total_number_iterations=total,
            cumulative_kkt_passes=kkt,
        ), False
    # Nonsymmetric averaging: the very first accepted step also adds the
    # pre-step primal iterate with weight step_size * ratio (reference
    # pdhg.jl:617-627).
    state = dataclasses.replace(
        state,
        avg=select_average(
            state.avg.sum_primal_solutions_count == 0,
            add_to_primal_solution_weighted_average(
                state.avg, x, step_size * ratio),
            state.avg,
        ),
    )
    return dataclasses.replace(
        _accept_solution(state, next_x, next_y, next_aty),
        step_size=step_size,
        ratio_step_sizes=ratio,
        iteration=state.iteration + 1,
        total_number_iterations=total,
        cumulative_kkt_passes=kkt,
    ), True


def _take_step_malitsky_pock(
    problem, state: PdhgState, params: MalitskyPockStepsizeParameters
) -> PdhgState:
    """One Malitsky-Pock step (_malitsky_pock_step), the state only."""
    return _malitsky_pock_step(problem, state, params)[0]


def _trial(problem, state: PdhgState, policy, active) -> PdhgState:
    """One masked trial of the adaptive or the constant step rule, on
    the eager paths."""
    if isinstance(policy, AdaptiveStepsizeParams):
        return _take_step_adaptive(problem, state, policy, active)
    return _take_step_constant(problem, state, policy, active)


def _fused(problem, state: PdhgState) -> bool:
    """Whether a trial on `problem` runs _fused_trial: the kernel
    operator (RoutedOp, CSR or tile plan), an LP, f32."""
    return (
        isinstance(problem.constraint_matrix, RoutedOp)
        and problem.objective_matrix is None
        and state.current_primal_solution.dtype == torch.float32
    )


def _trial_fields(state: PdhgState) -> pdhg_step.TrialFields:
    avg = state.avg
    return pdhg_step.TrialFields(
        x=state.current_primal_solution, y=state.current_dual_solution,
        delta_x=state.delta_primal, delta_y=state.delta_dual,
        aty=state.current_dual_product, sum_x=avg.sum_primal_solutions,
        sum_y=avg.sum_dual_solutions,
        count_x=avg.sum_primal_solutions_count,
        count_y=avg.sum_dual_solutions_count,
        weight_x=avg.sum_primal_solution_weights,
        weight_y=avg.sum_dual_solution_weights, step_size=state.step_size,
        primal_weight=state.primal_weight,
        numerical_error=state.numerical_error,
        total=state.total_number_iterations, iteration=state.iteration,
        kkt=state.cumulative_kkt_passes,
    )


def _fused_trial(problem, config: _PdhgConfig, state: PdhgState,
                 start) -> PdhgState:
    """The segment's masked trial on the f32 kernel operator (_fused):
    F1a (the primal step, the extrapolation, sigma and the mask
    _trial_active), then for adaptive steps the fused dual step and A'y+
    with the step-control sums (B3 and B4, or B6 and B7 on the tile
    plan), for constant steps the dual step on two B2 products as in
    _take_step_constant, then F1b (the accept test, the step size, the
    counters and the selected state). The bits of _take_step_adaptive
    with the fused dual step, and of _take_step_constant."""
    policy = config.step_policy
    constant = isinstance(policy, ConstantStepsizeParams)
    next_x, z, dx, sigma, active = pdhg_step.primal_step(
        state.current_primal_solution, problem.objective_vector,
        state.current_dual_product, problem.variable_lower_bound,
        problem.variable_upper_bound, state.step_size, state.primal_weight,
        state.termination_reason, state.numerical_error, state.iteration,
        start, config.termination_evaluation_frequency,
        config.criteria.iteration_limit, constant,
    )
    if constant:
        next_y, next_aty = _next_dual_at(
            problem, z, state.current_dual_solution, sigma)
        sums, exponents = (None, None, None), (0.0, 0.0)
    else:
        op = problem.constraint_matrix
        next_y, y_next_layout, dy2 = op.mv_dual_step(
            z, state.current_dual_solution, problem.right_hand_side,
            problem.is_equality_f32, sigma,
        )
        next_aty, interaction, dx2 = op.rmv_stats(
            y_next_layout, dx, state.current_dual_product)
        sums = (dy2, interaction, dx2)
        exponents = (policy.reduction_exponent, policy.growth_exponent)
    f = pdhg_step.trial_epilogue(
        _trial_fields(state), next_x, dx, next_y, next_aty, *sums, active,
        *exponents, constant,
    )
    return dataclasses.replace(
        state,
        current_primal_solution=f.x,
        current_dual_solution=f.y,
        delta_primal=f.delta_x,
        delta_dual=f.delta_y,
        current_dual_product=f.aty,
        avg=SolutionWeightedAverage(
            f.sum_x, f.sum_y, f.count_x, f.count_y, f.weight_x, f.weight_y),
        step_size=f.step_size,
        numerical_error=f.numerical_error,
        total_number_iterations=f.total,
        iteration=f.iteration,
        cumulative_kkt_passes=f.kkt,
    )


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
    """The JAX package's _eval_block (pdhg.py:577-721 there) line for
    line: the statistics, the termination check, the bound estimates and
    the restart scheme on the device, every decision a torch.where
    (`terminated`, `restarted`, `reset_to_avg`, and the freeze of a state
    that had already terminated), so nothing is read back. A'y of the
    restarted dual is computed every evaluation and kept where the
    restart goes to the average. `elapsed_time`: seconds, a number or a
    0-d f64 tensor."""
    # Idempotence: a state that terminated in a previous segment must not
    # accumulate KKT passes or flip its reason.
    entry_state = state
    already_terminated = state.termination_reason != 0
    kkt = state.cumulative_kkt_passes + KKT_PASSES_PER_TERMINATION_EVALUATION
    iteration = state.iteration - 1
    avg_primal, avg_dual, conv, infeas, reason = evaluate_statistics(
        bundle, config.criteria, state, state.current_primal_solution,
        state.current_dual_solution, iteration, kkt, elapsed_time)
    primal_norm_params, dual_norm_params = _norm_params(state)
    if config.need_bound_estimates:
        lagrangian, est_lb, est_ub = update_objective_bound_estimates(
            bundle.scaled, avg_primal, avg_dual, primal_norm_params,
            dual_norm_params,
        )
    else:
        zero = torch.zeros((), dtype=avg_primal.dtype, device=avg_primal.device)
        lagrangian, est_lb, est_ub = zero, zero, zero

    terminated = reason != 0
    restart = run_restart_scheme(
        bundle.scaled,
        state.avg,
        state.current_primal_solution,
        state.current_dual_solution,
        state.restart_info,
        iteration,
        primal_norm_params,
        dual_norm_params,
        state.primal_weight,
        config.restart_params,
    )
    restarted = restart.restart_choice != int(
        RestartChoice.RESTART_CHOICE_NO_RESTART
    )
    new_primal_weight = torch.where(
        restarted,
        compute_new_primal_weight(
            restart.restart_info,
            state.primal_weight,
            config.restart_params.primal_weight_update_smoothing,
        ),
        state.primal_weight,
    )
    new_ratio = torch.where(restarted, 1.0, state.ratio_step_sizes)
    reset_to_avg = restart.restart_choice == int(
        RestartChoice.RESTART_CHOICE_RESTART_TO_AVERAGE
    )
    new_dual_product = torch.where(
        reset_to_avg,
        bundle.scaled.aty(restart.dual_solution),
        state.current_dual_product,
    )
    post_restart = dataclasses.replace(
        state,
        current_primal_solution=restart.primal_solution,
        current_dual_solution=restart.dual_solution,
        avg=restart.avg,
        restart_info=restart.restart_info,
        primal_weight=new_primal_weight,
        ratio_step_sizes=new_ratio,
        current_dual_product=new_dual_product,
    )
    new_state = select_fields(terminated, state, post_restart)
    new_state = dataclasses.replace(
        new_state,
        cumulative_kkt_passes=kkt,
        termination_reason=reason,
        avg_primal_out=avg_primal,
        avg_dual_out=avg_dual,
    )
    new_state = select_fields(already_terminated, entry_state, new_state)
    result = EvalResult(
        conv=conv,
        infeas=infeas,
        lagrangian_value=lagrangian,
        estimated_lower_bound=est_lb,
        estimated_upper_bound=est_ub,
        termination_reason=new_state.termination_reason,
        restart_used=torch.where(
            terminated | already_terminated,
            int(RestartChoice.RESTART_CHOICE_UNSPECIFIED),
            restart.restart_choice,
        ).to(torch.int32),
        iteration=iteration,
        cumulative_kkt_passes=new_state.cumulative_kkt_passes,
        step_size=state.step_size,
        primal_weight=state.primal_weight,
    )
    return new_state, result


# The counters and flags of a PdhgState and their dtypes on the device.
COUNTER_DTYPES = {
    "numerical_error": torch.bool,
    "cumulative_kkt_passes": torch.float64,
    "total_number_iterations": torch.int64,
    "iteration": torch.int64,
    "termination_reason": torch.int32,
}


def _device_counters(state: PdhgState) -> PdhgState:
    """The state with its counters and flags on the device
    (common.device_counters)."""
    return device_counters(state, COUNTER_DTYPES)


def _trial_active(state: PdhgState, start, config: _PdhgConfig):
    """The JAX package's while predicate over a segment's trials, on the
    device: no trial runs once the evaluation has set a termination
    reason."""
    return (
        (state.termination_reason == 0)
        & ~state.numerical_error
        & ((state.iteration == start)
           | ~_is_eval_iteration(state.iteration, config))
    )


def _masked_trial(problem, config: _PdhgConfig, state: PdhgState, start):
    if _fused(problem, state):
        return _fused_trial(problem, config, state, start)
    return _trial(problem, state, config.step_policy,
                  _trial_active(state, start, config))


def _read_back(state: PdhgState, start, target: int, config: _PdhgConfig):
    """One transfer: (active, accepted steps still needed, iteration,
    termination_reason), host ints."""
    values = (
        _trial_active(state, start, config), target - state.iteration,
        state.iteration, state.termination_reason,
    )
    with spans.span("folp.read_back"):
        return [int(v) for v in
                torch.stack([v.to(torch.int64) for v in values]).tolist()]


def _runner(bundle: DeviceScaledQp, state: PdhgState, elapsed_time,
            config: _PdhgConfig, _eager: bool) -> graphs.SegmentRunner:
    """The dispatch's evaluation and masked trial on `state`: replayed
    from the bundle's graphs on the f32 kernel operator on a CUDA device
    (ops/graphs.bundle_graphable), else eager. `_eager` runs them eagerly
    there too, for the parity checks only."""
    problem = bundle.scaled

    def evaluate(state, elapsed, start):
        state, result = _eval_block(bundle, state, elapsed, config)
        start.copy_(state.iteration)
        return state, result

    def trial(state, elapsed, start):
        return _masked_trial(problem, config, state, start)

    return graphs.SegmentRunner(
        bundle, graph_key("pdhg", config), state, evaluate, trial,
        elapsed_time, graphs.bundle_graphable(bundle) and not _eager)


def _run_trials(runner: graphs.SegmentRunner, config: _PdhgConfig,
                iteration: int):
    """The step trials of one segment, after its evaluation, from its
    evaluation iteration `iteration` (known on the host) to the next:
    the JAX package's while_loop in _segment_core, in rounds as
    batch.run_segment: `need` masked trials back to back with no
    read-back, `need` being the accepted steps still needed (the whole
    segment at first), then one read-back of the predicate, `need`, the
    iteration and the evaluation's termination reason. A segment with no
    rejection makes one read-back, its evaluation included; after a
    terminating evaluation its trials change nothing. Returns
    (termination_reason, iteration), host ints."""
    target = next_eval_iteration(iteration, config)
    need = target - iteration
    while True:
        runner.steps(need)
        active, left, iteration, reason = _read_back(
            runner.state, runner.start, target, config)
        spans.COUNTS["read_backs"] += 1
        if not active:
            return reason, iteration
        need = left


def _malitsky_pock_segment(problem, state: PdhgState, config: _PdhgConfig,
                           iteration: int):
    """The Malitsky-Pock steps of one segment from its evaluation
    iteration: a host loop, one read-back a line-search trial."""
    while True:
        state, accepted = _malitsky_pock_step(problem, state,
                                              config.step_policy)
        if not accepted:
            return state, iteration
        iteration += 1
        if _is_eval_iteration(iteration, config):
            return state, iteration


def _run_segments(bundle: DeviceScaledQp, state: PdhgState, elapsed_time,
                  config: _PdhgConfig, num_segments: int, iteration: int,
                  _eager: bool = False):
    """Up to `num_segments` [evaluate -> trials] segments in one dispatch
    (the JAX package's _run_segments), stopping at the first nonzero
    termination reason. `iteration` is the state's iteration, known on
    the host. The state stays on the runner's buffers for the whole
    dispatch (one load, one unload); each segment reads back once a round
    of trials. Returns (state, the last EvalResult as device tensors, the
    iteration and the last termination reason as host ints)."""
    with spans.span("folp.dispatch"):
        if isinstance(config.step_policy, MalitskyPockStepsizeParameters):
            return _malitsky_pock_segments(bundle, state, elapsed_time,
                                           config, num_segments, iteration)
        runner = _runner(bundle, state, elapsed_time, config, _eager)
        for _ in range(num_segments):
            result = runner.evaluate()
            reason, iteration = _run_trials(runner, config, iteration)
            spans.COUNTS["segments"] += 1
            if reason != 0:
                break
        with spans.span("folp.unload"):
            return runner.unload(), runner.detach(result), iteration, reason


def _malitsky_pock_segments(bundle: DeviceScaledQp, state: PdhgState,
                            elapsed_time, config: _PdhgConfig,
                            num_segments: int, iteration: int):
    """_run_segments under the Malitsky-Pock rule: eager evaluations, one
    read-back each, and a host loop of line-search steps."""
    elapsed = torch.full((), float(elapsed_time), dtype=torch.float64,
                         device=state.step_size.device)
    for _ in range(num_segments):
        with spans.span("folp.evaluate"):
            state, result = _eval_block(bundle, state, elapsed, config)
        spans.COUNTS["evaluations"] += 1
        spans.COUNTS["segments"] += 1
        spans.COUNTS["read_backs"] += 1
        with spans.span("folp.read_back"):
            reason, iteration = [int(v) for v in torch.stack([
                state.termination_reason.to(torch.int64),
                state.iteration]).tolist()]
        if reason != 0:
            break
        with spans.span("folp.trials"):
            state, iteration = _malitsky_pock_segment(
                bundle.scaled, state, config, iteration)
    return state, result, iteration, reason


def _segment_core(bundle: DeviceScaledQp, state: PdhgState, elapsed_time,
                  config: _PdhgConfig, _eager: bool = False):
    """One evaluation + the step trials up to the next evaluation point:
    a dispatch of one segment from the state's own iteration (read back
    here). Returns (state, EvalResult)."""
    state = _device_counters(state)
    state, result, _, _ = _run_segments(
        bundle, state, elapsed_time, config, 1, int(state.iteration),
        _eager)
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


def prepare_problem(
    params: PdhgParameters,
    original_problem: QuadraticProgrammingProblem,
    warm_start=None,
    device=None,
    _reuse: "PreparedProblem | None" = None,
    _shard_plan=None,
) -> PreparedProblem:
    """Validates, rescales and moves `original_problem` to `device` for
    `optimize` (common.ingest: `device`, `_reuse` and `_shard_plan`
    there), then sets the initial state, the step size and the primal
    weight. `device` defaults to CUDA and raises when no GPU is present.

    warm_start: optional (primal, dual) in UNSCALED space; the solver
    starts from that point instead of zeros."""
    if isinstance(
        params.step_size_policy_params, MalitskyPockStepsizeParameters
    ) and original_problem.objective_matrix.nnz > 0:
        raise ValueError(
            "Malitsky and Pock linesearch is only supported for linear"
            " programming problems."
        )
    scaled_problem, bundle, device = ingest(
        params, original_problem, device, _reuse, _shard_plan)
    dtype = torch_dtype(params.dtype)

    with spans.timed("folp.ingest.step_size"):
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
            cumulative_kkt_passes=torch.full(
                (), float(cumulative_kkt_passes), dtype=torch.float64,
                device=device),
        )
    if warm_start is not None:
        x0, y0 = scaled_warm_start(scaled_problem, warm_start, dtype, device)
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
    block-partitioned over the plan's mesh at ingest. The host loop is
    common.solve's."""
    validate_termination_criteria(params.termination_criteria)
    if params.primal_importance <= 0 or not np.isfinite(
        params.primal_importance
    ):
        raise ValueError("primal_importance must be positive and finite")
    if prepared is None:
        prepared = prepare_problem(params, original_problem, device=device,
                                   _shard_plan=_shard_plan)
    config = _make_config(params)
    iteration = None  # the state's iteration, known on the host

    def begin(state):
        nonlocal iteration
        state = _device_counters(state)
        iteration = int(state.iteration)
        return state

    def dispatch(bundle, state, elapsed, num_segments):
        nonlocal iteration
        state, result, iteration, reason = _run_segments(
            bundle, state, elapsed, config, num_segments, iteration)
        return state, result, reason

    return solve(
        params, original_problem, prepared, config,
        begin=begin,
        dispatch=dispatch,
        final_bound_estimates=lambda bundle, state, result: (
            _final_bound_estimates(
                bundle, state.avg_primal_out, state.avg_dual_out,
                result.step_size, result.primal_weight)),
        output_iteration=lambda state, result: result.iteration,
        unscale=unscaled_saddle_point_output,
        context=_profiler_trace(params.profiler_trace_dir, prepared.device),
        elapsed_offset=_elapsed_offset,
        placement=_placement,
    )
