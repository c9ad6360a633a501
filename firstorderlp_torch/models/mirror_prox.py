"""Saddle-point Mirror Prox (extragradient) solver in PyTorch.

Reference semantics: src/mirror_prox.jl, as ported by the JAX package's
models/mirror_prox.py. Saddle point
    min_x max_y phi(x,y) = const + c'x + b'y + 0.5 x'Qx - y'Ax
with mirror map (omega/2)||x||_X^2 + (1/(2 omega))||y||_Y^2 where X, Y are
diagonal scalings derived from matrix row/column norms (l1/l2/off).

Each iteration takes two proximal steps (test point and candidate) and
accepts iff nonlinearity/movement <= 1/step_size: two KKT passes per
iteration. The pseudo-gradient is computed with one A and one A' product
(c + Qx - A'y, Ax - b); with the kernel operator these are the plain
`mv`/`rmv` kernels of ops/routed.py.

Execution model: eager PyTorch, a host loop over segments (one
termination/restart evaluation, then the steps up to the next evaluation
iteration). An iteration has no retry loop, so it is written without any
read-back: accept/reject and the zero-movement case are `torch.where`s
on 0-d tensors, and the counters that they steer (iteration, KKT passes,
average counts, the numerical-error flag) live on the device. The host
knows which iterations evaluate, and reads the flag, the counters and the
termination reason only there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..iteration_stats import (
    display_iteration_stats,
    display_iteration_stats_heading,
    print_to_screen_this_iteration,
    to_host_stats,
)
from ..ops.device import resolve_device
from ..ops.device_problem import DeviceScaledQp, to_device_scaled
from ..preprocess import rescale_problem, sparse_l2_norms
from ..problem import QuadraticProgrammingProblem, validate
from ..saddle_point import (
    RestartInfo,
    RestartParameters,
    SaddlePointOutput,
    SolutionWeightedAverage,
    add_to_solution_weighted_average,
    compute_new_primal_weight,
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
    evaluate_unscaled_stats,
    host_floats,
    matrix_inf_norm_entrywise,
    torch_dtype,
)

KKT_PASSES_PER_ITERATION = 2.0
KKT_PASSES_PER_TERMINATION_EVALUATION = 2.0


@dataclasses.dataclass
class MirrorProxParameters:
    """Reference: src/mirror_prox.jl:15-126, plus the JAX package's
    knobs."""

    l_inf_ruiz_iterations: int
    l2_norm_rescaling: bool
    pock_chambolle_alpha: Optional[float]
    primal_importance: float
    scale_invariant_initial_primal_weight: bool
    diagonal_scaling: str  # "l1" | "l2" | "off"
    verbosity: int
    record_iteration_stats: bool
    termination_evaluation_frequency: int
    termination_criteria: TerminationCriteria
    restart_params: RestartParameters
    dtype: str = "float64"
    matrix_format: str = "auto"
    # Precision of termination/stats evaluation (None = same as dtype).
    stats_dtype: Optional[str] = None
    # Matrix layout of the ORIGINAL (stats) copy (None = matrix_format;
    # same contract as PdhgParameters.stats_matrix_format).
    stats_matrix_format: Optional[str] = None
    # Bound-width column rescaling (same contract as PdhgParameters).
    bound_width_rescaling: bool = False
    # Checkpoint/resume (same contract as PdhgParameters).
    checkpoint_path: Optional[str] = None
    checkpoint_every_n_dispatches: int = 1
    resume_from_checkpoint: Optional[str] = None
    # Evaluation blocks between host fetches of the stats (same contract
    # as PdhgParameters.evaluations_per_dispatch): the elapsed time fed
    # to the time-limit check is refreshed, and stats are reported, once
    # per dispatch.
    evaluations_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class _MpConfig:
    criteria: TerminationCriteria
    restart_params: RestartParameters
    termination_evaluation_frequency: int
    # See _PdhgConfig.need_bound_estimates: skip the diagnostics-only
    # MAX_NORM trust-region solve when nothing records the estimates.
    need_bound_estimates: bool = True


@dataclasses.dataclass(frozen=True)
class MirrorProxState:
    """Field names follow the JAX package's MirrorProxState. Everything
    a step changes is a tensor, 0-d for scalars, so that a step needs no
    read-back; `avg`'s counts are 0-d int64 tensors between evaluations
    and Python ints after one."""

    current_primal: torch.Tensor
    current_dual: torch.Tensor
    primal_scaling: torch.Tensor  # X diag of the mirror map (incl. omega)
    dual_scaling: torch.Tensor  # Y diag of the mirror map (incl. 1/omega)
    avg: SolutionWeightedAverage
    restart_info: RestartInfo
    step_size: torch.Tensor  # 0-d
    primal_weight: torch.Tensor  # 0-d
    numerical_error: torch.Tensor  # 0-d bool
    cumulative_kkt_passes: torch.Tensor  # 0-d float64
    iteration: torch.Tensor  # 0-d int64, outer iteration due for processing
    iterations_completed: torch.Tensor  # 0-d int64
    accepted_iterations: torch.Tensor  # 0-d int64
    termination_reason: int  # 0 = running
    avg_primal_out: torch.Tensor
    avg_dual_out: torch.Tensor


def _pseudo_gradient(problem, x, y):
    """(grad_x phi, -grad_y phi) = (c + Qx - A'y, Ax - b)
    (reference mirror_prox.jl:284-307)."""
    if problem.objective_matrix is None:
        gx = problem.objective_vector - problem.aty(y)
    else:
        gx = problem.objective_vector + problem.qx(x) - problem.aty(y)
    gy = problem.ax(x) - problem.right_hand_side
    return gx, gy


def _proximal_step(problem, x, y, gx, gy, primal_scaling, dual_scaling,
                   step_size):
    """argmin_z step*g'z + 0.5 (z - z0)' D (z - z0) with bound projections
    (reference mirror_prox.jl:317-346)."""
    new_x = project_primal(x - step_size * gx / primal_scaling, problem)
    new_y = project_dual(y - step_size * gy / dual_scaling, problem)
    return new_x, new_y


def _bregman(primal_scaling, dual_scaling, dx, dy):
    """0.5 ||d||_D^2 for the concatenated difference
    (reference mirror_prox.jl:249-257)."""
    return 0.5 * (
        torch.sum(primal_scaling * dx * dx) + torch.sum(dual_scaling * dy * dy)
    )


def _step_size_factors(iteration: int, dtype):
    """(1 - (iteration + 1)^-0.3, 1 + (iteration + 1)^-0.6), computed on
    the host in the working precision (numpy's pow; the JAX package uses
    XLA's, which can differ in the last bit)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    it1 = np_dtype(iteration) + np_dtype(1.0)
    shrink = np_dtype(1) - it1 ** np_dtype(-0.3)
    grow = np_dtype(1) + it1 ** np_dtype(-0.6)
    return float(shrink), float(grow)


def _select(cond, a: SolutionWeightedAverage, b: SolutionWeightedAverage):
    return SolutionWeightedAverage(
        *(
            torch.where(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(SolutionWeightedAverage)
        )
    )


def _take_step(problem, state: MirrorProxState,
               iteration: Optional[int] = None) -> MirrorProxState:
    """One extragradient iteration (reference mirror_prox.jl:855-917),
    with no read-back from the device.

    `iteration`: the state's iteration as the host loop knows it, for the
    step-size rule's factors; read from the state (one read-back) when
    None. A state whose numerical-error flag is already set stays as it
    is: the host loop learns of the flag only at the next evaluation."""
    if iteration is None:
        iteration = int(state.iteration)
    x, y = state.current_primal, state.current_dual
    gx, gy = _pseudo_gradient(problem, x, y)
    test_x, test_y = _proximal_step(
        problem, x, y, gx, gy, state.primal_scaling, state.dual_scaling,
        state.step_size,
    )
    tgx, tgy = _pseudo_gradient(problem, test_x, test_y)
    cand_x, cand_y = _proximal_step(
        problem, x, y, tgx, tgy, state.primal_scaling, state.dual_scaling,
        state.step_size,
    )

    nonlinearity = torch.sum((tgx - gx) * (test_x - cand_x)) + torch.sum(
        (tgy - gy) * (test_y - cand_y)
    )
    movement = _bregman(
        state.primal_scaling, state.dual_scaling, cand_x - test_x,
        cand_y - test_y,
    ) + _bregman(
        state.primal_scaling, state.dual_scaling, test_x - x, test_y - y
    )
    numerical_error = movement == 0.0

    inv_stepsize_required = nonlinearity / torch.where(
        numerical_error, 1.0, movement
    )
    accept = (inv_stepsize_required <= 1.0 / state.step_size) & (
        ~numerical_error
    )

    new_x = torch.where(accept, cand_x, x)
    new_y = torch.where(accept, cand_y, y)
    new_avg = _select(
        accept,
        add_to_solution_weighted_average(
            state.avg, test_x, test_y, state.step_size
        ),
        state.avg,
    )

    shrink, grow = _step_size_factors(iteration, state.step_size.dtype)
    new_step = torch.minimum(
        shrink / torch.abs(inv_stepsize_required), grow * state.step_size
    )

    # On movement == 0 the reference `continue`s: nothing is updated this
    # iteration except the numerical_error flag (mirror_prox.jl:872-878).
    frozen = numerical_error | state.numerical_error

    def unless_frozen(new, old):
        return torch.where(frozen, old, new)

    return dataclasses.replace(
        state,
        current_primal=unless_frozen(new_x, x),
        current_dual=unless_frozen(new_y, y),
        avg=_select(frozen, state.avg, new_avg),
        step_size=unless_frozen(new_step, state.step_size),
        accepted_iterations=unless_frozen(
            state.accepted_iterations + accept.to(torch.int64),
            state.accepted_iterations,
        ),
        iterations_completed=unless_frozen(
            state.iterations_completed + 1, state.iterations_completed
        ),
        cumulative_kkt_passes=unless_frozen(
            state.cumulative_kkt_passes + KKT_PASSES_PER_ITERATION,
            state.cumulative_kkt_passes,
        ),
        numerical_error=frozen,
    )


def _is_eval_iteration(iteration: int, config: _MpConfig) -> bool:
    freq = config.termination_evaluation_frequency
    return (
        (iteration - 1) % freq == 0
        or iteration == config.criteria.iteration_limit + 1
        or iteration <= 10
    )


def _host_counters(state: MirrorProxState):
    """What an evaluation needs on the host, in one read-back:
    (numerical_error, average counts, iteration, iterations_completed,
    cumulative_kkt_passes). f64 holds every counter exactly."""
    avg = state.avg
    values = torch.stack([
        torch.as_tensor(v, device=state.step_size.device).to(torch.float64)
        for v in (
            state.numerical_error, avg.sum_primal_solutions_count,
            avg.sum_dual_solutions_count, state.iteration,
            state.iterations_completed, state.cumulative_kkt_passes,
        )
    ]).tolist()
    return (bool(values[0]), int(values[1]), int(values[2]), int(values[3]),
            int(values[4]), values[5])


def _eval_block(bundle: DeviceScaledQp, state: MirrorProxState, elapsed_time,
                config: _MpConfig):
    # Idempotence (the JAX package's guard, there for batching): a state
    # that terminated in a previous segment accumulates no KKT passes and
    # keeps its termination reason.
    entry_state = state
    already_terminated = state.termination_reason != 0
    (numerical_error, count_primal, count_dual, iteration,
     iterations_completed, kkt_before) = _host_counters(state)
    kkt = kkt_before + KKT_PASSES_PER_TERMINATION_EVALUATION
    avg = dataclasses.replace(
        state.avg,
        sum_primal_solutions_count=count_primal,
        sum_dual_solutions_count=count_dual,
    )
    state = dataclasses.replace(state, avg=avg)

    has_avg = not numerical_error and count_primal > 0 and count_dual > 0
    if has_avg:
        avg_primal = avg.sum_primal_solutions / torch.where(
            avg.sum_primal_solution_weights > 0,
            avg.sum_primal_solution_weights, 1.0,
        )
        avg_dual = avg.sum_dual_solutions / torch.where(
            avg.sum_dual_solution_weights > 0,
            avg.sum_dual_solution_weights, 1.0,
        )
    else:
        avg_primal = state.current_primal
        avg_dual = state.current_dual

    conv, infeas, reason_t = evaluate_unscaled_stats(
        bundle,
        config.criteria,
        avg_primal,
        avg_dual,
        numerical_error,
        iteration - 1,
        kkt,
        elapsed_time,
    )

    if config.need_bound_estimates:
        lagrangian, est_lb, est_ub = update_objective_bound_estimates(
            bundle.scaled, avg_primal, avg_dual, state.primal_scaling,
            state.dual_scaling,
        )
    else:
        zero = torch.zeros(
            (), dtype=avg_primal.dtype, device=avg_primal.device
        )
        lagrangian, est_lb, est_ub = zero, zero, zero

    reason = int(reason_t.item())
    restart_used = int(RestartChoice.RESTART_CHOICE_UNSPECIFIED)
    new_state = state
    if reason == 0 and not already_terminated:
        restart = run_restart_scheme(
            bundle.scaled,
            avg,
            state.current_primal,
            state.current_dual,
            state.restart_info,
            iterations_completed,
            state.primal_scaling,
            state.dual_scaling,
            state.primal_weight,
            config.restart_params,
        )
        restart_used = restart.restart_choice
        new_state = dataclasses.replace(
            state,
            current_primal=restart.primal_solution,
            current_dual=restart.dual_solution,
            avg=restart.avg,
            restart_info=restart.restart_info,
        )
        if restart.restart_choice != RestartChoice.RESTART_CHOICE_NO_RESTART:
            new_primal_weight = compute_new_primal_weight(
                restart.restart_info,
                state.primal_weight,
                config.restart_params.primal_weight_update_smoothing,
            )
            # update_mirror_prox_norms (reference mirror_prox.jl:552-571):
            # the mirror-map scalings absorb the primal weight ratio.
            ratio = new_primal_weight / state.primal_weight
            new_state = dataclasses.replace(
                new_state,
                primal_weight=new_primal_weight,
                primal_scaling=state.primal_scaling * ratio,
                dual_scaling=state.dual_scaling / ratio,
            )
    if already_terminated:
        new_state = entry_state
        reason = entry_state.termination_reason
        kkt = kkt_before
    else:
        new_state = dataclasses.replace(
            new_state,
            cumulative_kkt_passes=torch.full_like(
                state.cumulative_kkt_passes, kkt
            ),
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
        iteration=iteration - 1,
        cumulative_kkt_passes=kkt,
        step_size=state.step_size,
        primal_weight=state.primal_weight,
    )
    return new_state, result


def _segment_core(bundle: DeviceScaledQp, state: MirrorProxState,
                  elapsed_time, config: _MpConfig):
    """One evaluation + the iterations up to the next evaluation point.
    No step reads anything back: should the numerical-error flag come up
    on the way, the remaining steps leave the state as it is (and the
    device's iteration counter stops one past the failing iteration, as
    the reference's does), and the next evaluation reports it."""
    state, result = _eval_block(bundle, state, elapsed_time, config)
    start_iteration = result.iteration + 1
    iteration = start_iteration
    while state.termination_reason == 0 and (
        iteration == start_iteration
        or not _is_eval_iteration(iteration, config)
    ):
        running = ~state.numerical_error
        state = _take_step(bundle.scaled, state, iteration)
        state = dataclasses.replace(
            state, iteration=state.iteration + running.to(torch.int64)
        )
        iteration += 1
    return state, result


def _final_bound_estimates(bundle, avg_primal, avg_dual, primal_scaling,
                           dual_scaling):
    """One-shot recovery of the objective-bound estimates for the final
    stats entry when config.need_bound_estimates skipped them in-loop."""
    return update_objective_bound_estimates(
        bundle.scaled, avg_primal, avg_dual, primal_scaling, dual_scaling
    )


def _initial_scalings(scaled_qp, diagonal_scaling: str,
                      primal_importance: float):
    """Mirror-map diagonal X, Y and initial primal weight (host side).

    Reference: initialize_saddle_point_problem (mirror_prox.jl:484-550).
    """
    a = scaled_qp.constraint_matrix
    q = scaled_qp.objective_matrix
    n = a.shape[1]
    m = a.shape[0]
    if diagonal_scaling == "l2":
        primal = np.sqrt(
            sparse_l2_norms(a, axis=0) ** 2 + sparse_l2_norms(q, axis=0) ** 2
        )
        dual = sparse_l2_norms(a, axis=1)
        primal_weight = primal_importance
    elif diagonal_scaling == "l1":
        primal = np.asarray(np.abs(a).sum(axis=0)).ravel() + np.asarray(
            np.abs(q).sum(axis=0)
        ).ravel()
        dual = np.asarray(np.abs(a).sum(axis=1)).ravel()
        primal_weight = 1.0
    elif diagonal_scaling == "off":
        primal = primal_importance * np.ones(n)
        dual = (1.0 / primal_importance) * np.ones(m)
        primal_weight = 1.0
    else:
        raise ValueError(f"Unknown diagonal_scaling: {diagonal_scaling!r}")
    # Empty rows/columns have zero norm; the proximal step divides by
    # these scalings (reference mirror_prox.jl:504-533 never sees them
    # because presolve removes empties, but a problem padded to a shape
    # has empty rows/columns, and a zero scaling turns the padded lanes
    # into 0/0 = NaN, which poisons the whole iterate). The padded lanes
    # are inert (l = u = 0 variables, 0 >= 0 rows), so any positive
    # scaling is exact; use 1.
    primal = np.where(primal > 0, primal, 1.0)
    dual = np.where(dual > 0, dual, 1.0)
    return primal, dual, primal_weight


def initial_mp_scalings(scaled_qp, params: "MirrorProxParameters"):
    """Final (primal_scaling, dual_scaling, primal_weight) for a scaled
    problem: diagonal scalings, optional scale-invariant primal weight,
    and the update_mirror_prox_norms ratio fold (mirror_prox.jl:677-688).
    Host-side numpy."""
    primal_scaling, dual_scaling, primal_weight = _initial_scalings(
        scaled_qp, params.diagonal_scaling, params.primal_importance
    )
    if params.scale_invariant_initial_primal_weight:
        obj_norm = float(
            np.sqrt(
                np.sum(primal_scaling * scaled_qp.objective_vector ** 2)
            )
        )
        rhs_norm = float(
            np.sqrt(
                np.sum(dual_scaling * scaled_qp.right_hand_side ** 2)
            )
        )
        if obj_norm > 0.0 and rhs_norm > 0.0:
            new_primal_weight = params.primal_importance * (
                obj_norm / rhs_norm
            )
        else:
            new_primal_weight = params.primal_importance
    else:
        new_primal_weight = params.primal_importance
    ratio = new_primal_weight / primal_weight
    return (
        primal_scaling * ratio,
        dual_scaling / ratio,
        new_primal_weight,
    )


def make_initial_state(
    n, m, dtype, step_size, primal_scaling, dual_scaling, primal_weight,
    device=None,
) -> MirrorProxState:
    """Cold-start MirrorProxState (zeros; reference mirror_prox.jl:646)
    on `device` (CUDA when None). Shared by prepare_problem and the
    refinement path's shifted-solve fast prepare (refine.py), which
    reuses a phase-1 device bundle and only needs a fresh state.
    `step_size` is a number or a 0-d tensor."""
    device = resolve_device(device)

    def zeros(size):
        return torch.zeros(size, dtype=dtype, device=device)

    def vector(v):
        return torch.as_tensor(
            np.asarray(v, np.float64), device=device
        ).to(dtype)

    def scalar(v, kind=dtype):
        return torch.full((), v, dtype=kind, device=device)

    return MirrorProxState(
        current_primal=zeros(n),
        current_dual=zeros(m),
        primal_scaling=vector(primal_scaling),
        dual_scaling=vector(dual_scaling),
        avg=initialize_solution_weighted_average(n, m, dtype, device),
        restart_info=create_last_restart_info(zeros(n), zeros(m)),
        step_size=scalar(float(step_size)),
        primal_weight=scalar(float(primal_weight)),
        numerical_error=scalar(False, torch.bool),
        cumulative_kkt_passes=scalar(0.0, torch.float64),
        iteration=scalar(1, torch.int64),
        iterations_completed=scalar(0, torch.int64),
        accepted_iterations=scalar(0, torch.int64),
        termination_reason=0,
        avg_primal_out=zeros(n),
        avg_dual_out=zeros(m),
    )


class PreparedMpProblem(NamedTuple):
    """Host rescaling + device bundle + initial state, split out of
    optimize() so repeated solves don't pay ingest again: the Mirror
    Prox analogue of pdhg.prepare_problem."""

    scaled_problem: object
    bundle: DeviceScaledQp
    initial_state: MirrorProxState
    device: torch.device


def prepare_problem(
    params: MirrorProxParameters,
    original_problem: QuadraticProgrammingProblem,
    warm_start=None,
    device=None,
) -> PreparedMpProblem:
    """Validates, rescales and moves `original_problem` to `device` for
    `optimize` (reference: the rescaling step of optimize,
    mirror_prox.jl:627-688, split out for reuse). `device` defaults to
    CUDA and raises when no GPU is present.

    warm_start: optional (primal, dual) in UNSCALED space, mirroring
    pdhg.prepare_problem's contract (used by the refinement path's
    f64 tail; the reference always cold-starts, mirror_prox.jl:646)."""
    device = resolve_device(device)
    validate(original_problem)

    scaled_problem = rescale_problem(
        params.l_inf_ruiz_iterations,
        params.l2_norm_rescaling,
        params.pock_chambolle_alpha,
        params.verbosity,
        original_problem,
        bound_width_rescaling_flag=params.bound_width_rescaling,
    )
    dtype = torch_dtype(params.dtype)
    stats_dtype = (
        torch_dtype(params.stats_dtype) if params.stats_dtype else None
    )
    bundle = to_device_scaled(
        scaled_problem,
        dtype,
        params.matrix_format,
        device,
        stats_dtype=stats_dtype,
        stats_format=params.stats_matrix_format,
    )
    n = bundle.scaled.num_variables
    m = bundle.scaled.num_constraints

    inf_norm = matrix_inf_norm_entrywise(
        scaled_problem.scaled_qp.constraint_matrix
    )
    step_size = 1.0 / inf_norm if inf_norm > 0 else 1.0

    primal_scaling, dual_scaling, primal_weight = initial_mp_scalings(
        scaled_problem.scaled_qp, params
    )

    state = make_initial_state(
        n, m, dtype, step_size, primal_scaling, dual_scaling,
        primal_weight, device,
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
            current_primal=x0,
            current_dual=y0,
            restart_info=create_last_restart_info(x0, y0),
        )
    return PreparedMpProblem(
        scaled_problem=scaled_problem, bundle=bundle, initial_state=state,
        device=device,
    )


def optimize(
    params: MirrorProxParameters,
    original_problem: QuadraticProgrammingProblem,
    prepared: "PreparedMpProblem | None" = None,
    device=None,
    _elapsed_offset: float = 0.0,
) -> SaddlePointOutput:
    """Solves a QP with saddle-point mirror prox
    (reference optimize, mirror_prox.jl:610-919).

    Runs on CUDA unless `device` names another device; raises when no
    GPU is present and no device was asked for. `prepared`: a
    PreparedMpProblem from prepare_problem (skips the per-call rescale +
    device transfer). `_elapsed_offset`: see pdhg.optimize; pre-charges
    the time-limit clock for refinement sub-solves.
    """
    validate_termination_criteria(params.termination_criteria)
    if prepared is None:
        prepared = prepare_problem(params, original_problem, device=device)
    scaled_problem = prepared.scaled_problem
    bundle = prepared.bundle
    state = prepared.initial_state

    config = _MpConfig(
        criteria=params.termination_criteria,
        restart_params=params.restart_params,
        termination_evaluation_frequency=int(
            params.termination_evaluation_frequency
        ),
        need_bound_estimates=bool(
            params.record_iteration_stats or params.verbosity > 0
        ),
    )

    display_iteration_stats_heading(params.verbosity)

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

    def checkpoint(state, metadata):
        from ..checkpoint import save_state

        save_state(
            params.checkpoint_path,
            state,
            elapsed_time=time.time() - start_time,
            metadata=metadata,
            fingerprint=problem_fp,
        )

    iteration_stats = []
    start_time = time.time() - elapsed_offset
    basic_algorithm_time = 0.0
    evals_per_dispatch = max(1, int(params.evaluations_per_dispatch))
    checkpoint_every = max(1, int(params.checkpoint_every_n_dispatches))
    dispatch_count = 0
    while True:
        elapsed = time.time() - start_time
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
            # recover them once so the final stats entry keeps parity with
            # the reference's method_specific_stats (saddle_point.jl:1015).
            lagr, est_lb, est_ub = _final_bound_estimates(
                bundle,
                state.avg_primal_out,
                state.avg_dual_out,
                state.primal_scaling,
                state.dual_scaling,
            )
            result = result._replace(
                lagrangian_value=lagr,
                estimated_lower_bound=est_lb,
                estimated_upper_bound=est_ub,
            )
        result = host_floats(result)
        eval_iteration = result.iteration
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
                int(state.iterations_completed),
                iteration_stats,
            )
            if params.verbosity >= 6:
                # reference mirror_prox.jl:453-470 prints these per
                # display; here once at termination (per-display would
                # cost a host fetch every evaluation).
                s = active_variable_stats(
                    scaled_problem.original_qp,
                    output.primal_solution,
                    output.dual_solution,
                )
                nnz = scaled_problem.original_qp.constraint_matrix.nnz
                print(
                    f"    primal vars [@lb: {s[0]} active: {s[1]} "
                    f"@ub: {s[2]}] dual ineq vars [@lb: {s[3]} "
                    f"active: {s[4]}] active mat nz: "
                    f"{100.0 * s[5] / max(nnz, 1):6.3f}%"
                )
            if params.verbosity >= 7:
                from ..problem import (
                    print_variable_and_constraint_hardness,
                )

                print_variable_and_constraint_hardness(
                    scaled_problem.original_qp,
                    output.primal_solution,
                    output.dual_solution,
                )
            return output


def active_variable_stats(problem, primal, dual):
    """Counts of variables at bounds / active, inequality duals at zero /
    active, and the nnz fraction of A restricted to active rows+columns.

    Host-side diagnostic printed at verbosity >= 6 in the reference
    (mirror_prox.jl:352-409); here a standalone helper on the host
    problem representation.
    """
    import scipy.sparse as sp

    primal = np.asarray(primal)
    dual = np.asarray(dual)
    lb = np.asarray(problem.variable_lower_bound)
    ub = np.asarray(problem.variable_upper_bound)
    at_ub = primal >= ub
    at_lb = (~at_ub) & (primal <= lb)
    prim_active = ~(at_ub | at_lb)
    k = problem.num_equalities
    ineq_dual = dual[k:]
    num_dual_lb = int((ineq_dual <= 0).sum())
    num_dual_active = int((ineq_dual > 0).sum())

    csc = sp.csc_matrix(problem.constraint_matrix)
    row_active = np.ones(csc.shape[0], dtype=bool)
    row_active[k:] = dual[k:] > 0
    col_active = (primal != ub) & (primal != lb)
    coo = csc.tocoo()
    num_active_nonzeros = int(
        (col_active[coo.col] & row_active[coo.row]).sum()
    )
    return (
        int(at_lb.sum()),
        int(prim_active.sum()),
        int(at_ub.sum()),
        num_dual_lb,
        num_dual_active,
        num_active_nonzeros,
    )
