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

Execution model: a host loop over dispatches of up to
`evaluations_per_dispatch` segments (one termination/restart evaluation,
then the iterations up to the next evaluation iteration), as the JAX
package's _run_segments. The evaluation is the JAX package's, every
decision a torch.where on the device; an iteration has no retry loop, so
it is written without any read-back either: accept/reject and the
zero-movement case are `torch.where`s on 0-d tensors, and the counters
that they steer (iteration, KKT passes, average counts, the
numerical-error flag) live on the device. A segment reads back once,
after its evaluation: the termination reason and the iteration, from
which the host knows how many iterations the segment runs. On the f32
kernel operator on a CUDA device, the evaluation and each iteration are
replays of two CUDA graphs captured once on the device bundle, on one
set of buffers that holds the state for the whole dispatch
(ops/graphs.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import spans
from ..ops import graphs
from ..ops.device import resolve_device
from ..ops.device_problem import DeviceScaledQp
from ..preprocess import sparse_l2_norms
from ..problem import QuadraticProgrammingProblem
from ..saddle_point import (
    RestartInfo,
    RestartParameters,
    SaddlePointOutput,
    SolutionWeightedAverage,
    add_to_solution_weighted_average,
    compute_new_primal_weight,
    compute_primal_gradient,
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
    device_counters,
    evaluate_statistics,
    graph_key,
    ingest,
    matrix_inf_norm_entrywise,
    next_eval_iteration,
    scaled_warm_start,
    select_average,
    solve,
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
    """Field names follow the JAX package's MirrorProxState. Every field
    is a tensor on the state's device, 0-d for scalars, counters and
    flags, so that neither a step nor an evaluation reads anything
    back."""

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
    termination_reason: torch.Tensor  # 0-d int32, 0 = running
    avg_primal_out: torch.Tensor
    avg_dual_out: torch.Tensor


def _pseudo_gradient(problem, x, y):
    """(grad_x phi, -grad_y phi) = (c + Qx - A'y, Ax - b)
    (reference mirror_prox.jl:284-307)."""
    gx = compute_primal_gradient(problem, x, y)
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


def _step_size_factors(iteration, dtype):
    """(1 - (iteration + 1)^-0.3, 1 + (iteration + 1)^-0.6) from the
    device counter `iteration` (a 0-d int64 tensor), on its device in
    the working precision, as batch._mp_step_size_factors (the JAX
    package uses XLA's pow, which can differ in the last bit)."""
    it1 = iteration.to(dtype) + 1.0
    return 1 - it1 ** (-0.3), 1 + it1 ** (-0.6)


def _take_step(problem, state: MirrorProxState) -> MirrorProxState:
    """One extragradient iteration (reference mirror_prox.jl:855-917),
    with no read-back from the device: the step-size rule's factors come
    from the state's own `iteration` on the device. A state whose
    numerical-error flag is already set stays bitwise as it is: the host
    loop learns of the flag only at the next evaluation."""
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
    new_avg = select_average(
        accept,
        add_to_solution_weighted_average(
            state.avg, test_x, test_y, state.step_size
        ),
        state.avg,
    )

    shrink, grow = _step_size_factors(state.iteration,
                                      state.step_size.dtype)
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
        avg=select_average(frozen, state.avg, new_avg),
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


def _eval_block(bundle: DeviceScaledQp, state: MirrorProxState, elapsed_time,
                config: _MpConfig):
    """The JAX package's _eval_block (mirror_prox.py:238-368 there) line
    for line: statistics, termination, bound estimates and restart on the
    device, every decision a torch.where, nothing read back."""
    # Idempotence (the JAX package's guard, there for batching): a state
    # that terminated in a previous segment accumulates no KKT passes and
    # keeps its termination reason.
    entry_state = state
    already_terminated = state.termination_reason != 0
    kkt = state.cumulative_kkt_passes + KKT_PASSES_PER_TERMINATION_EVALUATION
    iteration = state.iteration - 1
    avg_primal, avg_dual, conv, infeas, reason = evaluate_statistics(
        bundle, config.criteria, state, state.current_primal,
        state.current_dual, iteration, kkt, elapsed_time)

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

    terminated = reason != 0
    restart = run_restart_scheme(
        bundle.scaled,
        state.avg,
        state.current_primal,
        state.current_dual,
        state.restart_info,
        state.iterations_completed,
        state.primal_scaling,
        state.dual_scaling,
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
    # update_mirror_prox_norms (reference mirror_prox.jl:552-571): the
    # mirror-map scalings absorb the primal weight ratio.
    ratio = new_primal_weight / state.primal_weight
    post_restart = dataclasses.replace(
        state,
        current_primal=restart.primal_solution,
        current_dual=restart.dual_solution,
        avg=restart.avg,
        restart_info=restart.restart_info,
        primal_weight=new_primal_weight,
        primal_scaling=state.primal_scaling * ratio,
        dual_scaling=state.dual_scaling / ratio,
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


def _iterate(problem, state: MirrorProxState) -> MirrorProxState:
    """One iteration of a segment: _take_step, and the iteration counter
    one on unless the numerical-error flag was already set (the device's
    counter stops one past the failing iteration, as the reference's
    does)."""
    running = ~state.numerical_error
    state = _take_step(problem, state)
    return dataclasses.replace(
        state, iteration=state.iteration + running.to(torch.int64)
    )


# The counters and flags of a MirrorProxState and their dtypes on the
# device.
COUNTER_DTYPES = {
    "numerical_error": torch.bool,
    "cumulative_kkt_passes": torch.float64,
    "iteration": torch.int64,
    "iterations_completed": torch.int64,
    "accepted_iterations": torch.int64,
    "termination_reason": torch.int32,
}


def _device_counters(state: MirrorProxState) -> MirrorProxState:
    """The state with its counters and flags on the device
    (common.device_counters)."""
    return device_counters(state, COUNTER_DTYPES)


def _runner(bundle: DeviceScaledQp, state: MirrorProxState, elapsed_time,
            config: _MpConfig, _eager: bool) -> graphs.SegmentRunner:
    """The dispatch's evaluation and iteration on `state`: replayed from
    the bundle's graphs on the f32 kernel operator on a CUDA device
    (ops/graphs.bundle_graphable), else eager; `_eager` runs them eagerly
    there too, for the parity checks only."""
    problem = bundle.scaled

    def evaluate(state, elapsed, start):
        return _eval_block(bundle, state, elapsed, config)

    def iterate(state, elapsed, start):
        return _iterate(problem, state)

    return graphs.SegmentRunner(
        bundle, graph_key("mirror_prox", config), state, evaluate, iterate,
        elapsed_time, graphs.bundle_graphable(bundle) and not _eager)


def _run_segments(bundle: DeviceScaledQp, state: MirrorProxState,
                  elapsed_time, config: _MpConfig, num_segments: int,
                  _eager: bool = False):
    """Up to `num_segments` [evaluate -> iterations] segments in one
    dispatch (the JAX package's _run_segments), stopping at the first
    nonzero termination reason. The state stays on the runner's buffers
    for the whole dispatch (one load, one unload). Each segment reads
    back once, after its evaluation: the reason and the iteration; then
    the host launches the segment's known count of iterations, with no
    read-back (so no iteration runs after a terminating evaluation).
    Returns (state, the last EvalResult as device tensors, the last
    termination reason as a host int)."""
    with spans.span("folp.dispatch"):
        runner = _runner(bundle, state, elapsed_time, config, _eager)
        for _ in range(num_segments):
            result = runner.evaluate()
            with spans.span("folp.read_back"):
                reason, iteration = [int(v) for v in torch.stack([
                    runner.state.termination_reason.to(torch.int64),
                    runner.state.iteration]).tolist()]
            spans.COUNTS["read_backs"] += 1
            spans.COUNTS["segments"] += 1
            if reason != 0:
                break
            runner.steps(next_eval_iteration(iteration, config) - iteration)
        with spans.span("folp.unload"):
            return runner.unload(), runner.detach(result), reason


def _segment_core(bundle: DeviceScaledQp, state: MirrorProxState,
                  elapsed_time, config: _MpConfig, _eager: bool = False):
    """One evaluation + the iterations up to the next evaluation point
    (a dispatch of one segment). No iteration reads anything back: should
    the numerical-error flag come up on the way, the remaining iterations
    leave the state as it is, and the next evaluation reports it."""
    state, result, _ = _run_segments(bundle, _device_counters(state),
                                     elapsed_time, config, 1, _eager)
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
        termination_reason=scalar(0, torch.int32),
        avg_primal_out=zeros(n),
        avg_dual_out=zeros(m),
    )


def prepare_problem(
    params: MirrorProxParameters,
    original_problem: QuadraticProgrammingProblem,
    warm_start=None,
    device=None,
    _reuse: "PreparedProblem | None" = None,
    _shard_plan=None,
) -> PreparedProblem:
    """Validates, rescales and moves `original_problem` to `device` for
    `optimize` (common.ingest: `device`, `_reuse` and `_shard_plan`
    there), then sets the step size, the mirror-map scalings and the
    initial state. `device` defaults to CUDA and raises when no GPU is
    present.

    warm_start: optional (primal, dual) in UNSCALED space, mirroring
    pdhg.prepare_problem's contract (used by the refinement path's
    f64 tail; the reference always cold-starts, mirror_prox.jl:646)."""
    scaled_problem, bundle, device = ingest(
        params, original_problem, device, _reuse, _shard_plan)
    dtype = torch_dtype(params.dtype)
    n = bundle.scaled.num_variables
    m = bundle.scaled.num_constraints

    with spans.timed("folp.ingest.step_size"):
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
        x0, y0 = scaled_warm_start(scaled_problem, warm_start, dtype, device)
        state = dataclasses.replace(
            state,
            current_primal=x0,
            current_dual=y0,
            restart_info=create_last_restart_info(x0, y0),
        )
    return PreparedProblem(
        scaled_problem=scaled_problem, bundle=bundle, initial_state=state,
        device=device,
    )


def _make_config(params: MirrorProxParameters) -> _MpConfig:
    return _MpConfig(
        criteria=params.termination_criteria,
        restart_params=params.restart_params,
        termination_evaluation_frequency=int(
            params.termination_evaluation_frequency
        ),
        need_bound_estimates=bool(
            params.record_iteration_stats or params.verbosity > 0
        ),
    )


def optimize(
    params: MirrorProxParameters,
    original_problem: QuadraticProgrammingProblem,
    prepared: "PreparedProblem | None" = None,
    device=None,
    _elapsed_offset: float = 0.0,
    _placement=None,
    _shard_plan=None,
) -> SaddlePointOutput:
    """Solves a QP with saddle-point mirror prox
    (reference optimize, mirror_prox.jl:610-919).

    Runs on CUDA unless `device` names another device; raises when no
    GPU is present and no device was asked for. `prepared`: a
    PreparedProblem from prepare_problem (skips the per-call rescale +
    device transfer). `_elapsed_offset`, `_placement`, `_shard_plan`: see
    pdhg.optimize. The host loop is common.solve's.
    """
    validate_termination_criteria(params.termination_criteria)
    if prepared is None:
        prepared = prepare_problem(params, original_problem, device=device,
                                   _shard_plan=_shard_plan)
    config = _make_config(params)
    return solve(
        params, original_problem, prepared, config,
        begin=_device_counters,
        dispatch=lambda bundle, state, elapsed, num_segments: (
            _run_segments(bundle, state, elapsed, config, num_segments)),
        final_bound_estimates=lambda bundle, state, result: (
            _final_bound_estimates(
                bundle, state.avg_primal_out, state.avg_dual_out,
                state.primal_scaling, state.dual_scaling)),
        output_iteration=lambda state, result: int(
            state.iterations_completed),
        unscale=unscaled_saddle_point_output,
        final_log=_print_active_variables if params.verbosity >= 6 else None,
        elapsed_offset=_elapsed_offset,
        placement=_placement,
    )


def _print_active_variables(scaled_problem, output):
    """The active-set counts of the answer (reference mirror_prox.jl:
    453-470 prints these per display; here once at termination, since
    per display would cost a host fetch every evaluation)."""
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
