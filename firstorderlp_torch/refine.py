"""Split-precision refinement: f32 hot loop on the kernels, certified
to 1e-8 in f64 (the port of the JAX package's refine.py).

The reference's correctness bar is 1e-8 relative KKT error in f64
(src/termination.jl:33-45). A single-phase f32 solve plateaus near the
f32 rounding floor (~1e-7 relative). Two entry points reach 1e-8 from it:

  optimize_split_precision:
    phase 1: dtype=float32 (the kernel operator), stats in f32 on the
      unscaled problem, terminated at max(eps, switch_tol);
    phase 2: dtype=float64 on the plain CsrOp, warm-started from the
      phase-1 solution, terminated at the caller's tolerances.
  optimize_iterative_refinement:
    phase 1 as above, then f32 solves of shifted residual problems, each
    certified in f64 on the host (host_stats.py); the f64 tail above is
    the fallback when certification stalls.

PDHG restarts make the warm start principled: phase 2 behaves like a
restart to the phase-1 average (reference run_restart_scheme semantics,
src/saddle_point.jl:688-846). Iteration/KKT/time accounting is
continuous across phases in the merged output.

Both entry points run on CUDA unless the caller passes `device`, and raise
when no GPU is present and no device was asked for; a `prepared`
problem brings its own device, and every phase stays on it.
"""

from __future__ import annotations

import dataclasses
import os as _os
import sys as _sys
import time as _time
import types

import numpy as np
import scipy.sparse as sp
import torch

from .host_stats import (
    host_convergence_information,
    host_infeasibility_information,
    host_optimality_met,
    host_qp_cache,
)
from .iteration_stats import to_host_stats
from .models import mirror_prox as _mp
from .models import pdhg as _pdhg
from .models.common import initial_primal_weight_host
from .ops.device import resolve_device
from .ops.device_problem import DeviceQpCache
from .saddle_point import SaddlePointOutput
from .solve_log import PointType, RestartChoice, TerminationReason

# FOLP_REFINE_TRACE=1 prints a per-stage wall-clock breakdown (phase-1,
# per-round certification + sub-solve, f64 tail) to stderr - the
# path's time is split across stages no profiler sees as one program,
# so this is the practical way to attribute it.
_TRACE = _os.environ.get("FOLP_REFINE_TRACE", "0") == "1"


def _trace(msg: str) -> None:
    if _TRACE:
        print(f"# refine: {msg}", file=_sys.stderr, flush=True)


# The JAX package keeps these layouts through the refinement phases
# (they are keyed only on a shape bucket there); anything else becomes
# "auto", the phase's own fast layout: the kernel operator for a large
# f32 matrix on CUDA, the plain CsrOp in f64. The f64 tail maps the
# dense layouts to "coo" (CsrOp).
_BUCKETABLE = ("dense_onchip", "coo", "dense")


def _phase1_format(params) -> str:
    return (
        params.matrix_format
        if params.matrix_format in _BUCKETABLE
        else "auto"
    )


def _tail_format(params) -> str:
    return "coo" if params.matrix_format in _BUCKETABLE else "auto"


_REFINABLE = (
    TerminationReason.TERMINATION_REASON_OPTIMAL,
    TerminationReason.TERMINATION_REASON_ITERATION_LIMIT,
    TerminationReason.TERMINATION_REASON_KKT_MATRIX_PASS_LIMIT,
)

_INFEASIBLE = (
    TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE,
    TerminationReason.TERMINATION_REASON_DUAL_INFEASIBLE,
)


def _phase1_verdict(problem, criteria, out):
    """(refinable, trust_output) for a phase-1 result.

    An infeasibility declaration from the f32 phase is re-verified on
    host in f64: confirmed -> trust it (return as final); unconfirmed
    (an f32 artifact) -> never final, but a finite iterate can still
    seed the honest refinement path.

    The JAX package trusts an unconfirmed declaration whose iterate is
    not finite (its verdict returns `finite, not finite`) and its
    callers drop the flag altogether; here an unconfirmed declaration is
    never trusted, and the callers here act on the flag
    (_unless_untrusted)."""
    if out.termination_reason in _INFEASIBLE:
        if _confirm_infeasible(problem, criteria, out):
            return False, True
        finite = bool(
            np.all(np.isfinite(out.primal_solution))
            and np.all(np.isfinite(out.dual_solution))
        )
        return finite, False
    return _phase1_refinable(out), True


def _unless_untrusted(out, trusted: bool):
    """A phase-1 result that cannot be refined is final only when it is
    trusted; an infeasibility verdict that host f64 does not confirm
    comes back as a numerical error, not as the verdict."""
    if trusted:
        return out
    return dataclasses.replace(
        out,
        termination_reason=(
            TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR
        ),
        termination_string="NUMERICAL_ERROR",
    )


def _is_mp_params(params) -> bool:
    return isinstance(params, _mp.MirrorProxParameters)


def _prepare(params, problem, warm_start=None, _reuse=None, device=None):
    """Solver-dispatched prepare: both refinement entry points cover PDHG and
    Mirror Prox (the shift construction never touches solver state;
    reference bar: termination.jl:33-45 applied to mirror_prox.jl:
    623-919). Mirror Prox's prepare has no _reuse fast path: its f64
    tail pays a fresh ingest, on the device of the earlier phase."""
    if _is_mp_params(params):
        if _reuse is not None:
            device = _reuse.device
        return _mp.prepare_problem(
            params, problem, warm_start=warm_start, device=device
        )
    return _pdhg.prepare_problem(
        params, problem, warm_start=warm_start, device=device,
        _reuse=_reuse,
    )


def _optimize(params, problem, prepared, elapsed_offset=0.0):
    if _is_mp_params(params):
        return _mp.optimize(
            params, problem, prepared=prepared,
            _elapsed_offset=elapsed_offset,
        )
    return _pdhg.optimize(
        params, problem, prepared=prepared,
        _elapsed_offset=elapsed_offset,
    )


def _phase1_refinable(out) -> bool:
    """Whether the f32 phase produced a point worth refining.

    NUMERICAL_ERROR (movement == 0) at f32 usually means the iterates
    hit the f32 rounding floor - exactly the situation refinement (or
    the f64 tail) exists for - so it qualifies as long as the point is
    finite. Infeasibility certificates and NaN blowups do not."""
    if out.termination_reason in _REFINABLE:
        return True
    if out.termination_reason == (
        TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR
    ):
        return bool(
            np.all(np.isfinite(out.primal_solution))
            and np.all(np.isfinite(out.dual_solution))
        )
    return False


def _offset_stats(stats, iters, kkt, secs):
    return [
        dataclasses.replace(
            s,
            iteration_number=s.iteration_number + iters,
            cumulative_kkt_matrix_passes=(
                s.cumulative_kkt_matrix_passes + kkt
            ),
            cumulative_time_sec=s.cumulative_time_sec + secs,
        )
        for s in stats
    ]


def _relabelled_if_relaxed(out1, p1, crit, reason, string):
    """Phase 1 exhausted a budget. Its OPTIMAL label certifies only the
    RELAXED switch tolerance, not the caller's; report the honest
    limit-based reason unless the tolerances coincide (then the relaxed
    certificate IS the caller's)."""
    if (
        out1.termination_reason
        == TerminationReason.TERMINATION_REASON_OPTIMAL
        and p1.termination_criteria != crit
    ):
        return dataclasses.replace(
            out1, termination_reason=reason, termination_string=string
        )
    return out1


def optimize_split_precision(
    params,
    problem,
    switch_tolerance: float = 1e-6,
    prepared=None,
    device=None,
) -> SaddlePointOutput:
    """Solves `problem` to params' tolerances with the two-phase scheme.

    `prepared` optionally skips phase-1 ingest (must come from
    prepare_problem on the phase-1 params, see phase1_params). The
    caller's time_sec_limit is a GLOBAL wall budget across both phases
    (see optimize_iterative_refinement)."""
    t_begin = _time.time()
    p1 = phase1_params(params, switch_tolerance)
    if prepared is None:
        prepared = _prepare(p1, problem, device=resolve_device(device))
    out1 = _optimize(p1, problem, prepared)
    crit = params.termination_criteria
    refinable, trusted = _phase1_verdict(problem, crit, out1)
    if not refinable:
        return _unless_untrusted(out1, trusted)
    last1 = out1.iteration_stats[-1] if out1.iteration_stats else None
    if last1 is None:
        return _unless_untrusted(out1, trusted)

    p2 = dataclasses.replace(
        params,
        dtype="float64",
        stats_dtype=None,
        matrix_format=_tail_format(params),
    )
    remaining = crit.iteration_limit - out1.iteration_count
    if _time.time() - t_begin >= crit.time_sec_limit:
        return _unless_untrusted(
            _relabelled_if_relaxed(
                out1, p1, crit,
                TerminationReason.TERMINATION_REASON_TIME_LIMIT,
                "TIME_LIMIT",
            ),
            trusted,
        )
    if remaining <= 0:
        return _unless_untrusted(
            _relabelled_if_relaxed(
                out1, p1, crit,
                TerminationReason.TERMINATION_REASON_ITERATION_LIMIT,
                "ITERATION_LIMIT",
            ),
            trusted,
        )
    p2 = dataclasses.replace(
        p2,
        termination_criteria=dataclasses.replace(
            crit, iteration_limit=remaining
        ),
    )
    prep2 = _prepare(
        p2,
        problem,
        warm_start=(out1.primal_solution, out1.dual_solution),
        _reuse=prepared,
    )
    off_tail = _time.time() - t_begin
    out2 = _optimize(p2, problem, prep2, elapsed_offset=off_tail)

    kkt1 = last1.cumulative_kkt_matrix_passes
    t1 = last1.cumulative_time_sec
    stats = list(out1.iteration_stats) + _offset_stats(
        out2.iteration_stats, out1.iteration_count, kkt1, t1 - off_tail
    )
    return SaddlePointOutput(
        primal_solution=np.asarray(out2.primal_solution),
        dual_solution=np.asarray(out2.dual_solution),
        termination_reason=out2.termination_reason,
        termination_string=out2.termination_string,
        iteration_count=out1.iteration_count + out2.iteration_count,
        iteration_stats=stats,
    )


def phase1_params(params, switch_tolerance: float = 1e-6):
    """The f32 phase's parameters (public so callers can prepare_problem
    against them and pass `prepared` into optimize_split_precision)."""
    crit = params.termination_criteria
    relaxed = dataclasses.replace(
        crit,
        eps_optimal_absolute=max(
            crit.eps_optimal_absolute, switch_tolerance
        ),
        eps_optimal_relative=max(
            crit.eps_optimal_relative, switch_tolerance
        ),
    )
    return dataclasses.replace(
        params,
        dtype="float32",
        # In-loop stats in f32: phase 1's only consumer of the stats is
        # the 1e-6-grade switch decision, safely above the ~1e-7 f32
        # residual floor. The 1e-8 bar is enforced by the caller's HOST
        # f64 certification (host_stats.py) on every round, and in-loop
        # infeasibility declarations are re-verified on host in f64
        # before being returned (_confirm_infeasible).
        stats_dtype="float32",
        matrix_format=_phase1_format(params),
        termination_criteria=relaxed,
    )


# ---------------------------------------------------------------------------
# Iterative refinement: 1e-8 from f32 solves alone (with certification)
# ---------------------------------------------------------------------------


def _shifted_data(problem, x0, y0, alpha, promote_threshold,
                  rel_tol=0.0):
    """The residual LP/QP around (x0, y0), scaled by `alpha`.

    Constraint rows stay in their ORIGINAL order: the constraint matrix
    (and Q) of the shifted problem IS the original matrix, so the
    shifted solve reuses the phase-1 device bundle wholesale (the kernel
    operator's tensors, Ruiz/PC rescaling vectors, even the initial step
    size - Ruiz depends only on A) and only swaps the problem VECTORS
    and the is_equality mask (_prepare_shifted_fast). The
    equality-prefix layout is an ingestion convention; every device code
    path consumes is_equality as a mask.

    Derivation (primal-dual refinement of the saddle point
    0.5 x'Qx + c'x - y'(Ax-b)): substitute x = x0 + u/alpha,
    y = y0 + v/alpha and multiply the saddle function by alpha^2. The
    quadratic term 0.5 (u/alpha)'Q(u/alpha) scales back to 0.5 u'Qu -
    Q is UNCHANGED - while the gradient cross-term Q x0 joins the
    shifted objective vector alpha(c + Q x0 - A'y0) (for LPs Q = 0 and
    this reduces to the familiar alpha(c - A'y0)). The shifted rhs is
    alpha(b - A x0) and the bounds alpha(l - x0), alpha(u - x0).
    Inequality duals carry the constraint v_I >= -alpha y0_I, which
    standard form cannot express; rows whose y0_I is clearly positive
    (> promote_threshold) are PROMOTED to equalities (their optimal dual
    is strictly positive under strict complementarity - a guess
    certified afterwards in f64 with a fallback), and the remaining rows
    clamp y0_I to 0 so v_I >= 0 matches the standard cone.

    Returns (c_hat, b_hat, lo, hi, eq_mask, y0_used, x0_used) - all in
    the original row/column order; x0_used is x0 with fixed variables
    snapped to their bounds."""
    m = problem.num_constraints
    k = problem.num_equalities
    a = sp.csr_matrix(problem.constraint_matrix)
    y0_used = np.array(y0, dtype=np.float64)
    eq_mask = np.zeros(m, dtype=bool)
    eq_mask[:k] = True
    promoted = (~eq_mask) & (y0_used > promote_threshold)
    y0_used[(~eq_mask) & ~promoted] = 0.0
    eq_mask = eq_mask | promoted

    x0 = np.asarray(x0, dtype=np.float64)
    grad = np.asarray(problem.objective_vector) - a.T @ y0_used
    n = problem.num_variables
    if problem.objective_matrix is not None and (
        problem.objective_matrix.nnz > 0
    ):
        q = sp.csc_matrix(problem.objective_matrix)
        grad = grad + q @ x0
    else:
        q = sp.csc_matrix((n, n))

    # Variable analogue of the row promotion: a variable AT its bound
    # whose gradient points clearly INTO the bound has its gradient
    # absorbed by the implicit bound dual (reduced cost) - under strict
    # complementarity it stays at the bound, so FIX it (u_j = 0) and
    # drop its absorbed gradient from the shifted objective. Without
    # this, alpha * |absorbed rc| entries dominate ||c_hat|| and the
    # shifted problem's relative criteria read "converged" while the
    # TRUE residual is untouched. Absorbing WITHOUT fixing is wrong -
    # the freed variables drift off their bounds at zero objective cost
    # and the true objective explodes. The guess is certified in f64
    # afterwards, with the f64 tail as fallback, exactly like the row
    # promotion.
    lo0 = np.asarray(problem.variable_lower_bound, np.float64)
    hi0 = np.asarray(problem.variable_upper_bound, np.float64)
    gscale = np.max(np.abs(grad), initial=0.0)
    # rel_tol = sqrt(certified residual): the same scale-aware
    # threshold rule as the row promotion.
    fix_thr = rel_tol * gscale if gscale > 0 else np.inf
    # The at-bound tolerance depends on the problem class. LP optima
    # sit on vertices, so a variable within rel_tol * |x|_inf of its
    # bound with a clearly-signed gradient is at the bound at optimum
    # (degenerate transport/random LPs need this slack - phase 1
    # leaves their at-bound variables ~1e-6 off). Strictly convex QP
    # curvature routinely places optima JUST off a bound, so for QPs
    # only variables EXACTLY at the bound (PDHG's projection clamps
    # exactly) qualify. (On PageRank the tolerance must scale with
    # |x|_inf ~ 1/n, not the bound magnitudes, or every variable looks
    # "at bound".)
    x_scale = np.max(np.abs(x0), initial=0.0)
    bt = 0.0 if q.nnz > 0 else rel_tol * max(x_scale, 1e-300)
    fix_lo = ((x0 - lo0) <= bt) & (grad > fix_thr)
    fix_hi = np.isfinite(hi0) & ((hi0 - x0) <= bt) & (grad < -fix_thr)
    fixed = fix_lo | fix_hi
    # SNAP fixed variables to their bound (not freeze at x0): a fixed
    # variable sitting at bound + delta leaves a complementarity term
    # rc_j * delta in the duality gap that no u can repair. The snap
    # enters b_hat (and the Q gradient), and the caller applies it to x
    # via the returned x0_used. Rows get the same snap for free:
    # promotion to equality forces their slack to zero.
    x0_used = np.where(fix_lo, lo0, np.where(fix_hi, hi0, x0))
    if q.nnz > 0:
        grad = grad + q @ (x0_used - x0)
    b_hat = alpha * (
        np.asarray(problem.right_hand_side) - a @ x0_used
    )
    c_hat = alpha * np.where(fixed, 0.0, grad)
    lo = np.where(fixed, 0.0, alpha * (lo0 - x0_used))
    hi = np.where(fixed, 0.0, alpha * (hi0 - x0_used))

    # Primal analogue of the same normalization disease: an INACTIVE
    # inequality row carries slack alpha*(b - Ax)_i ~ alpha * O(1) into
    # b_hat, so ||b_hat|| is dominated by vacuous rows and the shifted
    # solve's relative criteria read "converged" while the meaningful
    # (equality/promoted/active) residuals are far smaller. The
    # constraint a_i u >= b_hat_i is vacuous for any plausible
    # correction, so clamp the slack at a cap comfortably above the
    # active scale; a correction large enough to hit the cap would fail
    # f64 certification and fall back.
    slack_cap = 1e2 * (
        1.0 + np.max(np.abs(b_hat[eq_mask]), initial=0.0)
    )
    b_hat[~eq_mask] = np.maximum(b_hat[~eq_mask], -slack_cap)
    return c_hat, b_hat, lo, hi, eq_mask, y0_used, x0_used


def _prepare_shifted_fast(prepared, params, c_hat, b_hat, lo, hi,
                          eq_mask):
    """PreparedProblem for the shifted solve by VECTOR SWAP on the
    phase-1 prepared state: A (and Q) are unchanged, so the scaled and
    original device operators, the Ruiz/PC rescaling vectors and the
    initial step size (1/max|A_scaled|) are reused verbatim; only the
    problem vectors (scaled on host with the phase-1 cumulative
    vectors), the is_equality mask and the qp-cache norms change. Zero
    plan builds, zero matrix transfers."""
    bundle = prepared.bundle
    device = prepared.device
    sp_prob = prepared.scaled_problem
    cum_var = np.asarray(sp_prob.variable_rescaling, np.float64)
    cum_con = np.asarray(sp_prob.constraint_rescaling, np.float64)
    c_s = c_hat / cum_var
    b_s = b_hat / cum_con
    lo_s = lo * cum_var
    hi_s = hi * cum_var
    f32 = bundle.scaled.objective_vector.dtype
    sdt = bundle.original.objective_vector.dtype
    eq = torch.as_tensor(np.asarray(eq_mask, bool), device=device)
    eq_f32 = eq.to(torch.float32)

    def vec(v, dt):
        return torch.as_tensor(
            np.asarray(v, np.float64), device=device
        ).to(dt)

    def swap(qp, dt, c, b, lov, hiv):
        return dataclasses.replace(
            qp,
            variable_lower_bound=vec(lov, dt),
            variable_upper_bound=vec(hiv, dt),
            objective_vector=vec(c, dt),
            objective_constant=torch.zeros((), dtype=dt, device=device),
            right_hand_side=vec(b, dt),
            is_equality=eq,
            is_equality_f32=eq_f32,
        )

    def scalar(v):
        return torch.tensor(float(v), dtype=sdt, device=device)

    new_bundle = dataclasses.replace(
        bundle,
        scaled=swap(bundle.scaled, f32, c_s, b_s, lo_s, hi_s),
        original=swap(bundle.original, sdt, c_hat, b_hat, lo, hi),
        qp_cache=DeviceQpCache(
            l_inf_norm_primal_linear_objective=scalar(
                np.max(np.abs(c_hat), initial=0.0)
            ),
            l_inf_norm_primal_right_hand_side=scalar(
                np.max(np.abs(b_hat), initial=0.0)
            ),
            l2_norm_primal_linear_objective=scalar(np.linalg.norm(c_hat)),
            l2_norm_primal_right_hand_side=scalar(np.linalg.norm(b_hat)),
        ),
    )
    if _is_mp_params(params):
        # A and Q are unchanged by the shift, so the mirror-map diagonal
        # scalings' matrix norms are phase 1's; only the scale-invariant
        # primal-weight fold changes with the shifted c_s/b_s
        # (initial_mp_scalings recomputes both host-side, reference
        # mirror_prox.jl:484-550, 677-688).
        shim = types.SimpleNamespace(
            constraint_matrix=sp_prob.scaled_qp.constraint_matrix,
            objective_matrix=sp_prob.scaled_qp.objective_matrix,
            objective_vector=c_s,
            right_hand_side=b_s,
        )
        px, py, pw = _mp.initial_mp_scalings(shim, params)
        state = _mp.make_initial_state(
            new_bundle.scaled.num_variables,
            new_bundle.scaled.num_constraints,
            f32,
            # same scaled A as phase 1 => same 1/max|A| initial step
            prepared.initial_state.step_size.to(f32),
            px,
            py,
            pw,
            device,
        )
        return _mp.PreparedMpProblem(
            scaled_problem=sp_prob,
            bundle=new_bundle,
            initial_state=state,
            device=device,
        )

    state = _pdhg._initial_state(new_bundle, f32, device)
    pw = initial_primal_weight_host(
        types.SimpleNamespace(
            objective_vector=c_s, right_hand_side=b_s
        ),
        params.primal_importance,
        params.scale_invariant_initial_primal_weight,
        0,
    )
    state = dataclasses.replace(
        state,
        # same scaled A as phase 1 => same 1/max|A| initial step
        step_size=prepared.initial_state.step_size.to(f32),
        primal_weight=torch.full((), float(pw), dtype=f32, device=device),
        cumulative_kkt_passes=0.5,
    )
    return _pdhg.PreparedProblem(
        scaled_problem=sp_prob,
        bundle=new_bundle,
        initial_state=state,
        device=device,
    )


def _certified(problem, criteria, x, y):
    """Evaluates the TRUE f64 convergence information of (x, y) on the
    original HOST problem and returns (meets_optimality, conv): host
    numpy/scipy (host_stats.py), strict f64 whatever the solve's
    dtype."""
    eps_ratio = (
        criteria.eps_optimal_absolute / criteria.eps_optimal_relative
        if criteria.eps_optimal_relative > 0
        else 1.0
    )
    conv = host_convergence_information(problem, x, y, eps_ratio)
    ok = host_optimality_met(criteria, conv, host_qp_cache(problem))
    return ok, conv


def _confirm_infeasible(problem, criteria, out) -> bool:
    """Re-verifies an in-loop infeasibility declaration on host in
    strict f64 (the in-loop stats are f32; a false certificate there
    must not surface as the final answer). Reference criteria:
    src/termination.jl:195-227."""
    infeas = host_infeasibility_information(
        problem, out.primal_solution, out.dual_solution
    )
    if out.termination_reason == (
        TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE
    ):
        return bool(
            infeas.dual_ray_objective > 0.0
            and infeas.max_dual_ray_infeasibility
            / infeas.dual_ray_objective
            <= criteria.eps_primal_infeasible
        )
    neg_obj = -infeas.primal_ray_linear_objective
    return bool(
        infeas.primal_ray_linear_objective < 0.0
        and infeas.max_primal_ray_infeasibility / neg_obj
        <= criteria.eps_dual_infeasible
        and infeas.primal_ray_quadratic_norm / neg_obj
        <= criteria.eps_dual_infeasible
    )


def optimize_iterative_refinement(
    params,
    problem,
    switch_tolerance: float = 1e-6,
    max_rounds: int = 4,
    sub_tolerance: float = 1e-6,
    prepared=None,
    device=None,
):
    """All-f32 path to 1e-8: f32 solve + f32 solves of shifted residual
    problems, each certified in f64 on the original problem; falls back
    to the f64 tail (optimize_split_precision) if certification stalls.

    Covers LPs and QPs: the alpha^2-scaled shift leaves Q unchanged and
    moves the Q x0 gradient cross-term into the shifted objective
    vector (see _shifted_data).

    No reference counterpart (the reference is pure f64); the technique
    is LP iterative refinement (Gleixner et al.) adapted to the
    primal-dual saddle point with active-set promotion for the dual
    cone shift. Returns (output, used_fallback).

    The caller's time_sec_limit is a GLOBAL wall budget: every
    sub-solve and the f64 tail are pre-charged with the time already
    spent (_elapsed_offset), so the whole pipeline - not each stage -
    respects the declared limit."""
    t_begin = _time.time()
    p1 = phase1_params(params, switch_tolerance)
    if prepared is None:
        prepared = _prepare(p1, problem, device=resolve_device(device))
    out1 = _optimize(p1, problem, prepared)
    _trace(
        f"phase1 {out1.termination_string} {out1.iteration_count} iters "
        f"in {_time.time() - t_begin:.2f}s"
    )
    crit = params.termination_criteria
    refinable, trusted = _phase1_verdict(problem, crit, out1)
    if not refinable:
        return _unless_untrusted(out1, trusted), False

    x = np.clip(
        np.asarray(out1.primal_solution, np.float64),
        problem.variable_lower_bound,
        problem.variable_upper_bound,
    )
    y = np.asarray(out1.dual_solution, np.float64)
    total_iters = out1.iteration_count
    stats_tail = list(out1.iteration_stats)
    kkt = stats_tail[-1].cumulative_kkt_matrix_passes if stats_tail else 0.0
    t_accum = stats_tail[-1].cumulative_time_sec if stats_tail else 0.0

    prev_res = None
    best_res = np.inf
    best_x, best_y = x, y
    for round_idx in range(max_rounds):
        t_cert = _time.time()
        ok, conv = _certified(problem, crit, x, y)
        _trace(
            f"round {round_idx} certify {_time.time() - t_cert:.2f}s "
            f"ok={ok} (t={_time.time() - t_begin:.2f}s)"
        )
        if ok:
            stats = to_host_stats(
                conv,
                _infeas_info(problem, x, y),
                total_iters,
                kkt,
                t_accum,
                RestartChoice.RESTART_CHOICE_UNSPECIFIED,
                0.0,
                0.0,
                {"refinement_rounds": float(round_idx)},
                PointType.POINT_TYPE_AVERAGE_ITERATE,
            )
            stats_tail.append(stats)
            return (
                SaddlePointOutput(
                    primal_solution=x,
                    dual_solution=y,
                    termination_reason=(
                        TerminationReason.TERMINATION_REASON_OPTIMAL
                    ),
                    termination_string="OPTIMAL",
                    iteration_count=total_iters,
                    iteration_stats=stats_tail,
                ),
                False,
            )
        # residual scale sets the shift magnitude. Use the CRITERIA's
        # own relative normalization (residuals over ||b||/||c||-style
        # denominators, termination.jl:33-45): an ad-hoc /(1+|obj|)
        # normalization over-estimates the PageRank residual
        # (||b|| = sqrt(m)), picks an alpha far too small, and the
        # mis-scaled shifted solve blows the correction up.
        res = max(
            conv.relative_l2_primal_residual,
            conv.relative_l2_dual_residual,
            abs(conv.relative_optimality_gap),
            1e-14,
        )
        if res < best_res:
            best_res, best_x, best_y = res, x, y
        # monotone guard: a round must at least halve the certified
        # residual, else refining has stalled (marginal gains do not
        # pay for 10k-iteration sub-solves) and the f64 tail is the
        # better spend - warm-started from the BEST certified point.
        if prev_res is not None and res >= 0.5 * prev_res:
            break
        prev_res = res
        alpha = min(1.0 / res * 1e-2, 1e12)
        if alpha <= 1.0:
            break
        # threshold scales with the dual magnitudes themselves: an
        # absolute "+1" floor promotes NOTHING on problems whose duals
        # are uniformly small (PageRank: every y ~ 3e-3), clamping the
        # whole dual to zero and making the shifted solve rebuild it
        # from scratch at alpha scale.
        y_scale = np.max(np.abs(y), initial=0.0)
        promote_threshold = (
            np.sqrt(res) * y_scale if y_scale > 0 else np.inf
        )
        c_hat, b_hat, lo_hat, hi_hat, eq_mask, y0_used, x0_used = (
            _shifted_data(
                problem, x, y, alpha, promote_threshold,
                rel_tol=np.sqrt(res),
            )
        )
        # Sub-solve accuracy ACTUALLY needed: with alpha = 1e-2/res the
        # applied correction leaves ~ eps_sub/alpha = 100*eps_sub*res
        # residual in original units, so a flat 1e-6 overshoots the
        # caller's tolerance by 100-1000x and runs the shifted solve
        # into its iteration cap. Target 0.3x the caller's relative
        # tolerance, quantized DOWN to a decade within
        # [sub_tolerance, 1e-4]. (The JAX package quantizes for its
        # compile cache; the port keeps the rule so that a sub-solve
        # stops where the reference's stops.)
        eps_target = max(crit.eps_optimal_relative, 1e-12)
        want = 3e-3 * eps_target / res
        eps_sub = float(
            10.0
            ** np.floor(np.log10(min(1e-4, max(sub_tolerance, want))))
        )
        sub_params = phase1_params(params, eps_sub)
        sub_params = dataclasses.replace(
            sub_params,
            verbosity=0,
            # the sub-solve must never touch the caller's checkpoint
            checkpoint_path=None,
            resume_from_checkpoint=None,
            termination_criteria=dataclasses.replace(
                sub_params.termination_criteria,
                # fixed cap: if the shifted solve hasn't converged by
                # here, the f64 tail is the better spend.
                iteration_limit=min(int(crit.iteration_limit), 10_000),
            ),
        )
        # global wall budget: no new sub-solve once the caller's
        # declared time limit is spent (the offset below makes a
        # STARTED sub-solve stop at the global limit, too).
        if _time.time() - t_begin >= crit.time_sec_limit:
            break
        prep_shift = _prepare_shifted_fast(
            prepared, sub_params, c_hat, b_hat, lo_hat, hi_hat, eq_mask
        )
        off_sub = _time.time() - t_begin
        sub = _optimize(
            sub_params, problem, prep_shift, elapsed_offset=off_sub
        )
        _trace(
            f"round {round_idx} sub-solve {sub.termination_string} "
            f"{sub.iteration_count} iters eps_sub={eps_sub:g} in "
            f"{_time.time() - t_begin - off_sub:.2f}s "
            f"(t={_time.time() - t_begin:.2f}s)"
        )
        # NUMERICAL_ERROR on the shifted solve usually means movement
        # hit zero at f32 exactness, and a capped (ITERATION_LIMIT)
        # solve still carries a partial correction - both are applied
        # TENTATIVELY: the next round's f64 certification plus the
        # monotone guard above decide whether the correction stands
        # (the fallback warm-starts from the best certified point, so
        # a bad tentative correction costs one sub-solve, not the
        # solution). Infeasibility certificates on the shifted problem
        # mean the linearization is garbage: stop refining.
        acceptable = _REFINABLE + (
            TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR,
        )
        if sub.termination_reason not in acceptable:
            break
        u = np.asarray(sub.primal_solution, np.float64)
        v = np.asarray(sub.dual_solution, np.float64)
        x = np.clip(
            x0_used + u / alpha,
            problem.variable_lower_bound,
            problem.variable_upper_bound,
        )
        y = y0_used + v / alpha
        kq = problem.num_equalities
        y[kq:] = np.maximum(y[kq:], 0.0)
        total_iters += sub.iteration_count
        if sub.iteration_stats:
            kkt += sub.iteration_stats[-1].cumulative_kkt_matrix_passes
            # the sub-solve's clock was pre-charged with off_sub; only
            # its own share joins the accumulated stats time
            t_accum += max(
                0.0,
                sub.iteration_stats[-1].cumulative_time_sec - off_sub,
            )

    # certification failed: honest f64 tail warm-started from the best
    # point so far (no phase-1 rerun). The tail spends only what is left
    # of the caller's declared iteration budget; if nothing is left,
    # return the best point with the honest limit-based reason instead
    # of overrunning.
    if np.isfinite(best_res):
        x, y = best_x, best_y
    remaining = int(crit.iteration_limit) - total_iters
    # Quantize DOWN to a power of two, as the JAX package does (there
    # for its compile cache): it decides where the tail stops, so the
    # port keeps it. Rounding down never overruns the declared budget;
    # it forfeits at most half the leftover.
    if remaining > 0:
        remaining = 1 << (remaining.bit_length() - 1)
    time_left = crit.time_sec_limit - (_time.time() - t_begin)
    if remaining <= 0 or time_left <= 0:
        reason = (
            TerminationReason.TERMINATION_REASON_ITERATION_LIMIT
            if remaining <= 0
            else TerminationReason.TERMINATION_REASON_TIME_LIMIT
        )
        return (
            SaddlePointOutput(
                primal_solution=x,
                dual_solution=y,
                termination_reason=reason,
                termination_string=(
                    "ITERATION_LIMIT"
                    if remaining <= 0
                    else "TIME_LIMIT"
                ),
                iteration_count=total_iters,
                iteration_stats=stats_tail,
            ),
            True,
        )
    p2 = dataclasses.replace(
        params,
        dtype="float64",
        stats_dtype=None,
        matrix_format=_tail_format(params),
        termination_criteria=dataclasses.replace(
            crit, iteration_limit=remaining
        ),
    )
    prep2 = _prepare(p2, problem, warm_start=(x, y), _reuse=prepared)
    off_tail = _time.time() - t_begin
    out2 = _optimize(p2, problem, prep2, elapsed_offset=off_tail)
    _trace(
        f"f64 tail {out2.termination_string} {out2.iteration_count} "
        f"iters in {_time.time() - t_begin - off_tail:.2f}s "
        f"(t={_time.time() - t_begin:.2f}s)"
    )
    stats = stats_tail + _offset_stats(
        out2.iteration_stats, total_iters, kkt, t_accum - off_tail
    )
    return (
        SaddlePointOutput(
            primal_solution=np.asarray(out2.primal_solution),
            dual_solution=np.asarray(out2.dual_solution),
            termination_reason=out2.termination_reason,
            termination_string=out2.termination_string,
            iteration_count=total_iters + out2.iteration_count,
            iteration_stats=stats,
        ),
        True,
    )


def _infeas_info(problem, x, y):
    """Host f64 infeasibility certificates on the original problem."""
    return host_infeasibility_information(problem, x, y)
