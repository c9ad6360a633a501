"""Matrix-free first-order baseline: OSQP-style ADMM with CG inner
solves (the "SCS-indirect class" the reference benchmarks against).

The reference's campaign anchors PDLP against SCS in matrix-free
(indirect) mode and derives its KKT-pass count as
ADMM iterations x (1 + avg CG iterations per ADMM iteration)
(the reference's scripts/solve_lp_external.jl:171-184). SCS itself is
not installed in this environment, so this module implements the same
algorithm class from scratch - operator splitting with an indirect
(conjugate-gradient) linear-system solver, touching the constraint
matrix only through A x / A' y products - so the campaign has a
first-order baseline of a genuinely different method family next to
HiGHS (simplex/IPM, an exact-solve family).

Algorithm (OSQP splitting; Stellato et al. 2020, §3-5, public spec):

    minimize   1/2 x'Qx + c'x
    s.t.       z = [A; I] x,   z in C = [lb_row, ub_row] x [l, u]

    x-step: (Q + sigma I + [A;I]' diag(rho) [A;I]) xt = rhs, via CG
            (warm-started, matrix-free)
    z-step: projection onto C with over-relaxation alpha
    y-step: scaled dual ascent

Equality rows use rho_eq = 1e3 rho (the OSQP default heuristic); rho
adapts to the primal/dual residual ratio. Runs in f64 on host - it is
a CPU BASELINE for campaign tables, not a device path (the port's
first-order solvers are models/pdhg.py and models/mirror_prox.py). A
copy of the JAX package's baselines.py: the same numpy, so both give
the same iterates (tests/test_torch_baselines.py).

KKT-pass accounting (1 pass = one A x plus one A' y, the reference's
unit): each CG application of the normal operator costs 1 pass, each
ADMM iteration adds 1 pass for the rhs/z-step A-products, and each
residual check costs 1 more - total = iters + total_cg + checks,
matching the reference's SCS estimate in structure and unit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .preprocess import rescale_problem
from .solve_log import TerminationReason


@dataclasses.dataclass
class AdmmResult:
    primal_solution: np.ndarray
    dual_solution: np.ndarray  # our sign convention (>= 0 on >=-rows)
    termination_reason: TerminationReason
    iteration_count: int
    total_cg_iterations: int
    cumulative_kkt_passes: float
    solve_time_sec: float
    primal_residual: float  # l_inf, OSQP-form (scaled problem)
    dual_residual: float


def _cg(op, rhs, x0, rtol, max_iters, dinv=None):
    """Jacobi-preconditioned CG on the SPD normal operator; returns
    (x, iterations).

    Hand-rolled instead of scipy.sparse.linalg.cg to count operator
    applications exactly (the KKT-pass unit of the campaign tables)."""
    x = x0.copy()
    r = rhs - op(x)
    stop2 = (rtol * np.linalg.norm(rhs)) ** 2
    if float(r @ r) <= stop2:
        return x, 1
    z = dinv * r if dinv is not None else r
    p = z.copy()
    rz = float(r @ z)
    it = 1  # the initial residual costs one application
    while it < max_iters:
        ap = op(p)
        it += 1
        alpha = rz / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        if float(r @ r) <= stop2:
            break
        z = dinv * r if dinv is not None else r
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, it


def admm_solve(
    problem,
    tolerance: float = 1e-4,
    max_kkt_passes: float = 1e5,
    time_sec_limit: Optional[float] = None,
    iteration_limit: int = 10**7,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    rho: float = 0.1,
    check_every: int = 25,
    ruiz_iterations: int = 10,
) -> AdmmResult:
    """Solves the standard-form problem (A[:k] x = b, A[k:] x >= b,
    l <= x <= u, min c'x + 1/2 x'Qx) to OSQP-style eps_abs = eps_rel =
    `tolerance`. Budgets mirror the campaign protocol."""
    t0 = time.time()
    scaled = rescale_problem(ruiz_iterations, False, None, 0, problem)
    lp = scaled.scaled_qp
    a = sp.csr_matrix(lp.constraint_matrix)
    at = sp.csr_matrix(a.T)
    q_mat = (
        sp.csr_matrix(lp.objective_matrix)
        if lp.objective_matrix.nnz
        else None
    )
    m, n = a.shape
    k = problem.num_equalities
    c = lp.objective_vector.astype(np.float64)
    b = lp.right_hand_side.astype(np.float64)
    lo = lp.variable_lower_bound.astype(np.float64)
    hi = lp.variable_upper_bound.astype(np.float64)

    # row set C: eq rows {b}, ineq rows [b, inf); bound rows [l, u]
    lb_c = b
    ub_c = np.where(np.arange(m) < k, b, np.inf)

    # equality rows get a stiffer rho (OSQP's heuristic); 10x measured
    # best here - at 1e3 the CG system's conditioning (and its
    # relative-to-||rhs|| stop test) puts a noise floor ~1e-2 under the
    # outer residual on Ruiz-scaled LPs.
    rho_c = np.full(m, rho)
    rho_c[:k] *= 10.0
    rho_x = np.full(n, rho)
    a_sq = a.multiply(a).tocsc()  # for the Jacobi diagonal

    def qdot(v):
        return q_mat @ v if q_mat is not None else np.zeros_like(v)

    x = np.zeros(n)
    z_c = np.clip(np.zeros(m), lb_c, ub_c)
    z_x = np.clip(np.zeros(n), lo, hi)
    y_c = np.zeros(m)
    y_x = np.zeros(n)

    def jacobi_dinv():
        # Jacobi diagonal of the normal operator (Q's diagonal
        # omitted: rarely dominant after Ruiz scaling); recomputed only
        # when rho changes - it costs an O(nnz) pass.
        return 1.0 / (
            sigma + rho_x + np.asarray(a_sq.T @ rho_c).ravel()
        )

    dinv = jacobi_dinv()
    iters = 0
    total_cg = 0
    checks = 0
    cg_rtol = 1e-4
    best_r = np.inf
    reason = TerminationReason.TERMINATION_REASON_ITERATION_LIMIT
    r_prim = r_dual = np.inf

    def kkt_passes():
        return iters + total_cg + checks

    while iters < iteration_limit:
        def op(v, _rc=rho_c, _rx=rho_x):
            return (
                qdot(v)
                + sigma * v
                + at @ (_rc * (a @ v))
                + _rx * v
            )

        rhs = (
            sigma * x
            - c
            + at @ (rho_c * z_c - y_c)
            + (rho_x * z_x - y_x)
        )
        xt, cg_it = _cg(
            op, rhs, x, cg_rtol, max_iters=max(20, n), dinv=dinv
        )
        total_cg += cg_it
        zt_c = a @ xt
        x = alpha * xt + (1.0 - alpha) * x
        relax_c = alpha * zt_c + (1.0 - alpha) * z_c
        relax_x = alpha * xt + (1.0 - alpha) * z_x
        z_c_new = np.clip(relax_c + y_c / rho_c, lb_c, ub_c)
        z_x_new = np.clip(relax_x + y_x / rho_x, lo, hi)
        y_c += rho_c * (relax_c - z_c_new)
        y_x += rho_x * (relax_x - z_x_new)
        z_c, z_x = z_c_new, z_x_new
        iters += 1

        # budget guards every iteration (no extra matvecs): a single
        # check interval can add O(check_every * n) CG passes, far
        # past the budget if only tested at residual checks.
        if kkt_passes() >= max_kkt_passes:
            reason = (
                TerminationReason.TERMINATION_REASON_KKT_MATRIX_PASS_LIMIT
            )
            break
        if (
            time_sec_limit is not None
            and time.time() - t0 > time_sec_limit
        ):
            reason = TerminationReason.TERMINATION_REASON_TIME_LIMIT
            break

        if iters % check_every and iters != iteration_limit:
            continue
        checks += 1
        ax = a @ x
        aty = at @ y_c
        qx = qdot(x)
        if not np.isfinite(x).all() or not np.isfinite(y_c).all():
            reason = TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR
            break
        r_prim = max(
            float(np.max(np.abs(ax - z_c), initial=0.0)),
            float(np.max(np.abs(x - z_x), initial=0.0)),
        )
        dual_vec = qx + c + aty + y_x
        r_dual = float(np.max(np.abs(dual_vec), initial=0.0))
        eps_prim = tolerance + tolerance * max(
            np.max(np.abs(ax), initial=0.0),
            np.max(np.abs(z_c), initial=0.0),
            np.max(np.abs(x), initial=0.0),
        )
        eps_dual = tolerance + tolerance * max(
            np.max(np.abs(qx), initial=0.0),
            np.max(np.abs(c), initial=0.0),
            np.max(np.abs(aty), initial=0.0),
            np.max(np.abs(y_x), initial=0.0),
        )
        if r_prim <= eps_prim and r_dual <= eps_dual:
            reason = TerminationReason.TERMINATION_REASON_OPTIMAL
            break
        # rho adaptation (OSQP §5.2): balance the residual ratio.
        ratio = (r_prim / eps_prim) / max(r_dual / eps_dual, 1e-12)
        if ratio > 5.0 or ratio < 0.2:
            scale = np.sqrt(ratio)
            scale = float(np.clip(scale, 1e-3, 1e3))
            rho_c *= scale
            rho_x *= scale
            np.clip(rho_c, 1e-6, 1e6, out=rho_c)
            np.clip(rho_x, 1e-6, 1e6, out=rho_x)
            dinv = jacobi_dinv()
        # CG accuracy follows the outer residual (indirect-SCS style),
        # AND tightens on stall: loose CG puts a noise floor under the
        # fixed-point residual, which would otherwise deadlock with a
        # residual-proportional tolerance (the residual can't fall
        # because the tolerance is loose; the tolerance won't tighten
        # because the residual doesn't fall).
        # floor: tightening past ~0.03 x the target tolerance buys no
        # outer progress (the outer method's own tail dominates) but
        # multiplies the CG cost per iteration.
        rtol_floor = max(1e-12, 0.03 * tolerance)
        r_now = max(r_prim, r_dual)
        if r_now > 0.5 * best_r:
            cg_rtol = max(rtol_floor, cg_rtol * 0.25)
        best_r = min(best_r, r_now)
        cg_rtol = min(cg_rtol, max(rtol_floor, 0.1 * r_now))

    # unscale (same convention as the solvers: x / D, y / E)
    x_orig = x / scaled.variable_rescaling
    # our dual convention: L = c'x - y'(Ax - b), y >= 0 on >=-rows;
    # OSQP's stationarity is Qx + c + A'y_c + y_x = 0 -> y_ours = -y_c.
    y_orig = -y_c / scaled.constraint_rescaling
    y_orig[k:] = np.maximum(y_orig[k:], 0.0)
    return AdmmResult(
        primal_solution=np.clip(
            x_orig,
            problem.variable_lower_bound,
            problem.variable_upper_bound,
        ),
        dual_solution=y_orig,
        termination_reason=reason,
        iteration_count=iters,
        total_cg_iterations=total_cg,
        cumulative_kkt_passes=float(kkt_passes()),
        solve_time_sec=time.time() - t0,
        primal_residual=r_prim,
        dual_residual=r_dual,
    )
