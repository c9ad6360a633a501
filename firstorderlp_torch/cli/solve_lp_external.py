"""CLI baseline: solves an LP instance with an external solver
(HiGHS via scipy.optimize.linprog) or the built-in ADMM baseline under
the SAME io/output contract as solve_qp, so results aggregate through
the same JSON->CSV pipeline.

Reference: scripts/solve_lp_external.jl (SCS/HiGHS through JuMP), as
the JAX package's cli/solve_lp_external.py ports it. Like the reference
(l.193-208), the external solution is re-evaluated with the solver's own
residual definitions on the FirstOrderLp problem, on the torch device
(--device, default CUDA), so baselines are apples-to-apples with the
PDHG/Mirror Prox logs.

Writes `<instance>_summary.json`, `<instance>_primal.txt`,
`<instance>_dual.txt` into --output_dir.
"""

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp


def parse_command_line(argv=None):
    parser = argparse.ArgumentParser(
        description="Solve an LP with an external baseline solver "
        "(reference scripts/solve_lp_external.jl)."
    )
    parser.add_argument(
        "--solver",
        choices=["highs", "highs-simplex", "highs-ipm", "admm"],
        default="highs",
        help="scipy/HiGHS method, or 'admm': the built-in matrix-free "
        "OSQP-style ADMM+CG baseline (firstorderlp_torch.baselines) "
        "standing in for the reference's scs-indirect rung.",
    )
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--instance_path", required=True)
    parser.add_argument("--tolerance", type=float, default=1e-8)
    parser.add_argument("--iteration_limit", type=int, default=None)
    parser.add_argument("--time_sec_limit", type=float, default=None)
    parser.add_argument(
        "--fixed_format_input",
        action="store_true",
        help="Read the instance as fixed-format MPS.",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="torch device of the residual evaluation (default: cuda; "
        "raises when no GPU is present).",
    )
    return parser.parse_args(argv)


_SCIPY_METHOD = {
    "highs": "highs",
    "highs-simplex": "highs-ds",
    "highs-ipm": "highs-ipm",
}


def evaluate_solution(lp, primal, dual, device):
    """The solver's convergence and infeasibility information of
    (primal, dual) on the unscaled problem, in f64 on `device`
    (reference l.193-208)."""
    import torch

    from firstorderlp_torch.iteration_stats import (
        compute_convergence_information,
        compute_infeasibility_information,
    )
    from firstorderlp_torch.ops.device_problem import to_device_scaled
    from firstorderlp_torch.preprocess import rescale_problem

    scaled = rescale_problem(0, False, None, 0, lp)
    bundle = to_device_scaled(scaled, torch.float64, "auto", device=device)
    x = torch.as_tensor(np.asarray(primal, np.float64), device=device)
    y = torch.as_tensor(np.asarray(dual, np.float64), device=device)
    # eps_abs == eps_rel == --tolerance, as in the reference script
    # (solve_lp_external.jl builds criteria with one tolerance), so the
    # eps ratio for relative residuals is 1.
    conv = compute_convergence_information(
        bundle.original, bundle.qp_cache, x, y, 1.0
    )
    infeas = compute_infeasibility_information(bundle.original, x, y)
    return conv, infeas


def solve_instance_and_output(args, command_line_invocation="",
                              device=None):
    import firstorderlp_torch as folp
    from firstorderlp_torch.cli.solve_qp import instance_name_of
    from firstorderlp_torch.iteration_stats import to_host_stats
    from firstorderlp_torch.solve_log import (
        PointType,
        RestartChoice,
        SolveLog,
        TerminationReason,
        solve_log_to_json,
        termination_reason_to_string,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    instance_name = instance_name_of(args.instance_path)

    lp = folp.qps_reader_to_standard_form(
        args.instance_path, fixed_format=args.fixed_format_input
    )
    presolve_info = folp.presolve(lp, verbosity=0, transform_bounds=False)
    if not folp.is_linear_programming_problem(lp):
        raise ValueError("solve_lp_external supports LPs only")

    # Standard form: A[:k] x = b[:k], A[k:] x >= b[k:], l <= x <= u.
    a = sp.csr_matrix(lp.constraint_matrix)
    k = lp.num_equalities
    n = lp.num_variables
    m = lp.num_constraints

    if args.solver == "admm":
        from firstorderlp_torch.baselines import admm_solve

        res = admm_solve(
            lp,
            tolerance=args.tolerance,
            time_sec_limit=args.time_sec_limit,
            iteration_limit=args.iteration_limit or 10**7,
        )
        running_time = res.solve_time_sec
        reason = res.termination_reason
        primal = res.primal_solution
        dual = res.dual_solution
        iteration_count = res.iteration_count
        cumulative_kkt_passes = res.cumulative_kkt_passes
    else:
        a_eq, b_eq = a[:k], lp.right_hand_side[:k]
        a_ub = -a[k:]
        b_ub = -lp.right_hand_side[k:]
        bounds = list(
            zip(lp.variable_lower_bound, lp.variable_upper_bound)
        )

        from scipy.optimize import linprog

        options = {"presolve": True}
        if args.time_sec_limit is not None:
            options["time_limit"] = args.time_sec_limit
        if args.iteration_limit is not None:
            options["maxiter"] = args.iteration_limit

        t0 = time.time()
        result = linprog(
            c=lp.objective_vector,
            A_ub=a_ub if a_ub.shape[0] else None,
            b_ub=b_ub if len(b_ub) else None,
            A_eq=a_eq if a_eq.shape[0] else None,
            b_eq=b_eq if len(b_eq) else None,
            bounds=bounds,
            method=_SCIPY_METHOD[args.solver],
            options=options,
        )
        running_time = time.time() - t0

        status_to_reason = {
            0: TerminationReason.TERMINATION_REASON_OPTIMAL,
            1: TerminationReason.TERMINATION_REASON_ITERATION_LIMIT,
            2: TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE,
            3: TerminationReason.TERMINATION_REASON_DUAL_INFEASIBLE,
            4: TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR,
        }
        reason = status_to_reason.get(
            result.status, TerminationReason.TERMINATION_REASON_OTHER
        )

        primal = (
            np.asarray(result.x) if result.x is not None else np.zeros(n)
        )
        # scipy duals: eqlin/ineqlin marginals are d(obj)/d(rhs) for the
        # scipy-form constraints. Our standard form wants y with
        # L = c'x - y'(Ax - b), so dV/db = +y on equality rows.
        # Inequalities are handed to scipy negated (A_ub = -A,
        # b_ub = -b), so y_ineq = -ineqlin.marginals (>= 0).
        dual = np.zeros(m)
        if getattr(result, "eqlin", None) is not None and k > 0:
            dual[:k] = np.asarray(result.eqlin.marginals)
        if getattr(result, "ineqlin", None) is not None and m - k > 0:
            dual[k:] = -np.asarray(result.ineqlin.marginals)
        iteration_count = int(getattr(result, "nit", 0) or 0)
        # KKT-pass estimate so baseline rows participate in KKT-budget
        # curves: the documented lower bound of one KKT matrix pass per
        # HiGHS iteration (the reference leaves NaN for HiGHS).
        cumulative_kkt_passes = float(iteration_count)

    conv, infeas = evaluate_solution(lp, primal, dual, device)
    stats = to_host_stats(
        conv,
        infeas,
        iteration_count,
        cumulative_kkt_passes,
        running_time,
        RestartChoice.RESTART_CHOICE_UNSPECIFIED,
        0.0,
        0.0,
        {},
        PointType.POINT_TYPE_AVERAGE_ITERATE,
    )
    log = SolveLog(
        instance_name=instance_name,
        command_line_invocation=command_line_invocation,
        termination_reason=reason,
        termination_string=termination_reason_to_string(reason),
        iteration_count=iteration_count,
        solve_time_sec=running_time,
        solution_stats=stats,
        solution_type=PointType.POINT_TYPE_AVERAGE_ITERATE,
    )
    with open(
        os.path.join(args.output_dir, instance_name + "_summary.json"), "w"
    ) as f:
        f.write(solve_log_to_json(log))

    primal_out, dual_out = folp.undo_presolve(presolve_info, primal, dual)
    np.savetxt(
        os.path.join(args.output_dir, instance_name + "_primal.txt"),
        primal_out,
    )
    np.savetxt(
        os.path.join(args.output_dir, instance_name + "_dual.txt"), dual_out
    )
    objective = stats.convergence_information[0].primal_objective
    print(
        f"{instance_name}: {termination_reason_to_string(reason)} "
        f"obj={objective} time={running_time:.3f}s"
    )
    return log


def main(argv=None):
    """Runs the command on `argv` (default: the command line); returns
    the SolveLog it wrote."""
    from firstorderlp_torch.ops.device import resolve_device

    args = parse_command_line(argv)
    device = resolve_device(args.device)
    invocation = " ".join(
        sys.argv if argv is None
        else ["python -m firstorderlp_torch.cli.solve_lp_external", *argv]
    )
    return solve_instance_and_output(args, invocation, device=device)


if __name__ == "__main__":
    main()
