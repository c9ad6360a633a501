"""CLI: solves an .mps/.qps(.gz) instance with PDHG or Mirror Prox.

Flag surface and output contract mirror the reference scripts/solve_qp.jl
and the JAX package's cli/solve_qp.py: writes `<instance>_summary.json`,
`<instance>_full_log.json.gz`, `<instance>_primal.txt`,
`<instance>_dual.txt` into --output_dir (and optionally redirects stdio
to `<instance>_std{out,err}.txt`). One flag more: --device (default
CUDA, which raises when no GPU is present; `--device cpu` runs the plain
PyTorch path).

Example:
    python -m firstorderlp_torch.cli.solve_qp --instance_path foo.mps.gz \
        --output_dir /tmp/out --method pdhg --relative_optimality_tol 1e-8 \
        --absolute_optimality_tol 1e-8
"""

import argparse
import contextlib
import gzip
import os
import re
import sys
import time

import numpy as np


def str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def parse_command_line(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--method", required=True, choices=["pdhg", "mirror-prox"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--instance_path", required=True)
    p.add_argument("--l_inf_ruiz_iterations", type=int, default=10)
    p.add_argument("--l2_norm_rescaling", type=str2bool, default=False)
    p.add_argument(
        "--bound_width_rescaling", type=str2bool, default=False,
        help="normalize two-sided bound intervals to unit width before "
             "Ruiz/L2/PC (see preprocess.py)",
    )
    p.add_argument("--pock_chambolle_rescaling", type=str2bool, default=True)
    p.add_argument("--pock_chambolle_alpha", type=float, default=1.0)
    p.add_argument("--primal_importance", type=float, default=1.0)
    p.add_argument(
        "--scale_invariant_initial_primal_weight", type=str2bool, default=True
    )
    p.add_argument("--artificial_restart_threshold", type=float, default=0.5)
    p.add_argument(
        "--sufficient_reduction_for_restart", type=float, default=0.1
    )
    p.add_argument(
        "--necessary_reduction_for_restart", type=float, default=0.9
    )
    p.add_argument("--primal_weight_update_smoothing", type=float, default=0.5)
    p.add_argument("--verbosity", type=int, default=2)
    p.add_argument("--redirect_stdio", type=str2bool, default=False)
    p.add_argument(
        "--diagonal_scaling", default="off", choices=["off", "l1", "l2"]
    )
    p.add_argument(
        "--restart_scheme",
        default="adaptive_normalized",
        choices=[
            "no_restart",
            "adaptive_normalized",
            "adaptive_distance",
            "adaptive_localized",
            "fixed_frequency",
        ],
    )
    p.add_argument("--restart_frequency", type=int, default=1000)
    p.add_argument(
        "--restart_to_current_metric",
        default="gap_over_distance_squared",
        choices=[
            "no_restart_to_current",
            "gap_over_distance",
            "gap_over_distance_squared",
        ],
    )
    p.add_argument(
        "--use_approximate_localized_duality_gap", type=str2bool,
        default=False,
    )
    p.add_argument("--record_iteration_stats", type=str2bool, default=True)
    p.add_argument(
        "--termination_evaluation_frequency", type=int, default=40
    )
    p.add_argument("--optimality_norm", default=None, choices=["l2", "l_inf"])
    p.add_argument("--absolute_optimality_tol", type=float, default=None)
    p.add_argument("--relative_optimality_tol", type=float, default=None)
    p.add_argument("--eps_primal_infeasible", type=float, default=None)
    p.add_argument("--eps_dual_infeasible", type=float, default=None)
    p.add_argument("--time_sec_limit", type=float, default=None)
    p.add_argument("--iteration_limit", type=int, default=None)
    p.add_argument("--kkt_matrix_pass_limit", type=float, default=None)
    p.add_argument(
        "--transform_bounds_into_linear_constraints", type=str2bool,
        default=False,
    )
    p.add_argument("--fixed_format_input", type=str2bool, default=False)
    p.add_argument(
        "--step_size_policy",
        default="adaptive",
        choices=["adaptive", "malitsky-pock", "constant"],
    )
    p.add_argument(
        "--adaptive_step_size_reduction_exponent", type=float, default=0.3
    )
    p.add_argument(
        "--adaptive_step_size_growth_exponent", type=float, default=0.6
    )
    p.add_argument(
        "--malitsky_pock_downscaling_factor", type=float, default=0.7
    )
    p.add_argument("--malitsky_pock_breaking_factor", type=float, default=0.99)
    p.add_argument(
        "--malitsky_pock_interpolation_coefficient", type=float, default=1.0
    )
    # Knobs of the JAX package (no reference counterpart):
    p.add_argument("--dtype", default="float64")
    p.add_argument(
        "--stats_dtype",
        default=None,
        help="Precision of termination/stats evaluation (default: dtype). "
        "dtype=float32 + stats_dtype=float64 is the split-precision mode.",
    )
    p.add_argument(
        "--matrix_format",
        default="auto",
        choices=["auto", "dense", "ell", "routed"],
        help="ell selects the CSR operator (CsrOp), routed the f32 "
        "kernel operator",
    )
    p.add_argument("--evaluations_per_dispatch", type=int, default=1)
    p.add_argument(
        "--two_phase_refinement",
        type=str2bool,
        default=False,
        help="an f32 phase on the kernel operator to "
        "--refinement_switch_tol, then a warm-started f64 tail to the "
        "requested tolerances (refine.optimize_split_precision).",
    )
    p.add_argument(
        "--refinement_switch_tol", type=float, default=1e-6
    )
    # The port's own:
    p.add_argument(
        "--device",
        default=None,
        help="torch device of the solve (default: cuda; raises when no "
        "GPU is present). `cpu` runs the plain PyTorch path.",
    )
    return p.parse_args(argv)


def build_parameters(args):
    import firstorderlp_torch as folp
    from firstorderlp_torch.termination import OptimalityNorm

    restart_scheme = {
        "no_restart": folp.RestartScheme.NO_RESTARTS,
        "adaptive_normalized": folp.RestartScheme.ADAPTIVE_NORMALIZED,
        "adaptive_distance": folp.RestartScheme.ADAPTIVE_DISTANCE,
        "adaptive_localized": folp.RestartScheme.ADAPTIVE_LOCALIZED,
        "fixed_frequency": folp.RestartScheme.FIXED_FREQUENCY,
    }[args.restart_scheme]
    restart_metric = {
        "no_restart_to_current": (
            folp.RestartToCurrentMetric.NO_RESTART_TO_CURRENT
        ),
        "gap_over_distance": folp.RestartToCurrentMetric.GAP_OVER_DISTANCE,
        "gap_over_distance_squared": (
            folp.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED
        ),
    }[args.restart_to_current_metric]

    restart_params = folp.construct_restart_parameters(
        restart_scheme,
        restart_metric,
        args.restart_frequency,
        args.artificial_restart_threshold,
        args.sufficient_reduction_for_restart,
        args.necessary_reduction_for_restart,
        args.primal_weight_update_smoothing,
        args.use_approximate_localized_duality_gap,
    )

    pock_chambolle_alpha = (
        args.pock_chambolle_alpha if args.pock_chambolle_rescaling else None
    )

    criteria = folp.construct_termination_criteria()
    if args.optimality_norm == "l2":
        criteria.optimality_norm = OptimalityNorm.L2
    elif args.optimality_norm == "l_inf":
        criteria.optimality_norm = OptimalityNorm.L_INF
    for field, value in [
        ("eps_optimal_absolute", args.absolute_optimality_tol),
        ("eps_optimal_relative", args.relative_optimality_tol),
        ("eps_primal_infeasible", args.eps_primal_infeasible),
        ("eps_dual_infeasible", args.eps_dual_infeasible),
        ("time_sec_limit", args.time_sec_limit),
        ("iteration_limit", args.iteration_limit),
        ("kkt_matrix_pass_limit", args.kkt_matrix_pass_limit),
    ]:
        if value is not None:
            setattr(criteria, field, value)

    if args.method == "mirror-prox":
        return folp.MirrorProxParameters(
            l_inf_ruiz_iterations=args.l_inf_ruiz_iterations,
            l2_norm_rescaling=args.l2_norm_rescaling,
            bound_width_rescaling=args.bound_width_rescaling,
            pock_chambolle_alpha=pock_chambolle_alpha,
            primal_importance=args.primal_importance,
            scale_invariant_initial_primal_weight=(
                args.scale_invariant_initial_primal_weight
            ),
            diagonal_scaling=args.diagonal_scaling,
            verbosity=args.verbosity,
            record_iteration_stats=args.record_iteration_stats,
            termination_evaluation_frequency=(
                args.termination_evaluation_frequency
            ),
            termination_criteria=criteria,
            restart_params=restart_params,
            dtype=args.dtype,
            stats_dtype=args.stats_dtype,
            matrix_format=args.matrix_format,
        )
    if args.step_size_policy == "malitsky-pock":
        step_params = folp.MalitskyPockStepsizeParameters(
            args.malitsky_pock_downscaling_factor,
            args.malitsky_pock_breaking_factor,
            args.malitsky_pock_interpolation_coefficient,
        )
    elif args.step_size_policy == "constant":
        step_params = folp.ConstantStepsizeParams()
    else:
        step_params = folp.AdaptiveStepsizeParams(
            args.adaptive_step_size_reduction_exponent,
            args.adaptive_step_size_growth_exponent,
        )
    return folp.PdhgParameters(
        l_inf_ruiz_iterations=args.l_inf_ruiz_iterations,
        l2_norm_rescaling=args.l2_norm_rescaling,
        bound_width_rescaling=args.bound_width_rescaling,
        pock_chambolle_alpha=pock_chambolle_alpha,
        primal_importance=args.primal_importance,
        scale_invariant_initial_primal_weight=(
            args.scale_invariant_initial_primal_weight
        ),
        verbosity=args.verbosity,
        record_iteration_stats=args.record_iteration_stats,
        termination_evaluation_frequency=(
            args.termination_evaluation_frequency
        ),
        termination_criteria=criteria,
        restart_params=restart_params,
        step_size_policy_params=step_params,
        dtype=args.dtype,
        stats_dtype=args.stats_dtype,
        matrix_format=args.matrix_format,
        evaluations_per_dispatch=args.evaluations_per_dispatch,
    )


def instance_name_of(instance_path: str) -> str:
    return re.sub(
        r"\.(mps|MPS|qps|QPS)(\.gz)?$", "", os.path.basename(instance_path)
    )


def solve_instance_and_output(
    parameters,
    output_dir: str,
    instance_path: str,
    redirect_stdio: bool,
    transform_bounds: bool,
    fixed_format_input: bool,
    command_line_invocation: str = "",
    switch_tolerance=None,
    device=None,
):
    """Reference: scripts/solve_qp.jl solve_instance_and_output
    (l.52-162). `switch_tolerance`: solve with optimize_split_precision
    switching at that tolerance (--two_phase_refinement). `device`: the
    torch device (CUDA when None)."""
    import firstorderlp_torch as folp
    from firstorderlp_torch.solve_log import (
        PointType,
        SolveLog,
        solve_log_to_json,
    )

    os.makedirs(output_dir, exist_ok=True)
    instance_name = instance_name_of(instance_path)

    def inner_solve():
        lower_name = os.path.basename(instance_path).lower()
        if not lower_name.endswith((".mps", ".mps.gz", ".qps", ".qps.gz")):
            raise ValueError(
                f"Instance has unrecognized file extension: {instance_path}"
            )
        lp = folp.qps_reader_to_standard_form(
            instance_path, fixed_format=fixed_format_input
        )
        presolve_info = folp.presolve(
            lp,
            verbosity=parameters.verbosity,
            transform_bounds=transform_bounds,
        )
        if parameters.verbosity >= 1:
            print(f"Instance: {instance_name}")
        t0 = time.time()
        if switch_tolerance is not None:
            output = folp.optimize_split_precision(
                parameters, lp, switch_tolerance=switch_tolerance,
                device=device,
            )
        else:
            output = folp.optimize(parameters, lp, device=device)
        running_time = time.time() - t0
        print(f"Elapsed time: {running_time} sec")

        log = SolveLog(
            instance_name=instance_name,
            command_line_invocation=command_line_invocation,
            termination_reason=output.termination_reason,
            termination_string=output.termination_string,
            iteration_count=output.iteration_count,
            solve_time_sec=running_time,
            solution_stats=output.iteration_stats[-1],
            solution_type=PointType.POINT_TYPE_AVERAGE_ITERATE,
        )

        summary_path = os.path.join(
            output_dir, instance_name + "_summary.json"
        )
        with open(summary_path, "w") as f:
            f.write(solve_log_to_json(log))

        log.iteration_stats = output.iteration_stats
        full_log_path = os.path.join(
            output_dir, instance_name + "_full_log.json.gz"
        )
        with gzip.open(full_log_path, "wt") as f:
            f.write(solve_log_to_json(log))

        primal, dual = folp.undo_presolve(
            presolve_info, output.primal_solution, output.dual_solution
        )
        np.savetxt(
            os.path.join(output_dir, instance_name + "_primal.txt"), primal
        )
        np.savetxt(
            os.path.join(output_dir, instance_name + "_dual.txt"), dual
        )

    if redirect_stdio:
        out_path = os.path.join(output_dir, instance_name + "_stdout.txt")
        err_path = os.path.join(output_dir, instance_name + "_stderr.txt")
        with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
            with contextlib.redirect_stdout(out_f), contextlib.redirect_stderr(
                err_f
            ):
                inner_solve()
    else:
        inner_solve()


def main(argv=None):
    """Runs the command on `argv` (default: the command line)."""
    from firstorderlp_torch.ops.device import resolve_device

    args = parse_command_line(argv)
    device = resolve_device(args.device)
    parameters = build_parameters(args)
    invocation = " ".join(
        sys.argv if argv is None
        else ["python -m firstorderlp_torch.cli.solve_qp", *argv]
    )
    solve_instance_and_output(
        parameters,
        args.output_dir,
        args.instance_path,
        args.redirect_stdio,
        args.transform_bounds_into_linear_constraints,
        args.fixed_format_input,
        command_line_invocation=invocation,
        switch_tolerance=(
            args.refinement_switch_tol if args.two_phase_refinement else None
        ),
        device=device,
    )


if __name__ == "__main__":
    main()
