"""The port's solver parameters from a traffic file's settings: the
PDLP settings of the repository's bench.py (adaptive steps 0.3 / 0.6,
adaptive-normalized restarts, 10 Ruiz iterations and Pock-Chambolle
alpha 1, an evaluation every 40 iterations), the tolerance and the
iteration limit of the traffic, and the dtype and layout of the
configuration."""

from __future__ import annotations


def build(pkg, traffic: dict, config: dict):
    """PdhgParameters or MirrorProxParameters of package `pkg`
    (firstorderlp_torch)."""
    s = traffic["settings"]
    tol = float(traffic["tolerance"])
    criteria = pkg.TerminationCriteria(
        eps_optimal_absolute=tol,
        eps_optimal_relative=tol,
        eps_primal_infeasible=0.0,
        eps_dual_infeasible=0.0,
        iteration_limit=int(traffic["iteration_limit"]),
    )
    restart = pkg.construct_restart_parameters(
        restart_scheme=pkg.RestartScheme[s["restart_scheme"]],
        restart_to_current_metric=pkg.RestartToCurrentMetric[
            s["restart_to_current_metric"]],
        restart_frequency_if_fixed=s["restart_frequency_if_fixed"],
        artificial_restart_threshold=s["artificial_restart_threshold"],
        sufficient_reduction_for_restart=s[
            "sufficient_reduction_for_restart"],
        necessary_reduction_for_restart=s["necessary_reduction_for_restart"],
        primal_weight_update_smoothing=s["primal_weight_update_smoothing"],
        use_approximate_localized_duality_gap=False,
    )
    common = dict(
        l_inf_ruiz_iterations=s["l_inf_ruiz_iterations"],
        l2_norm_rescaling=s["l2_norm_rescaling"],
        pock_chambolle_alpha=s["pock_chambolle_alpha"],
        primal_importance=s["primal_importance"],
        scale_invariant_initial_primal_weight=s[
            "scale_invariant_initial_primal_weight"],
        verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=s[
            "termination_evaluation_frequency"],
        termination_criteria=criteria,
        restart_params=restart,
        dtype=config["dtype"],
        matrix_format=config["matrix_format"],
        evaluations_per_dispatch=s["evaluations_per_dispatch"],
    )
    if traffic["solver"] == "pdhg":
        return pkg.PdhgParameters(
            **common,
            step_size_policy_params=pkg.AdaptiveStepsizeParams(
                reduction_exponent=s["reduction_exponent"],
                growth_exponent=s["growth_exponent"]),
        )
    if traffic["solver"] == "mirror-prox":
        return pkg.MirrorProxParameters(
            **common, diagonal_scaling=s["diagonal_scaling"])
    raise ValueError(f"unknown solver {traffic['solver']!r}")
