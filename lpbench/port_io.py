"""What the benchmark hands to the port and takes back: its LPs as the
port's problems, and a solve's status and the solver's own reading of
its residuals."""

from __future__ import annotations

from firstorderlp_torch.problem import linear_programming_problem


def port_problem(lp):
    """The benchmark's Lp as the port's QuadraticProgrammingProblem."""
    return linear_programming_problem(
        lp.variable_lower_bound, lp.variable_upper_bound,
        lp.objective_vector, lp.objective_constant, lp.constraint_matrix,
        lp.right_hand_side, lp.num_equalities)


def status(out) -> str:
    """OPTIMAL, ITERATION_LIMIT, ...: the reason without its prefix."""
    return out.termination_reason.name.replace("TERMINATION_REASON_", "")


def reported(out) -> dict:
    """The solver's own f32 reading of the answer's relative residuals."""
    info = out.iteration_stats[-1].convergence_information
    if not info:
        return {}
    c = info[0]
    return {"rel_primal_residual": c.relative_l2_primal_residual,
            "rel_dual_residual": c.relative_l2_dual_residual,
            "rel_gap": c.relative_optimality_gap}
