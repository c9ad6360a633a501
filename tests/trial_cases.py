"""PDLP step trials on the f32 kernel operator, from states made with
numpy from a seed: the cases that tests/test_torch_pdhg_step.py holds
against the JAX package on the CPU and tests/test_torch_cuda.py holds on
the card (the kernels F1a and F1b against their plain versions). No JAX
here: the card's tests import this module too.

Cases (the state's step size and iterates pick the branch):
- accept: a step size far under the limit movement / interaction;
- reject: one far over it;
- numerical_error: step size 0, so x+ = x and y+ = y: movement 0;
- interaction_zero: x at the bound its gradient pushes against, so
  x+ = x, interaction 0 and the limit infinite (finite bounds only);
- inactive: the iteration is an evaluation iteration other than the
  segment's first, so the mask is off and no bit may change;
- first: iteration 1 with an empty average (counts and weights 0).
"""

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

import firstorderlp_torch as tx
from firstorderlp_torch.generators import generate_pagerank_lp
from firstorderlp_torch.models import pdhg
from firstorderlp_torch.ops import routed
from firstorderlp_torch.saddle_point import (
    SolutionWeightedAverage,
    create_last_restart_info,
)

CASES = ("accept", "reject", "numerical_error", "interaction_zero",
         "inactive", "first")
# the step size of accept and reject, times the initial step size; the
# reject case's primal weight (its limit is then 0.95-0.99 times its
# step size on both problems, an accepted step's 1e3 times or more)
STEP_SCALE = {"accept": 1e-3, "reject": 3.0}
REJECT_PRIMAL_WEIGHT = 0.01
FREQUENCY = 40


def bounded_lp(n=400, m=300, seed=3):
    """A random sparse LP with finite bounds l = -1 - U(0, 1), u = 1 +
    U(0, 1) on every variable, a third of the rows equalities."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=0.02, random_state=seed, format="csr")
    a = a + sp.eye(m, n)
    return tx.QuadraticProgrammingProblem(
        variable_lower_bound=-1.0 - rng.random(n),
        variable_upper_bound=1.0 + rng.random(n),
        objective_matrix=sp.csc_matrix((n, n)),
        objective_vector=rng.normal(size=n),
        objective_constant=0.0,
        constraint_matrix=sp.csc_matrix(a),
        right_hand_side=rng.normal(size=m),
        num_equalities=m // 3,
    )


PROBLEMS = {
    "pagerank": lambda: generate_pagerank_lp(num_nodes=1000, seed=0),
    "bounded": bounded_lp,
}
# interaction_zero needs a finite bound on the gradient's side
PROBLEM_CASES = [(p, c) for p in sorted(PROBLEMS) for c in CASES
                 if c != "interaction_zero" or p == "bounded"]


def params(rule="adaptive"):
    """chip_smoke.py's main-path parameters (bench.py's) at this size."""
    policy = (tx.ConstantStepsizeParams() if rule == "constant"
              else tx.AdaptiveStepsizeParams(reduction_exponent=0.3,
                                             growth_exponent=0.6))
    return tx.PdhgParameters(
        l_inf_ruiz_iterations=10, l2_norm_rescaling=False,
        pock_chambolle_alpha=1.0, primal_importance=1.0,
        scale_invariant_initial_primal_weight=True, verbosity=0,
        record_iteration_stats=False,
        termination_evaluation_frequency=FREQUENCY,
        termination_criteria=tx.TerminationCriteria(
            eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4,
            iteration_limit=2000),
        restart_params=tx.construct_restart_parameters(
            restart_scheme=tx.RestartScheme.ADAPTIVE_NORMALIZED,
            restart_to_current_metric=(
                tx.RestartToCurrentMetric.GAP_OVER_DISTANCE_SQUARED),
            restart_frequency_if_fixed=100,
            artificial_restart_threshold=0.5,
            sufficient_reduction_for_restart=0.1,
            necessary_reduction_for_restart=0.9,
            primal_weight_update_smoothing=0.5,
            use_approximate_localized_duality_gap=False),
        step_size_policy_params=policy, dtype="float32",
        matrix_format="routed")


def prepared(problem_name, rule, device, tile_aligned=False):
    """(the port's PreparedProblem, config) of the problem, f32 on the
    kernel operator in the layout asked for."""
    p = params(rule)
    saved = routed.DEFAULT_TILE_ALIGNED
    routed.DEFAULT_TILE_ALIGNED = tile_aligned
    try:
        prep = pdhg.prepare_problem(p, PROBLEMS[problem_name](),
                                    device=device)
    finally:
        routed.DEFAULT_TILE_ALIGNED = saved
    return prep, pdhg._make_config(p)


def case_state(prep, case, seed=0):
    """(state, start): a PdhgState on the prepared problem's device made
    with numpy from `seed` for `case`, and the segment's first
    iteration."""
    problem = prep.bundle.scaled
    device = problem.objective_vector.device
    rng = np.random.default_rng(seed)
    n = problem.objective_vector.shape[0]
    m = problem.right_hand_side.shape[0]
    lower = problem.variable_lower_bound.cpu().numpy()
    upper = problem.variable_upper_bound.cpu().numpy()
    eq = problem.is_equality.cpu().numpy()

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    x = np.clip(rng.normal(size=n), lower, upper).astype(np.float32)
    y = rng.normal(size=m)
    y = np.where(eq, y, np.abs(y)).astype(np.float32)
    aty = problem.aty(f32(y))
    if case == "interaction_zero":
        gradient = (problem.objective_vector - aty).cpu().numpy()
        x = np.where(gradient < 0, upper,
                     np.where(gradient > 0, lower, x)).astype(np.float32)
    empty = case == "first"
    counts = (0, 0) if empty else tuple(int(v) for v in
                                        rng.integers(1, 200, 2))
    avg = SolutionWeightedAverage(
        sum_primal_solutions=f32(np.zeros(n) if empty
                                 else rng.normal(size=n)),
        sum_dual_solutions=f32(np.zeros(m) if empty
                               else rng.normal(size=m)),
        sum_primal_solutions_count=scalar(counts[0], torch.int64),
        sum_dual_solutions_count=scalar(counts[1], torch.int64),
        sum_primal_solution_weights=scalar(
            0.0 if empty else rng.uniform(0.1, 5.0), torch.float32),
        sum_dual_solution_weights=scalar(
            0.0 if empty else rng.uniform(0.1, 5.0), torch.float32),
    )
    step = float(prep.initial_state.step_size)
    step *= {"numerical_error": 0.0}.get(case, STEP_SCALE.get(case, 1.0))
    iteration = {"first": 1, "inactive": 2 * FREQUENCY + 1}.get(case, 57)
    start = iteration - 1 if case == "inactive" else iteration
    state = dataclasses.replace(
        prep.initial_state,
        current_primal_solution=f32(x),
        current_dual_solution=f32(y),
        delta_primal=f32(rng.normal(size=n)),
        delta_dual=f32(rng.normal(size=m)),
        current_dual_product=aty,
        avg=avg,
        restart_info=create_last_restart_info(f32(x), f32(y)),
        step_size=scalar(step, torch.float32),
        primal_weight=scalar(REJECT_PRIMAL_WEIGHT if case == "reject"
                             else rng.uniform(0.5, 2.0), torch.float32),
        numerical_error=scalar(False, torch.bool),
        cumulative_kkt_passes=scalar(float(rng.uniform(10, 1000)),
                                     torch.float64),
        total_number_iterations=scalar(
            0 if empty else int(rng.integers(iteration, 3 * iteration)),
            torch.int64),
        iteration=scalar(iteration, torch.int64),
        termination_reason=scalar(0, torch.int32),
    )
    return pdhg._device_counters(state), scalar(start, torch.int64)
