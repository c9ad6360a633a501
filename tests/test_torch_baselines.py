"""The port's ADMM+CG baseline (firstorderlp_torch/baselines.py) against
the JAX package's on the problems of tests/test_baselines.py: the same
termination reason and iteration counts, solutions at rtol 1e-12 (both
are the same numpy on the host)."""

import numpy as np
import pytest
import scipy.sparse as sp

import firstorderlp_tpu as jx
from firstorderlp_tpu.baselines import admm_solve as jx_admm

from firstorderlp_torch.baselines import AdmmResult, admm_solve as tx_admm
from firstorderlp_torch.convert import problem_from_arrays


def _small_lp():
    # min -2x1 - x2  s.t.  x1 + x2 = 1.5, x1 - x2 >= -1, 0 <= x <= 1
    a = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, -1.0]]))
    return jx.linear_programming_problem(
        np.zeros(2), np.ones(2), np.array([-2.0, -1.0]), 0.0, a,
        np.array([1.5, -1.0]), 1,
    )


def _random_lp(m, n, seed, k_eq=None):
    rng = np.random.default_rng(seed)
    k_eq = m // 3 if k_eq is None else k_eq
    a = sp.random(
        m, n, density=0.3, random_state=np.random.RandomState(seed),
        data_rvs=rng.standard_normal, format="csc",
    )
    x0 = rng.uniform(0.2, 0.8, n)
    b = np.asarray(a @ x0)
    b[k_eq:] -= rng.uniform(0.0, 0.5, m - k_eq)
    return jx.linear_programming_problem(
        np.zeros(n), np.ones(n), rng.standard_normal(n), 0.0, a, b, k_eq
    )


def _qp():
    # min 1/2 x'Ix - x1  s.t. x1 + x2 >= 1, 0 <= x <= 2
    from firstorderlp_tpu.problem import QuadraticProgrammingProblem

    return QuadraticProgrammingProblem(
        variable_lower_bound=np.zeros(2),
        variable_upper_bound=np.full(2, 2.0),
        objective_matrix=sp.eye(2, format="csc"),
        objective_vector=np.array([-1.0, 0.0]),
        objective_constant=0.0,
        constraint_matrix=sp.csc_matrix(np.array([[1.0, 1.0]])),
        right_hand_side=np.array([1.0]),
        num_equalities=0,
    )


CASES = {
    "small_lp_1e-8": (_small_lp, {"tolerance": 1e-8}),
    "random_lp_seed3_1e-4": (lambda: _random_lp(40, 55, 3),
                             {"tolerance": 1e-4}),
    "random_lp_seed11_1e-4": (lambda: _random_lp(40, 55, 11),
                              {"tolerance": 1e-4}),
    "qp_1e-8": (_qp, {"tolerance": 1e-8}),
    "kkt_pass_budget": (lambda: _random_lp(60, 80, 7),
                        {"tolerance": 1e-12, "max_kkt_passes": 200}),
    "iteration_limit": (lambda: _random_lp(40, 55, 3),
                        {"tolerance": 1e-10, "iteration_limit": 30}),
}


def _to_port(p):
    return problem_from_arrays(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_matrix,
        p.objective_vector, p.objective_constant, p.constraint_matrix,
        p.right_hand_side, p.num_equalities,
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_admm_matches_the_jax_package(case):
    make, kwargs = CASES[case]
    problem = make()
    want = jx_admm(problem, **kwargs)
    got = tx_admm(_to_port(problem), **kwargs)
    assert isinstance(got, AdmmResult)
    assert got.termination_reason.name == want.termination_reason.name
    assert got.iteration_count == want.iteration_count
    assert got.total_cg_iterations == want.total_cg_iterations
    assert got.cumulative_kkt_passes == want.cumulative_kkt_passes
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        [got.primal_residual, got.dual_residual],
        [want.primal_residual, want.dual_residual], rtol=1e-12, atol=0,
    )
