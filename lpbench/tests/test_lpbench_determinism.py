"""Two solves of one prepared problem give the same bits (CPU path)."""

import numpy as np
import pytest

import firstorderlp_torch as pkg
from firstorderlp_torch.models import mirror_prox, pdhg

from lpbench import pagerank, port_io, registry, solver_params


@pytest.mark.parametrize("traffic,module", [
    ("closed-pdhg-1e-4", pdhg), ("closed-mirror-prox-1e-4", mirror_prox)])
def test_repeat_solve_same_bits(traffic, module):
    lp = pagerank.pagerank_lp(1500, 4500, 0.99, seed=2**33 + 1)
    params = solver_params.build(pkg, registry.traffic(traffic),
                                 registry.config("pagerank-1m"))
    problem = port_io.port_problem(lp)
    prepared = module.prepare_problem(params, problem, device="cpu")
    a = module.optimize(params, problem, prepared=prepared)
    b = module.optimize(params, problem, prepared=prepared)
    assert a.iteration_count == b.iteration_count
    np.testing.assert_array_equal(a.primal_solution, b.primal_solution)
    np.testing.assert_array_equal(a.dual_solution, b.dual_solution)
