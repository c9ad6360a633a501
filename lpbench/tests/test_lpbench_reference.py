"""The reference accepts what the port's CPU path solved and refuses
it perturbed, the uniform vector and another LP's answer included; the
control (the reference in bfloat16 in the program's place) comes out
not correct, the same reference in f32 correct."""

import numpy as np
import pytest
import torch

from lpbench import pagerank, registry
from lpbench.reference import control, judge, kkt
from lpbench.reference import pagerank as reference

N = 2000
TRAFFIC = registry.traffic("closed-pdhg-1e-4")


def _lp(seed, damping=0.99):
    return pagerank.pagerank_lp(N, 3 * N, damping, seed=seed)


@pytest.fixture(scope="module")
def solved():
    from firstorderlp_torch.models import pdhg

    from lpbench import port_io, solver_params

    import firstorderlp_torch as pkg

    lp = _lp(31)
    params = solver_params.build(pkg, TRAFFIC, registry.config("pagerank-1m"))
    out = pdhg.optimize(params, port_io.port_problem(lp), device="cpu")
    return lp, out


def _judge(lp, answers, x_ref=None):
    x_ref = reference.solution(lp, 0.99) if x_ref is None else x_ref
    return judge.judge([answers], 1, lambda i: lp, TRAFFIC["residual_limit"],
                       lambda i: x_ref, TRAFFIC["l1_error_limit"])


def test_reference_accepts_the_ports_answer(solved):
    lp, out = solved
    assert out.termination_reason.name.endswith("OPTIMAL")
    verdict = _judge(lp, [(0, "OPTIMAL", out.primal_solution,
                           out.dual_solution)])
    assert judge.passed(verdict["checks"]), verdict["checks"]
    assert verdict["failed"] == 0 and verdict["attempted"] == 1


@pytest.mark.parametrize("fault", ["x_scaled", "y_shifted", "status",
                                   "missing", "uniform", "other_lp"])
def test_reference_refuses_the_answer_perturbed(solved, fault):
    lp, out = solved
    x, y = out.primal_solution.copy(), out.dual_solution.copy()
    status = "OPTIMAL"
    answers = None
    if fault == "x_scaled":
        x *= 1.01
    elif fault == "y_shifted":
        y[1:] += 1e-3
    elif fault == "status":
        status = "ITERATION_LIMIT"
    elif fault == "uniform":
        x, y = np.full(N, 1.0 / N), np.zeros(N + 1)
    elif fault == "other_lp":
        x = reference.solution(_lp(31, 0.95), 0.95)
    else:
        answers = []
    if answers is None:
        answers = [(0, status, x, y)]
    checks = _judge(lp, answers)["checks"]
    assert not judge.passed(checks)
    if fault in ("uniform", "other_lp"):
        l1 = checks["primal_l1_error"]
        assert l1["value"] > l1["limit"]


def test_the_pagerank_vector_is_the_lps_answer():
    lp = _lp(32)
    x = reference.solution(lp, 0.99)
    assert max(kkt.residuals(lp, x, np.zeros(N + 1)).values()) < 1e-8
    assert abs(x.sum() - 1.0) < 1e-9 and x.min() > 0


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False),
                                           (torch.float32, True)])
def test_control_fails_and_its_f32_twin_passes(dtype, correct):
    lp = _lp(33)
    x, y = control.answer(lp, 0.99, dtype=dtype)
    checks = _judge(lp, [(0, "OPTIMAL", x, y)])["checks"]
    assert judge.passed(checks) is correct
    l1 = checks["primal_l1_error"]
    assert (l1["value"] <= l1["limit"]) is correct


def test_not_finite_fails():
    lp = pagerank.pagerank_lp(200, 600, 0.99, seed=34)
    x = np.full(200, np.nan)
    verdict = judge.judge([[(0, "OPTIMAL", x, np.zeros(201))]], 1,
                          lambda i: lp, 1e-4, lambda i: np.zeros(200), 1.0)
    assert not judge.passed(verdict["checks"])
    assert verdict["checks"]["primal_l1_error"]["value"] == np.inf
