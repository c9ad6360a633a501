"""The port's PDHG solver against the JAX package's, on the CPU.

- One segment: in f64, the port starts from a JAX mid-solve PdhgState
  (convert.state_from_arrays) and one evaluation + 40-iteration segment
  gives the same iterates at rtol 1e-10.
- The whole slice: optimize on small LPs/QPs in f64 ("ell") and in f32
  ("routed", the kernel operator's plain versions) against the JAX
  package's optimize with the same parameters: the same termination
  reason, residuals under the tolerance. Iteration counts are reported,
  not asserted equal: the f32 trajectory depends on summation order.
- The device rule and the import rule of the port.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx

from firstorderlp_tpu.generators import generate_pagerank_lp
from firstorderlp_tpu.models import pdhg as jx_pdhg
from firstorderlp_tpu.models.common import HashableCriteria

import firstorderlp_torch as tx
from firstorderlp_torch import convert
from firstorderlp_torch.models import pdhg as tx_pdhg

import fixtures
from utils import (
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def port_problem(p):
    return convert.problem_from_arrays(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_matrix,
        p.objective_vector, p.objective_constant, p.constraint_matrix,
        p.right_hand_side, p.num_equalities,
    )


def port_params(p):
    """The port's PdhgParameters with the JAX parameters' values."""
    c = p.termination_criteria
    r = p.restart_params
    policy = p.step_size_policy_params
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    fields.update(
        termination_criteria=tx.TerminationCriteria(
            optimality_norm=tx.OptimalityNorm(c.optimality_norm.value),
            eps_optimal_absolute=c.eps_optimal_absolute,
            eps_optimal_relative=c.eps_optimal_relative,
            eps_primal_infeasible=c.eps_primal_infeasible,
            eps_dual_infeasible=c.eps_dual_infeasible,
            time_sec_limit=c.time_sec_limit,
            iteration_limit=c.iteration_limit,
            kkt_matrix_pass_limit=c.kkt_matrix_pass_limit,
        ),
        restart_params=tx.RestartParameters(**{
            **dataclasses.asdict(r),
            "restart_scheme": tx.RestartScheme(r.restart_scheme.value),
            "restart_to_current_metric": tx.RestartToCurrentMetric(
                r.restart_to_current_metric.value
            ),
        }),
        step_size_policy_params=getattr(tx, type(policy).__name__)(
            **dataclasses.asdict(policy)
        ),
    )
    return tx.PdhgParameters(**fields)


def state_leaves(state, prefix=""):
    """{dotted field: numpy array} of a JAX PdhgState."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(state_leaves(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def jax_config(params):
    return jx_pdhg._PdhgConfig(
        criteria=HashableCriteria.from_criteria(params.termination_criteria),
        restart_params=params.restart_params,
        step_policy=params.step_size_policy_params,
        termination_evaluation_frequency=params.termination_evaluation_frequency,
        need_bound_estimates=True,
    )


def pagerank(nodes=300):
    return generate_pagerank_lp(num_nodes=nodes, seed=0)


def random_lp():
    """The small LP of tests/test_routed.py's solver test."""
    rng = np.random.default_rng(11)
    n = 60
    a = sp.random(n, n, density=0.2, random_state=2, format="csr")
    return jx.linear_programming_problem(
        np.zeros(n), np.full(n, 10.0), rng.uniform(0.5, 1.5, n), 0.0,
        a + sp.eye(n), rng.uniform(0.1, 1.0, n), 0,
    )


# problem, Ruiz iterations, Pock-Chambolle alpha, first iteration of the
# compared segment
SEGMENT_CASES = {
    "pagerank300": (pagerank, 10, 1.0, 50),
    "random_lp": (random_lp, 10, 1.0, 90),
    "example_lp": (fixtures.example_lp, 10, 1.0, 90),
    "example_qp": (fixtures.example_qp, 10, None, 50),
}


def xla_step_size_factors(total, params, dtype):
    """The port's _step_size_factors with XLA's pow, as the JAX package
    computes them: numpy's and XLA's f64 pow differ in the last bit for
    some arguments, and the adaptive step amplifies such a bit."""
    t = jnp.asarray(total, jnp.float64) + 1.0
    return (float(1 - t ** (-params.reduction_exponent)),
            float(1 + t ** (-params.growth_exponent)))


def assert_close_normwise(got, want, rtol, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, f"{name}: {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_one_segment_from_jax_state_f64(case, monkeypatch):
    """Iterates at rtol 1e-10 after one segment. The step size (and the
    step-weighted sums) are held at rtol 1e-6 only: its limit
    movement/interaction divides two sums with cancellation, so the
    last-bit differences of fused versus unfused f64 arithmetic (XLA
    contracts multiply-adds) grow there by orders of magnitude."""
    monkeypatch.setattr(tx_pdhg, "_step_size_factors", xla_step_size_factors)
    make, ruiz, alpha, start = SEGMENT_CASES[case]
    problem = make()
    jparams = dataclasses.replace(
        pdhg_params(terminate_on_iteration_limit(1000),
                    ruiz_iterations=ruiz, pock_chambolle_alpha=alpha),
        matrix_format="ell",
    )
    tparams = port_params(jparams)
    jprep = jx_pdhg.prepare_problem(jparams, problem)
    jcfg = jax_config(jparams)
    state = jprep.initial_state
    while int(state.iteration) < start:
        assert int(state.termination_reason) == 0
        state, _ = jx_pdhg._run_segment(
            jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
        )
    tprep = tx_pdhg.prepare_problem(tparams, port_problem(problem),
                                    device="cpu")
    tstate = convert.state_from_arrays(state_leaves(state), device="cpu")
    tcfg = tx_pdhg._make_config(tparams)

    jstate, jres = jx_pdhg._run_segment(
        jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
    )
    tstate, tres = tx_pdhg._segment_core(tprep.bundle, tstate, 0.0, tcfg)

    assert tstate.iteration == int(jstate.iteration) >= start + 30
    assert tstate.total_number_iterations == int(
        jstate.total_number_iterations
    )
    assert tstate.cumulative_kkt_passes == float(jstate.cumulative_kkt_passes)
    assert tres.restart_used == int(jres.restart_used)
    for name, rtol in (("current_primal_solution", 1e-10),
                       ("current_dual_solution", 1e-10),
                       ("current_dual_product", 1e-10),
                       ("avg_primal_out", 1e-10),
                       ("avg_dual_out", 1e-10),
                       ("step_size", 1e-6),
                       ("primal_weight", 1e-10)):
        assert_close_normwise(getattr(tstate, name).numpy(),
                              getattr(jstate, name), rtol, name)
    for name in ("sum_primal_solutions", "sum_dual_solutions"):
        assert_close_normwise(getattr(tstate.avg, name).numpy(),
                              getattr(jstate.avg, name), 1e-6, name)
    for field in jres.conv._fields:
        np.testing.assert_allclose(
            float(getattr(tres.conv, field)),
            float(getattr(jres.conv, field)), rtol=1e-10, atol=1e-13,
            err_msg=field,
        )


SLICE_PROBLEMS = {
    "example_lp": fixtures.example_lp,
    "example_cc_lp": fixtures.example_cc_lp,
    "example_qp": fixtures.example_qp,
    "pagerank300": pagerank,
}


@pytest.mark.parametrize(
    "dtype,fmt,eps", [("float64", "ell", 1e-6), ("float32", "routed", 1e-4)]
)
@pytest.mark.parametrize("name", sorted(SLICE_PROBLEMS))
def test_optimize_matches_jax(name, dtype, fmt, eps):
    problem = SLICE_PROBLEMS[name]()
    jparams = dataclasses.replace(
        pdhg_params(optimality_criteria(eps), ruiz_iterations=10,
                    pock_chambolle_alpha=1.0, record_iteration_stats=False),
        dtype=dtype,
        matrix_format=fmt,
        termination_criteria=dataclasses.replace(
            optimality_criteria(eps), iteration_limit=5000
        ),
    )
    want = jx_pdhg.optimize(jparams, problem)
    got = tx.optimize(port_params(jparams), port_problem(problem),
                      device="cpu")
    print(f"{name} {dtype}: iterations port {got.iteration_count}, "
          f"jax {want.iteration_count}")
    assert got.termination_reason.name == want.termination_reason.name
    assert got.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    ci = got.iteration_stats[-1].convergence_information[0]
    for value in (ci.relative_l2_primal_residual,
                  ci.relative_l2_dual_residual, ci.relative_optimality_gap):
        assert value < eps
    # Both reached the same optimum within the tolerance (the iterates
    # need not agree: PageRank's optimal set is not a point).
    wi = want.iteration_stats[-1].convergence_information[0]
    scale = 1.0 + abs(wi.primal_objective) + abs(wi.dual_objective)
    assert abs(ci.primal_objective - wi.primal_objective) <= 4 * eps * scale


def test_constant_step_matches_jax():
    """The constant step (power-method step size) in f64."""
    problem = fixtures.example_lp()
    jparams = dataclasses.replace(
        pdhg_params(optimality_criteria(1e-8),
                    step_size_policy=jx_pdhg.ConstantStepsizeParams()),
        matrix_format="dense",
    )
    want = jx_pdhg.optimize(jparams, problem)
    got = tx.optimize(port_params(jparams), port_problem(problem),
                      device="cpu")
    print(f"constant step: iterations port {got.iteration_count}, "
          f"jax {want.iteration_count}")
    assert got.termination_reason == want.termination_reason
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=1e-6)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=1e-6)


def test_evaluations_per_dispatch_groups_the_stats():
    """Several evaluations per dispatch change what is reported, not the
    trajectory: the same iterate, one stats entry per dispatch."""
    problem = port_problem(fixtures.example_lp())
    params = port_params(pdhg_params(optimality_criteria(1e-8)))
    one = tx.optimize(params, problem, device="cpu")
    three = tx.optimize(
        dataclasses.replace(params, evaluations_per_dispatch=3), problem,
        device="cpu",
    )
    assert three.iteration_count == one.iteration_count
    np.testing.assert_array_equal(three.primal_solution, one.primal_solution)
    assert len(three.iteration_stats) == -(-len(one.iteration_stats) // 3)
    assert (three.iteration_stats[-1].iteration_number
            == one.iteration_stats[-1].iteration_number)


def test_warm_start_state_matches_jax():
    problem = fixtures.example_lp()
    jparams = pdhg_params(optimality_criteria(1e-8), ruiz_iterations=10)
    rng = np.random.default_rng(0)
    warm = (rng.random(4), rng.random(3))
    want = jx_pdhg.prepare_problem(jparams, problem, warm_start=warm)
    got = tx_pdhg.prepare_problem(port_params(jparams),
                                  port_problem(problem), warm_start=warm,
                                  device="cpu")
    leaves = state_leaves(want.initial_state)
    ported = convert.state_from_arrays(leaves, device="cpu")
    for f in dataclasses.fields(got.initial_state):
        a = getattr(got.initial_state, f.name)
        b = getattr(ported, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                       err_msg=f.name)
        elif not dataclasses.is_dataclass(a):
            assert a == b, f.name


def test_entry_points_raise_without_a_gpu():
    params = port_params(pdhg_params(optimality_criteria(1e-4)))
    problem = port_problem(fixtures.example_lp())
    if torch.cuda.is_available():
        assert tx_pdhg.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.optimize(params, problem)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.prepare_problem(params, problem)


def test_unported_features_raise():
    """What is left: the profiler-trace parameter. (Malitsky-Pock, the
    checkpoint parameters and Mirror Prox are ported; their tests are
    below, in test_torch_checkpoint.py and in
    test_torch_mirror_prox.py.)"""
    problem = port_problem(fixtures.example_lp())
    base = port_params(pdhg_params(optimality_criteria(1e-4)))
    with pytest.raises(NotImplementedError):
        tx.optimize(dataclasses.replace(base, profiler_trace_dir="trace"),
                    problem, device="cpu")
    with pytest.raises(TypeError):
        tx.optimize(object(), problem, device="cpu")


MALITSKY_POCK = jx_pdhg.MalitskyPockStepsizeParameters(0.7, 1.0, 1.0)


def test_lp_malitsky_pock():
    """tests/test_pdhg.py's test_lp_malitsky_pock through both packages."""
    problem = fixtures.example_lp()
    jparams = pdhg_params(optimality_criteria(1e-9),
                          step_size_policy=MALITSKY_POCK)
    want = jx_pdhg.optimize(jparams, problem)
    got = tx.optimize(port_params(jparams), port_problem(problem),
                      device="cpu")
    print(f"malitsky-pock: iterations port {got.iteration_count}, "
          f"jax {want.iteration_count}")
    assert got.termination_reason == want.termination_reason
    assert got.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    np.testing.assert_allclose(got.primal_solution, [1.0, 0.0, 6.0, 2.0],
                               atol=1e-7)
    np.testing.assert_allclose(got.dual_solution, [0.5, 4.0, 0.0],
                               atol=1e-7)
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=2e-7)


def malitsky_pock_state(iterations):
    """(JAX bundle, JAX state after `iterations` Malitsky-Pock steps on
    example_lp, port bundle, the same state in the port), in f64."""
    problem = fixtures.example_lp()
    jparams = dataclasses.replace(
        pdhg_params(terminate_on_iteration_limit(1000),
                    step_size_policy=MALITSKY_POCK, ruiz_iterations=10),
        matrix_format="dense",
    )
    jprep = jx_pdhg.prepare_problem(jparams, problem)
    state = jprep.initial_state
    for _ in range(iterations):
        state = jx_pdhg._take_step_malitsky_pock(
            jprep.bundle.scaled, state, MALITSKY_POCK
        )
    tprep = tx_pdhg.prepare_problem(port_params(jparams),
                                    port_problem(problem), device="cpu")
    return (jprep.bundle, state, tprep.bundle,
            convert.state_from_arrays(state_leaves(state), device="cpu"))


def assert_pdhg_states_close(tstate, jstate, rtol):
    for name in ("iteration", "total_number_iterations", "numerical_error"):
        assert getattr(tstate, name) == getattr(jstate, name).item(), name
    assert tstate.cumulative_kkt_passes == float(
        jstate.cumulative_kkt_passes
    )
    for name in ("current_primal_solution", "current_dual_solution",
                 "current_dual_product", "delta_primal", "delta_dual",
                 "step_size", "ratio_step_sizes", "primal_weight"):
        assert_close_normwise(getattr(tstate, name).numpy(),
                              getattr(jstate, name), rtol, name)
    for name in ("sum_primal_solutions", "sum_dual_solutions",
                 "sum_primal_solution_weights", "sum_dual_solution_weights"):
        assert_close_normwise(getattr(tstate.avg, name).numpy(),
                              getattr(jstate.avg, name), rtol, name)
    for name in ("sum_primal_solutions_count", "sum_dual_solutions_count"):
        assert getattr(tstate.avg, name) == int(getattr(jstate.avg, name))


@pytest.mark.parametrize("iterations", [0, 7])
def test_take_step_malitsky_pock_from_jax_state_f64(iterations):
    """One linesearch step at rtol 1e-10: from the initial state (the
    nonsymmetric first average: the primal count runs one ahead of the
    dual count) and from a state a few steps in."""
    jbundle, state, tbundle, tstate = malitsky_pock_state(iterations)
    policy = tx.MalitskyPockStepsizeParameters(0.7, 1.0, 1.0)
    want = jx_pdhg._take_step_malitsky_pock(jbundle.scaled, state,
                                            MALITSKY_POCK)
    got = tx_pdhg._take_step_malitsky_pock(tbundle.scaled, tstate, policy)
    assert got.iteration == iterations + 2
    assert got.avg.sum_primal_solutions_count == (
        got.avg.sum_dual_solutions_count + 1
    )
    assert_pdhg_states_close(got, want, 1e-10)


def test_malitsky_pock_sixty_rejections_flag_a_numerical_error():
    """A breaking factor of 0 rejects every trial: after 60 of them the
    step is a numerical error and the state is untouched, apart from the
    accounting (half a pass for the primal step and for each trial)."""
    jbundle, state, tbundle, tstate = malitsky_pock_state(3)
    want = jx_pdhg._take_step_malitsky_pock(
        jbundle.scaled, state,
        jx_pdhg.MalitskyPockStepsizeParameters(0.7, 0.0, 1.0),
    )
    got = tx_pdhg._take_step_malitsky_pock(
        tbundle.scaled, tstate, tx.MalitskyPockStepsizeParameters(0.7, 0.0, 1.0)
    )
    assert got.numerical_error and bool(want.numerical_error)
    assert got.iteration == tstate.iteration
    assert got.total_number_iterations == tstate.total_number_iterations + 60
    assert got.cumulative_kkt_passes == tstate.cumulative_kkt_passes + 30.5
    assert_pdhg_states_close(got, want, 0.0)
    for name in ("current_primal_solution", "current_dual_solution",
                 "step_size", "ratio_step_sizes"):
        assert torch.equal(getattr(got, name), getattr(tstate, name)), name
    assert got.avg is tstate.avg


def _port_sources():
    pkg = os.path.join(REPO, "firstorderlp_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_neither_jax_nor_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "firstorderlp_tpu"), name


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import firstorderlp_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'firstorderlp_tpu')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
