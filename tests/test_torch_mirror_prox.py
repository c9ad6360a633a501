"""The port's Mirror Prox solver against the JAX package's, on the CPU.

- The mirror-map scalings (host numpy) at rtol 1e-12, with an empty row
  and an empty column.
- One step, one evaluation block and one 40-step segment in f64 from the
  same mid-solve state (convert.mp_state_from_arrays), a zero-movement
  state included.
- The whole slice: the solves of tests/test_mirror_prox.py through both
  packages: the same termination reason, solutions within that test's
  own tolerance. Iteration counts are printed, not asserted: the step
  rule amplifies last-bit differences.
- Mirror Prox through both refinement entry points, in f32 on the kernel
  operator's plain versions, and the device rule.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.models import mirror_prox as jx_mp
from firstorderlp_tpu.models.common import HashableCriteria
from firstorderlp_tpu.parallel.sharded import pad_problem

import firstorderlp_torch as tx
from firstorderlp_torch import convert
from firstorderlp_torch import refine as tx_refine
from firstorderlp_torch.models import mirror_prox as tx_mp
from firstorderlp_torch.ops import routed as tx_routed

import fixtures
from test_mirror_prox import LP_OPT_DUAL, LP_OPT_PRIMAL, mp_params
from test_torch_pdhg import (
    assert_close_normwise,
    pagerank,
    port_params,
    port_problem,
    state_leaves,
)
from utils import (
    default_restart_params,
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

OPTIMAL = "TERMINATION_REASON_OPTIMAL"


def port_mp_params(p):
    """The port's MirrorProxParameters with the JAX parameters' values."""
    shared = port_params(pdhg_params(p.termination_criteria,
                                     restart_params=p.restart_params))
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    fields.update(termination_criteria=shared.termination_criteria,
                  restart_params=shared.restart_params)
    return tx.MirrorProxParameters(**fields)


def jax_config(params):
    return jx_mp._MpConfig(
        criteria=HashableCriteria.from_criteria(params.termination_criteria),
        restart_params=params.restart_params,
        termination_evaluation_frequency=(
            params.termination_evaluation_frequency
        ),
        need_bound_estimates=True,
    )


def port_config(params):
    return tx_mp._MpConfig(
        criteria=params.termination_criteria,
        restart_params=params.restart_params,
        termination_evaluation_frequency=(
            params.termination_evaluation_frequency
        ),
        need_bound_estimates=True,
    )


def xla_step_size_factors(iteration, dtype):
    """The port's _step_size_factors with XLA's pow, as the JAX package
    computes them (numpy's f64 pow differs in the last bit for some
    arguments, and the step rule amplifies such a bit)."""
    t = jnp.asarray(iteration, jnp.float64) + 1.0
    return float(1 - t ** (-0.3)), float(1 + t ** (-0.6))


# ---------------------------------------------------------------------------
# Scalings
# ---------------------------------------------------------------------------


def with_empty_row_and_column(p):
    """`p` plus one empty constraint row and one fixed, empty column."""
    m, n = p.constraint_matrix.shape
    a = sp.csc_matrix(
        sp.bmat([[p.constraint_matrix, None], [None, sp.csc_matrix((1, 1))]])
    )
    q = sp.csc_matrix(
        sp.bmat([[p.objective_matrix, None], [None, sp.csc_matrix((1, 1))]])
    )
    return jx.QuadraticProgrammingProblem(
        variable_lower_bound=np.append(p.variable_lower_bound, 0.0),
        variable_upper_bound=np.append(p.variable_upper_bound, 0.0),
        objective_matrix=q,
        objective_vector=np.append(p.objective_vector, 0.0),
        objective_constant=p.objective_constant,
        constraint_matrix=a,
        right_hand_side=np.append(p.right_hand_side, 0.0),
        num_equalities=p.num_equalities,
    )


SCALING_PROBLEMS = {
    "lp_empty": lambda: with_empty_row_and_column(fixtures.example_lp()),
    "qp_empty": lambda: with_empty_row_and_column(fixtures.example_qp()),
    "qp2": fixtures.example_qp2,
}


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("scaling", ["off", "l1", "l2"])
@pytest.mark.parametrize("name", sorted(SCALING_PROBLEMS))
def test_initial_scalings_match(name, scaling, scale_invariant):
    p = SCALING_PROBLEMS[name]()
    q = port_problem(p)
    want = jx_mp._initial_scalings(p, scaling, 0.7)
    got = tx_mp._initial_scalings(q, scaling, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    if name.endswith("empty") and scaling != "off":
        assert got[0][-1] == 1.0 and got[1][-1] == 1.0  # the zero norms
    jparams = dataclasses.replace(
        mp_params(optimality_criteria(1e-8), diagonal_scaling=scaling,
                  primal_importance=0.7),
        scale_invariant_initial_primal_weight=scale_invariant,
    )
    want = jx_mp.initial_mp_scalings(p, jparams)
    got = tx_mp.initial_mp_scalings(q, port_mp_params(jparams))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)


# ---------------------------------------------------------------------------
# One step, one evaluation, one segment, from the same state
# ---------------------------------------------------------------------------

# problem, diagonal scaling, Ruiz iterations, Pock-Chambolle alpha, first
# iteration of the compared segment
STATE_CASES = {
    "example_lp_l2": (fixtures.example_lp, "l2", 10, 1.0, 90),
    "example_qp_off": (fixtures.example_qp, "off", 0, None, 50),
    "pagerank300_l1": (pagerank, "l1", 10, 1.0, 50),
}


def mid_solve(case):
    """(JAX prepared, JAX state at the case's iteration, JAX config, port
    prepared, port config), all in f64."""
    make, scaling, ruiz, alpha, start = STATE_CASES[case]
    problem = make()
    jparams = dataclasses.replace(
        mp_params(terminate_on_iteration_limit(1000),
                  diagonal_scaling=scaling, ruiz_iterations=ruiz,
                  pock_chambolle_alpha=alpha),
        matrix_format="ell",
    )
    jprep = jx_mp.prepare_problem(jparams, problem)
    jcfg = jax_config(jparams)
    state = jprep.initial_state
    while int(state.iteration) < start:
        assert int(state.termination_reason) == 0
        state, _ = jx_mp._run_segment(
            jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
        )
    tparams = port_mp_params(jparams)
    tprep = tx_mp.prepare_problem(tparams, port_problem(problem),
                                  device="cpu")
    return jprep, state, jcfg, tprep, port_config(tparams)


VECTORS = ("current_primal", "current_dual", "primal_scaling",
           "dual_scaling", "avg_primal_out", "avg_dual_out", "step_size",
           "primal_weight")
COUNTERS = ("iteration", "iterations_completed", "accepted_iterations",
            "numerical_error", "termination_reason")


def leaves_of(state, prefix=""):
    """(path, tensor) of every leaf of a state, nested dataclasses
    walked."""
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if dataclasses.is_dataclass(value):
            yield from leaves_of(value, prefix + f.name + ".")
        else:
            yield prefix + f.name, value


def assert_states_close(tstate, jstate, rtol):
    for name in COUNTERS:
        assert int(getattr(tstate, name)) == int(getattr(jstate, name)), name
    assert float(tstate.cumulative_kkt_passes) == float(
        jstate.cumulative_kkt_passes
    )
    assert tstate.cumulative_kkt_passes.dtype == torch.float64
    assert tstate.iteration.dtype == torch.int64
    for name in VECTORS:
        assert_close_normwise(getattr(tstate, name).numpy(),
                              getattr(jstate, name), rtol, name)
    for name in ("sum_primal_solutions", "sum_dual_solutions",
                 "sum_primal_solution_weights", "sum_dual_solution_weights"):
        assert_close_normwise(getattr(tstate.avg, name).numpy(),
                              getattr(jstate.avg, name), rtol, name)
    for name in ("sum_primal_solutions_count", "sum_dual_solutions_count"):
        assert int(getattr(tstate.avg, name)) == int(
            getattr(jstate.avg, name)), name


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_take_step_from_jax_state_f64(case, monkeypatch):
    monkeypatch.setattr(tx_mp, "_step_size_factors", xla_step_size_factors)
    jprep, state, _, tprep, _ = mid_solve(case)
    tstate = convert.mp_state_from_arrays(state_leaves(state), device="cpu")
    want = jx_mp._take_step(jprep.bundle.scaled, state)
    got = tx_mp._take_step(tprep.bundle.scaled, tstate)
    assert not bool(got.numerical_error)
    assert_states_close(got, want, 1e-10)
    # the step's factors come from the state's own counter, a tensor:
    # the step reads nothing back, and gives the same bits again
    assert isinstance(tstate.iteration, torch.Tensor)
    again = tx_mp._take_step(tprep.bundle.scaled, tstate)
    assert torch.equal(again.current_primal, got.current_primal)
    assert torch.equal(again.step_size, got.step_size)


def test_mp_state_from_arrays_takes_a_dtype():
    """An f64 JAX state carried over as f32: floating leaves narrow, the
    counters, the flag and the KKT passes keep their own types."""
    _, state, _, tprep, _ = mid_solve("example_qp_off")
    narrow = convert.mp_state_from_arrays(state_leaves(state), device="cpu",
                                          dtype=torch.float32)
    for name in VECTORS:
        assert getattr(narrow, name).dtype == torch.float32, name
    assert narrow.avg.sum_primal_solutions.dtype == torch.float32
    assert narrow.restart_info.gap.dtype == torch.float32
    assert narrow.iteration.dtype == torch.int64
    assert narrow.numerical_error.dtype == torch.bool
    assert narrow.cumulative_kkt_passes.dtype == torch.float64
    assert int(narrow.iteration) == int(state.iteration)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_take_step_with_zero_movement(case):
    """movement == 0 (here: a zero step size): only the flag changes."""
    jprep, state, _, tprep, _ = mid_solve(case)
    state = dataclasses.replace(
        state, step_size=jnp.zeros((), state.step_size.dtype)
    )
    tstate = convert.mp_state_from_arrays(state_leaves(state), device="cpu")
    want = jx_mp._take_step(jprep.bundle.scaled, state)
    got = tx_mp._take_step(tprep.bundle.scaled, tstate)
    assert bool(want.numerical_error) and bool(got.numerical_error)
    assert_states_close(got, want, 0.0)
    for name in VECTORS:
        assert torch.equal(getattr(got, name), getattr(tstate, name)), name
    # a frozen state stays frozen, whatever the next step would do
    thawed = dataclasses.replace(got, step_size=torch.ones_like(got.step_size))
    after = tx_mp._take_step(tprep.bundle.scaled, thawed)
    assert bool(after.numerical_error)
    assert torch.equal(after.current_primal, got.current_primal)
    assert int(after.iterations_completed) == int(got.iterations_completed)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_eval_block_from_jax_state_f64(case):
    jprep, state, jcfg, tprep, tcfg = mid_solve(case)
    tstate = convert.mp_state_from_arrays(state_leaves(state), device="cpu")
    jstate, jres = jx_mp._eval_block(
        jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
    )
    tstate, tres = tx_mp._eval_block(tprep.bundle, tstate, 0.0, tcfg)
    assert_states_close(tstate, jstate, 1e-10)
    assert tres.restart_used == int(jres.restart_used)
    assert tres.iteration == int(jres.iteration)
    assert tres.cumulative_kkt_passes == float(jres.cumulative_kkt_passes)
    for field in jres.conv._fields:
        np.testing.assert_allclose(
            float(getattr(tres.conv, field)),
            float(getattr(jres.conv, field)), rtol=1e-10, atol=1e-13,
            err_msg=field,
        )
    for field in ("lagrangian_value", "estimated_lower_bound",
                  "estimated_upper_bound"):
        np.testing.assert_allclose(
            float(getattr(tres, field)), float(getattr(jres, field)),
            rtol=1e-8, atol=1e-10, err_msg=field,
        )
    # an already terminated state is left alone: no passes, same reason
    done = dataclasses.replace(
        tstate, termination_reason=torch.tensor(3, dtype=torch.int32))
    kept, res = tx_mp._eval_block(tprep.bundle, done, 0.0, tcfg)
    for (name, a), (_, b) in zip(leaves_of(kept), leaves_of(done)):
        assert torch.equal(a, b), name
    assert res.termination_reason == 3
    assert res.cumulative_kkt_passes == float(done.cumulative_kkt_passes)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_one_segment_from_jax_state_f64(case, monkeypatch):
    """A restart evaluation and 40 iterations at rtol 1e-8; the step size
    and the step-weighted sums at 1e-6 (the required step divides two
    sums with cancellation, so last-bit differences of fused against
    unfused f64 arithmetic grow there)."""
    monkeypatch.setattr(tx_mp, "_step_size_factors", xla_step_size_factors)
    jprep, state, jcfg, tprep, tcfg = mid_solve(case)
    start = int(state.iteration)
    tstate = convert.mp_state_from_arrays(state_leaves(state), device="cpu")
    jstate, jres = jx_mp._run_segment(
        jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
    )
    tstate, tres = tx_mp._segment_core(tprep.bundle, tstate, 0.0, tcfg)
    assert int(tstate.iteration) == int(jstate.iteration) == start + 40
    assert tres.restart_used == int(jres.restart_used)
    for name in COUNTERS:
        assert int(getattr(tstate, name)) == int(getattr(jstate, name)), name
    assert float(tstate.cumulative_kkt_passes) == float(
        jstate.cumulative_kkt_passes
    )
    for name in VECTORS:
        rtol = 1e-6 if name == "step_size" else 1e-8
        assert_close_normwise(getattr(tstate, name).numpy(),
                              getattr(jstate, name), rtol, name)
    for name in ("sum_primal_solutions", "sum_dual_solutions"):
        assert_close_normwise(getattr(tstate.avg, name).numpy(),
                              getattr(jstate.avg, name), 1e-6, name)


def test_numerical_error_stops_the_iteration_counter():
    """The flag comes up mid-segment (a zero step size): the host loop
    steps on without reading it, the state stays put, the device's
    counter stops one past the failing iteration as the reference's
    while-loop does, and the next evaluation reports NUMERICAL_ERROR."""
    jprep, state, jcfg, tprep, tcfg = mid_solve("example_lp_l2")
    state = dataclasses.replace(
        state, step_size=jnp.zeros((), state.step_size.dtype)
    )
    start = int(state.iteration)
    tstate = convert.mp_state_from_arrays(state_leaves(state), device="cpu")
    jstate, _ = jx_mp._run_segment(
        jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg
    )
    tstate, _ = tx_mp._segment_core(tprep.bundle, tstate, 0.0, tcfg)
    assert int(tstate.iteration) == int(jstate.iteration) == start + 1
    assert bool(tstate.numerical_error)
    assert_states_close(tstate, jstate, 1e-10)
    tstate, tres = tx_mp._segment_core(tprep.bundle, tstate, 0.0, tcfg)
    assert tx.TerminationReason(int(tres.termination_reason)) == (
        tx.TerminationReason.TERMINATION_REASON_NUMERICAL_ERROR
    )
    assert int(tstate.iteration) == start + 1


# ---------------------------------------------------------------------------
# Whole solves: the problems of tests/test_mirror_prox.py
# ---------------------------------------------------------------------------

QP_OPT = (np.array([0.2, 0.8]), np.array([0.2]))
LP_OPT = (LP_OPT_PRIMAL, LP_OPT_DUAL)

# name: (problem, JAX parameters, expected reason, optimum or None, atol)
SOLVES = {
    "lp_high_precision": lambda: (
        fixtures.example_lp(), mp_params(optimality_criteria(1e-10)),
        OPTIMAL, LP_OPT, 1e-8),
    "lp_scaling_off": lambda: (
        fixtures.example_lp(),
        mp_params(optimality_criteria(1e-9), diagonal_scaling="off"),
        OPTIMAL, LP_OPT, 1e-7),
    "lp_scaling_l1": lambda: (
        fixtures.example_lp(),
        mp_params(optimality_criteria(1e-9), diagonal_scaling="l1"),
        OPTIMAL, LP_OPT, 1e-7),
    "lp_scaling_l2": lambda: (
        fixtures.example_lp(),
        mp_params(optimality_criteria(1e-9), diagonal_scaling="l2"),
        OPTIMAL, LP_OPT, 1e-7),
    "lp_no_restarts": lambda: (
        fixtures.example_lp(),
        mp_params(optimality_criteria(1e-6),
                  restart_params=default_restart_params(
                      jx.RestartScheme.NO_RESTARTS)),
        OPTIMAL, LP_OPT, 1e-4),
    "lp_with_rescaling": lambda: (
        fixtures.example_lp(),
        mp_params(optimality_criteria(1e-9), ruiz_iterations=10,
                  pock_chambolle_alpha=1.0),
        OPTIMAL, LP_OPT, 1e-7),
    "qp": lambda: (
        fixtures.example_qp(), mp_params(optimality_criteria(1e-9)),
        OPTIMAL, QP_OPT, 1e-7),
    "iteration_limit": lambda: (
        fixtures.example_lp(), mp_params(terminate_on_iteration_limit(80)),
        "TERMINATION_REASON_ITERATION_LIMIT", None, None),
    "primal_infeasible": lambda: (
        fixtures.example_lp_easy_primal_infeasible(),
        mp_params(optimality_criteria(1e-8)),
        "TERMINATION_REASON_PRIMAL_INFEASIBLE", None, None),
    # The certificate at 1e-6: at the reference test's 1e-8 both packages
    # take 130,120 iterations, a minute of eager PyTorch on the CPU.
    "dual_infeasible": lambda: (
        fixtures.example_lp_dual_infeasible(),
        mp_params(dataclasses.replace(optimality_criteria(1e-8),
                                      eps_dual_infeasible=1e-6)),
        "TERMINATION_REASON_DUAL_INFEASIBLE", None, None),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_optimize_matches_jax(name):
    problem, jparams, reason, optimum, atol = SOLVES[name]()
    want = jx.optimize(jparams, problem)
    got = tx.optimize(port_mp_params(jparams), port_problem(problem),
                      device="cpu")
    print(f"{name}: iterations port {got.iteration_count}, "
          f"jax {want.iteration_count}")
    assert got.termination_reason.name == want.termination_reason.name
    assert got.termination_reason.name == reason
    if optimum is not None:
        np.testing.assert_allclose(got.primal_solution, optimum[0], atol=atol)
        np.testing.assert_allclose(got.dual_solution, optimum[1], atol=atol)
        np.testing.assert_allclose(got.primal_solution,
                                   want.primal_solution, atol=2 * atol)
    if name == "iteration_limit":
        # 2 KKT passes per iteration and per evaluation, the same
        # evaluations in both packages
        final = got.iteration_stats[-1]
        assert got.iteration_count == want.iteration_count == 80
        assert final.cumulative_kkt_matrix_passes == (
            want.iteration_stats[-1].cumulative_kkt_matrix_passes
        )
        assert final.cumulative_kkt_matrix_passes >= 2 * 80
        assert len(got.iteration_stats) == len(want.iteration_stats)


def test_padded_problem():
    """Empty rows and columns (a problem padded to a shape): the
    mirror-map scalings must not divide by their zero norms."""
    padded, m, n = pad_problem(fixtures.example_lp(), 8, 8)
    jparams = mp_params(optimality_criteria(1e-8), diagonal_scaling="l1")
    want = jx.optimize(jparams, padded)
    got = tx.optimize(port_mp_params(jparams), port_problem(padded),
                      device="cpu")
    assert got.termination_reason.name == want.termination_reason.name
    assert got.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(got.primal_solution[:n], LP_OPT_PRIMAL,
                               atol=1e-4)
    assert np.all(np.isfinite(got.dual_solution))


def test_evaluations_per_dispatch_1_against_4():
    """Several evaluation blocks per dispatch change what is reported,
    not the trajectory."""
    base = port_mp_params(
        mp_params(optimality_criteria(1e-8), diagonal_scaling="l1")
    )
    problem = port_problem(fixtures.example_lp())
    ref = tx.optimize(base, problem, device="cpu")
    chained = tx.optimize(
        dataclasses.replace(base, evaluations_per_dispatch=4), problem,
        device="cpu",
    )
    assert chained.termination_reason == ref.termination_reason
    assert chained.iteration_count == ref.iteration_count
    np.testing.assert_array_equal(chained.primal_solution,
                                  ref.primal_solution)
    np.testing.assert_array_equal(chained.dual_solution, ref.dual_solution)
    assert len(chained.iteration_stats) == -(-len(ref.iteration_stats) // 4)


def test_prepared_problem_reuse():
    problem = port_problem(fixtures.example_lp())
    params = port_mp_params(
        mp_params(optimality_criteria(1e-8), ruiz_iterations=10)
    )
    plain = tx_mp.optimize(params, problem, device="cpu")
    prepared = tx_mp.prepare_problem(params, problem, device="cpu")
    assert prepared.device.type == "cpu"
    for _ in range(2):
        out = tx_mp.optimize(params, problem, prepared=prepared)
        assert out.termination_reason.name == OPTIMAL
        np.testing.assert_array_equal(out.primal_solution,
                                      plain.primal_solution)
        np.testing.assert_array_equal(out.dual_solution, plain.dual_solution)
        assert out.iteration_count == plain.iteration_count


def assert_same_bits(got, want, path="prepared"):
    """Every compared field equal: tensors bitwise with their dtypes,
    other values by ==."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            if f.compare:
                assert_same_bits(getattr(got, f.name),
                                 getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (u, v) in enumerate(zip(got, want)):
            assert_same_bits(u, v, f"{path}[{i}]")
    else:
        assert got == want, path


def test_prepare_reuses_an_earlier_phase():
    """prepare_problem(_reuse=) keeps an earlier phase's host rescaling
    and original copy, builds the scaled copy anew, and gives a fresh
    prepare's bits: the device bundle, the initial state and the solve."""
    problem = port_problem(fixtures.example_lp())
    params = port_mp_params(mp_params(optimality_criteria(1e-6),
                                      diagonal_scaling="l2"))
    first = tx_mp.prepare_problem(params, problem, device="cpu")  # f64
    f32 = dataclasses.replace(params, dtype="float32",
                              stats_dtype="float64")
    again = tx_mp.prepare_problem(f32, problem, _reuse=first)
    fresh = tx_mp.prepare_problem(f32, problem, device="cpu")
    assert again.scaled_problem is first.scaled_problem
    assert again.bundle.original is first.bundle.original
    assert again.bundle.scaled.objective_vector.dtype == torch.float32
    assert_same_bits(again.bundle, fresh.bundle, "bundle")
    assert_same_bits(again.initial_state, fresh.initial_state, "state")
    got = tx_mp.optimize(f32, problem, prepared=again)
    want = tx_mp.optimize(f32, problem, prepared=fresh)
    assert got.termination_reason.name == want.termination_reason.name
    assert got.iteration_count == want.iteration_count
    np.testing.assert_array_equal(got.primal_solution, want.primal_solution)
    np.testing.assert_array_equal(got.dual_solution, want.dual_solution)
    for g, w in zip(got.iteration_stats, want.iteration_stats, strict=True):
        assert g.convergence_information == w.convergence_information
        assert g.infeasibility_information == w.infeasibility_information
        assert (g.iteration_number, g.cumulative_kkt_matrix_passes,
                g.step_size, g.primal_weight) == (
            w.iteration_number, w.cumulative_kkt_matrix_passes,
            w.step_size, w.primal_weight)


def test_bound_estimates_recovered_without_stats_recording():
    criteria = optimality_criteria(1e-6)
    problem = port_problem(fixtures.example_lp())
    recording = tx.optimize(port_mp_params(mp_params(criteria)), problem,
                            device="cpu")
    silent = tx.optimize(
        dataclasses.replace(port_mp_params(mp_params(criteria)),
                            record_iteration_stats=False),
        problem, device="cpu",
    )
    assert len(silent.iteration_stats) == 1
    ref = recording.iteration_stats[-1].method_specific_stats
    got = silent.iteration_stats[-1].method_specific_stats
    for key in ("lagrangian_value", "estimated_lower_bound",
                "estimated_upper_bound"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-9)


def test_warm_start_state_matches_jax():
    problem = fixtures.example_lp()
    jparams = mp_params(optimality_criteria(1e-8), ruiz_iterations=10,
                        diagonal_scaling="l2")
    rng = np.random.default_rng(0)
    warm = (rng.random(4), rng.random(3))
    want = jx_mp.prepare_problem(jparams, problem, warm_start=warm)
    got = tx_mp.prepare_problem(port_mp_params(jparams),
                                port_problem(problem), warm_start=warm,
                                device="cpu")
    assert_states_close(got.initial_state, want.initial_state, 1e-14)
    np.testing.assert_allclose(
        got.initial_state.restart_info.primal_solution.numpy(),
        want.initial_state.restart_info.primal_solution, rtol=1e-14)


@pytest.mark.parametrize("tile_aligned", [False, True])
def test_f32_solve_on_the_kernel_operator(tile_aligned, monkeypatch):
    """The path chip_smoke.py drives, small: f32, matrix_format="routed"
    (on the CPU: the kernels' plain versions), both layouts."""
    monkeypatch.setattr(tx_routed, "DEFAULT_TILE_ALIGNED", tile_aligned)
    problem = pagerank()
    jparams = dataclasses.replace(
        mp_params(optimality_criteria(1e-4), diagonal_scaling="l2",
                  ruiz_iterations=10, pock_chambolle_alpha=1.0),
        dtype="float32", matrix_format="routed",
        record_iteration_stats=False,
        termination_criteria=dataclasses.replace(
            optimality_criteria(1e-4), iteration_limit=5000,
            eps_primal_infeasible=0.0, eps_dual_infeasible=0.0),
    )
    tparams = port_mp_params(jparams)
    prepared = tx_mp.prepare_problem(tparams, port_problem(problem),
                                     device="cpu")
    op = prepared.bundle.scaled.constraint_matrix
    assert isinstance(op, tx_routed.RoutedOp)
    assert op.tile_aligned == tile_aligned
    got = tx_mp.optimize(tparams, port_problem(problem), prepared=prepared)
    want = jx.optimize(dataclasses.replace(jparams, matrix_format="ell"),
                       problem)
    print(f"pagerank300 f32: iterations port {got.iteration_count}, "
          f"jax {want.iteration_count}")
    assert got.termination_reason.name == want.termination_reason.name
    assert got.termination_reason.name == OPTIMAL
    ci = got.iteration_stats[-1].convergence_information[0]
    for value in (ci.relative_l2_primal_residual,
                  ci.relative_l2_dual_residual, ci.relative_optimality_gap):
        assert value < 1e-4


# ---------------------------------------------------------------------------
# Mirror Prox through the refinement entry points
# ---------------------------------------------------------------------------


def mp_params_1e8():
    """tests/test_refine.py's _mp_params_1e8, for the port."""
    return port_mp_params(mp_params(
        optimality_criteria(1e-8), diagonal_scaling="l2", ruiz_iterations=10,
        pock_chambolle_alpha=1.0,
    ))


def test_mp_split_precision_reaches_1e8():
    out = tx.optimize_split_precision(
        mp_params_1e8(), port_problem(fixtures.example_lp()), device="cpu"
    )
    assert out.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution, LP_OPT_PRIMAL, atol=1e-6)


def test_mp_iterative_refinement_certifies():
    out, used_fallback = tx.optimize_iterative_refinement(
        mp_params_1e8(), port_problem(fixtures.example_lp()), device="cpu"
    )
    print(f"used_fallback {used_fallback}, "
          f"iterations {out.iteration_count}")
    assert out.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution, LP_OPT_PRIMAL, atol=1e-6)
    # certified in f64 on the original problem regardless of path
    ci = out.iteration_stats[-1].convergence_information[0]
    assert ci.relative_l2_primal_residual < 1e-8
    assert ci.relative_l2_dual_residual < 1e-8
    assert abs(ci.relative_optimality_gap) < 1e-8


def test_mp_shifted_prepare_swaps_vectors_on_the_same_bundle():
    """The Mirror Prox branch of _prepare_shifted_fast: the operators are
    phase 1's, the scalings are recomputed from the shifted vectors, the
    step size is phase 1's, the state is fresh."""
    problem = port_problem(fixtures.example_lp())
    p1 = tx.phase1_params(mp_params_1e8())
    prepared = tx_mp.prepare_problem(p1, problem, device="cpu")
    m, n = problem.constraint_matrix.shape
    rng = np.random.default_rng(2)
    c_hat, b_hat = rng.normal(size=n), rng.normal(size=m)
    lo, hi = -np.ones(n), np.ones(n)
    eq = np.array([True, False, True])
    shifted = tx_refine._prepare_shifted_fast(
        prepared, p1, c_hat, b_hat, lo, hi, eq
    )
    assert isinstance(shifted, tx_mp.PreparedProblem)
    assert isinstance(shifted.initial_state, tx_mp.MirrorProxState)
    assert (shifted.bundle.scaled.constraint_matrix
            is prepared.bundle.scaled.constraint_matrix)
    assert torch.equal(shifted.bundle.scaled.is_equality,
                       torch.as_tensor(eq))
    state = shifted.initial_state
    assert torch.equal(state.step_size, prepared.initial_state.step_size)
    assert int(state.iteration) == 1 and state.termination_reason == 0
    sp_prob = prepared.scaled_problem
    shim = dataclasses.replace(
        sp_prob.scaled_qp,
        objective_vector=c_hat / sp_prob.variable_rescaling,
        right_hand_side=b_hat / sp_prob.constraint_rescaling,
    )
    px, py, pw = tx_mp.initial_mp_scalings(shim, p1)
    np.testing.assert_allclose(state.primal_scaling.numpy(), px, rtol=1e-6)
    np.testing.assert_allclose(state.dual_scaling.numpy(), py, rtol=1e-6)
    np.testing.assert_allclose(float(state.primal_weight), pw, rtol=1e-6)


def test_mp_entry_points_raise_without_a_gpu():
    params = port_mp_params(mp_params(optimality_criteria(1e-4)))
    problem = port_problem(fixtures.example_lp())
    if torch.cuda.is_available():
        assert tx_mp.resolve_device(None).type == "cuda"
        return
    for call in (
        lambda: tx.optimize(params, problem),
        lambda: tx_mp.prepare_problem(params, problem),
        lambda: tx.optimize_split_precision(params, problem),
        lambda: tx.optimize_iterative_refinement(params, problem),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
