"""The port's certified-1e-8 path against the JAX package's, on the CPU.

- host_stats (strict f64 numpy) and _shifted_data at rtol 1e-12.
- A shifted solve whose equality mask has promoted rows in the middle
  (no device code path may read the mask as a prefix length).
- The whole slice: optimize_split_precision and
  optimize_iterative_refinement with device="cpu" and the f32 phases
  forced onto the tile-plan operator's plain versions, against the JAX
  package's entry points: the same termination reason, host-f64 relative
  residuals and gap under 1e-8 (recomputed with the JAX package's
  host_stats), the same used_fallback. Iteration counts are printed,
  not asserted: the f32 trajectory depends on summation order.
- Where the port departs from the reference on purpose: an f32
  infeasibility verdict that host f64 does not confirm is never final.
- The hooks the entry points need from models/pdhg, and the device rule.
"""

import dataclasses
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import host_stats as jx_host
from firstorderlp_tpu import refine as jx_refine

import firstorderlp_torch as tx
from firstorderlp_torch import host_stats as tx_host
from firstorderlp_torch import refine as tx_refine
from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import routed as tx_routed

import fixtures
from test_torch_pdhg import port_params, port_problem
from utils import optimality_criteria, pdhg_params

OPTIMAL = "TERMINATION_REASON_OPTIMAL"


def assert_namedtuples_close(got, want):
    assert type(got).__name__ == type(want).__name__
    for key, w in want._asdict().items():
        np.testing.assert_allclose(
            float(getattr(got, key)), float(w), rtol=1e-12, atol=1e-14,
            err_msg=key,
        )


@pytest.mark.parametrize("name", ["example_lp", "example_qp"])
def test_host_stats_match_reference(name):
    p = getattr(fixtures, name)()
    q = port_problem(p)
    m, n = p.constraint_matrix.shape
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=n), rng.normal(size=m)
    assert_namedtuples_close(
        tx_host.host_convergence_information(q, x, y, 1.0),
        jx_host.host_convergence_information(p, x, y, 1.0),
    )
    assert_namedtuples_close(
        tx_host.host_infeasibility_information(q, x, y),
        jx_host.host_infeasibility_information(p, x, y),
    )
    np.testing.assert_allclose(
        tx_host.host_primal_residual_norms(q, x),
        jx_host.host_primal_residual_norms(p, x), rtol=1e-12,
    )
    got, want = tx_host.host_qp_cache(q), jx_host.host_qp_cache(p)
    for field in dataclasses.fields(want):
        np.testing.assert_allclose(getattr(got, field.name),
                                   getattr(want, field.name), rtol=1e-12)


def test_host_optimality_met_matches_reference():
    p = fixtures.example_lp()
    q = port_problem(p)
    x = np.array([1.0, 0.0, 6.0, 2.0])
    y = np.array([0.5, 4.0, 0.0])
    for shift, want in ((0.0, True), (1e-3, False)):
        xs = x + shift
        conv_t = tx_host.host_convergence_information(q, xs, y, 1.0)
        conv_j = jx_host.host_convergence_information(p, xs, y, 1.0)
        crit = optimality_criteria(1e-8)
        got = tx_host.host_optimality_met(
            port_params(pdhg_params(crit)).termination_criteria, conv_t,
            tx_host.host_qp_cache(q),
        )
        assert got == want
        assert got == jx_host.host_optimality_met(
            crit, conv_j, jx_host.host_qp_cache(p)
        )


def inequality_lp():
    """8 rows (2 equalities), 6 bounded variables; seeded."""
    rng = np.random.default_rng(5)
    a = sp.random(8, 6, density=0.6, random_state=5, format="csc")
    return jx.QuadraticProgrammingProblem(
        variable_lower_bound=np.array([0.0, 0.0, -1.0, -np.inf, 0.0, 0.0]),
        variable_upper_bound=np.array([2.0, np.inf, 1.0, 3.0, np.inf, 1.0]),
        objective_matrix=sp.csc_matrix((6, 6)),
        objective_vector=rng.normal(size=6),
        objective_constant=0.5,
        constraint_matrix=a,
        right_hand_side=rng.normal(size=8),
        num_equalities=2,
    )


SHIFT_CASES = {
    # inequality rows 3, 5 and 6 carry clearly positive duals: promoted
    "lp_promoted_rows": lambda: (
        inequality_lp(),
        np.array([0.0, 0.3, 1.0, 0.5, 0.0, 1.0]),
        np.array([0.4, -0.2, 1e-9, 0.7, 0.0, 0.9, 0.3, 1e-7]),
        dict(alpha=1e4, promote_threshold=1e-3, rel_tol=1e-3),
    ),
    # LP variables within the at-bound tolerance get fixed and snapped
    "lp_near_bounds": lambda: (
        inequality_lp(),
        np.array([1e-7, 0.3, 1.0 - 1e-7, 0.5, 2e-7, 1.0]),
        np.array([0.4, -0.2, 0.0, 0.7, 0.0, 0.9, 0.3, 0.0]),
        dict(alpha=3e5, promote_threshold=0.5, rel_tol=1e-2),
    ),
    # QP variables exactly at their bounds
    "qp_at_bounds": lambda: (
        fixtures.example_qp2(), np.array([0.25, 0.0]), np.array([0.1]),
        dict(alpha=1e5, promote_threshold=1e-2, rel_tol=1e-3),
    ),
    "qp_interior": lambda: (
        fixtures.example_qp(), np.array([0.2, 0.8]), np.array([0.3]),
        dict(alpha=1e6, promote_threshold=np.inf, rel_tol=1e-4),
    ),
}


@pytest.mark.parametrize("case", sorted(SHIFT_CASES))
def test_shifted_data_matches_reference(case):
    p, x0, y0, kw = SHIFT_CASES[case]()
    want = jx_refine._shifted_data(p, x0, y0, **kw)
    got = tx_refine._shifted_data(port_problem(p), x0, y0, **kw)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    eq_mask = got[4]
    k = p.num_equalities
    if case == "lp_promoted_rows":
        assert eq_mask.tolist() == [True, True, False, True, False, True,
                                    True, False]
    if case == "lp_near_bounds":
        fixed = (got[2] == 0.0) & (got[3] == 0.0)
        assert fixed.any() and not fixed.all()
        assert np.any(got[6] != x0)  # snapped to the bound
    assert eq_mask[:k].all()


def masked_lp():
    """min c'x, rows 1, 3 and 4 equalities once promoted; only row 0 is
    an equality at ingest."""
    rng = np.random.default_rng(17)
    a = sp.csc_matrix(rng.normal(size=(6, 5)))
    x_feas = rng.uniform(0.2, 0.8, size=5)
    slack = np.array([0.0, 0.0, 0.3, 0.0, 0.0, 0.5])
    return jx.QuadraticProgrammingProblem(
        variable_lower_bound=np.zeros(5),
        variable_upper_bound=np.ones(5),
        objective_matrix=sp.csc_matrix((5, 5)),
        objective_vector=rng.normal(size=5),
        objective_constant=0.0,
        constraint_matrix=a,
        right_hand_side=a @ x_feas - slack,
        num_equalities=1,
    )


def test_equality_mask_with_promoted_rows_in_the_middle():
    """The shifted solve swaps an is_equality mask whose True rows are
    not a prefix. Solving with that mask must give the optimum of the
    same problem with its rows reordered equalities-first, which the
    ordinary ingest solves: no device path reads the mask as "the first
    k rows"."""
    p = masked_lp()
    eq_mask = np.array([True, True, False, True, True, False])
    params = port_params(pdhg_params(optimality_criteria(1e-6),
                                     ruiz_iterations=10))
    p1 = tx_refine.phase1_params(params, 1e-5)
    q = port_problem(p)
    prepared = tx.prepare_problem(p1, q, device="cpu")
    shifted = tx_refine._prepare_shifted_fast(
        prepared, p1, q.objective_vector, q.right_hand_side,
        q.variable_lower_bound, q.variable_upper_bound, eq_mask,
    )
    for qp in (shifted.bundle.scaled, shifted.bundle.original):
        assert qp.is_equality.tolist() == eq_mask.tolist()
        assert qp.is_equality_f32.tolist() == eq_mask.astype(float).tolist()
    out = tx_pdhg.optimize(p1, q, prepared=shifted)
    assert out.termination_reason.name == OPTIMAL

    order = np.r_[np.flatnonzero(eq_mask), np.flatnonzero(~eq_mask)]
    reordered = dataclasses.replace(
        q,
        constraint_matrix=sp.csc_matrix(q.constraint_matrix.tocsr()[order]),
        right_hand_side=q.right_hand_side[order],
        num_equalities=int(eq_mask.sum()),
    )
    want = tx_pdhg.optimize(p1, reordered, device="cpu")
    assert want.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution, want.primal_solution,
                               atol=2e-4)
    np.testing.assert_allclose(out.dual_solution[order], want.dual_solution,
                               atol=2e-3)
    # the prefix reading of the same mask is another problem
    prefix = tx_pdhg.optimize(
        p1, dataclasses.replace(q, num_equalities=int(eq_mask.sum())),
        device="cpu",
    )
    assert (
        prefix.termination_reason.name != OPTIMAL
        or np.abs(prefix.primal_solution - want.primal_solution).max() > 1e-2
    )

    # and the reference's shifted solve agrees
    jp1 = jx_refine.phase1_params(
        pdhg_params(optimality_criteria(1e-6), ruiz_iterations=10), 1e-5
    )
    jprep = jx_refine._prepare(jp1, p)
    jshift = jx_refine._prepare_shifted_fast(
        jprep, jp1, p.objective_vector, p.right_hand_side,
        p.variable_lower_bound, p.variable_upper_bound, eq_mask,
    )
    jout = jx_refine._optimize(jp1, p, jshift)
    assert jout.termination_reason.name == OPTIMAL
    np.testing.assert_allclose(out.primal_solution,
                               np.asarray(jout.primal_solution), atol=2e-4)


@pytest.fixture
def tile_plan_forced(monkeypatch):
    """The f32 phases run on the tile-plan operator (its plain versions
    on the CPU): the layout switch on, and the phase-1 format forced to
    the kernel operator, which "auto" picks only for a large matrix on
    a card. Yields the count of fused-step calls."""
    monkeypatch.setattr(tx_routed, "DEFAULT_TILE_ALIGNED", True)
    monkeypatch.setattr(tx_refine, "_phase1_format", lambda params: "routed")
    calls = {"dual": 0}
    plain = tx_routed.tiled_dual_step_plain

    def counted(*args):
        calls["dual"] += 1
        return plain(*args)

    monkeypatch.setattr(tx_routed, "tiled_dual_step_plain", counted)
    return calls


def jx_params(infeasible):
    crit = optimality_criteria(1e-8)
    if infeasible:
        crit = dataclasses.replace(crit, eps_primal_infeasible=1e-10,
                                   eps_dual_infeasible=1e-10)
    return pdhg_params(crit, ruiz_iterations=10)


def assert_certified(p, out):
    """Relative residuals and gap of `out` on the host problem, in f64
    with the JAX package's host_stats."""
    conv = jx_host.host_convergence_information(
        p, out.primal_solution, out.dual_solution, 1.0
    )
    assert conv.relative_l2_primal_residual < 1e-8
    assert conv.relative_l2_dual_residual < 1e-8
    assert abs(conv.relative_optimality_gap) < 1e-8


# the problems of tests/test_refine.py: (fixture, x*, infeasible)
SLICE_PROBLEMS = {
    "example_lp": ([1.0, 0.0, 6.0, 2.0], False),
    "example_qp": ([0.2, 0.8], False),
    "example_qp2": ([0.25, 0.0], False),
    "example_lp_easy_primal_infeasible": (None, True),
}


@pytest.mark.parametrize("name", sorted(SLICE_PROBLEMS))
def test_split_precision_matches_reference(name, tile_plan_forced):
    x_star, infeasible = SLICE_PROBLEMS[name]
    p = getattr(fixtures, name)()
    params = jx_params(infeasible)
    want = jx_refine.optimize_split_precision(params, p)
    got = tx.optimize_split_precision(port_params(params), port_problem(p),
                                      device="cpu")
    print(f"{name}: iterations port {got.iteration_count} "
          f"reference {want.iteration_count}")
    assert got.termination_reason.name == want.termination_reason.name
    if infeasible:
        assert got.termination_reason.name == (
            "TERMINATION_REASON_PRIMAL_INFEASIBLE"
        )
        return
    assert got.termination_reason.name == OPTIMAL
    assert tile_plan_forced["dual"] > 0 or name != "example_lp"
    assert_certified(p, want)
    assert_certified(p, got)
    np.testing.assert_allclose(got.primal_solution, x_star, atol=1e-6)
    last = got.iteration_stats[-1]
    assert last.cumulative_kkt_matrix_passes > 0
    assert last.iteration_number >= got.iteration_count - 1


@pytest.mark.parametrize("name", sorted(SLICE_PROBLEMS))
def test_iterative_refinement_matches_reference(name, tile_plan_forced):
    x_star, infeasible = SLICE_PROBLEMS[name]
    p = getattr(fixtures, name)()
    params = jx_params(infeasible)
    want, want_fallback = jx_refine.optimize_iterative_refinement(params, p)
    got, got_fallback = tx.optimize_iterative_refinement(
        port_params(params), port_problem(p), device="cpu"
    )
    print(f"{name}: iterations port {got.iteration_count} "
          f"reference {want.iteration_count}")
    assert got.termination_reason.name == want.termination_reason.name
    assert got_fallback == want_fallback
    assert not got_fallback  # as tests/test_refine.py asserts
    if infeasible:
        assert got.termination_reason.name == (
            "TERMINATION_REASON_PRIMAL_INFEASIBLE"
        )
        return
    assert got.termination_reason.name == OPTIMAL
    assert_certified(p, want)
    assert_certified(p, got)
    np.testing.assert_allclose(got.primal_solution, x_star, atol=1e-6)
    ci = got.iteration_stats[-1].convergence_information[0]
    assert ci.relative_optimality_gap < 1e-8
    # the certified entry says how many shifted rounds it took
    assert "refinement_rounds" in (
        got.iteration_stats[-1].method_specific_stats
    )


def test_iterative_refinement_falls_back_when_needed(tile_plan_forced):
    """max_rounds=0 forces the f64 tail; the result is still OPTIMAL,
    in the port as in the reference."""
    p = fixtures.example_lp()
    params = jx_params(False)
    want, want_fallback = jx_refine.optimize_iterative_refinement(
        params, p, max_rounds=0
    )
    got, got_fallback = tx.optimize_iterative_refinement(
        port_params(params), port_problem(p), max_rounds=0, device="cpu"
    )
    assert want_fallback and got_fallback
    assert got.termination_reason.name == want.termination_reason.name
    assert got.termination_reason.name == OPTIMAL
    assert tile_plan_forced["dual"] > 0
    assert_certified(p, got)


def test_phase1_params_and_formats():
    params = port_params(pdhg_params(optimality_criteria(1e-8)))
    p1 = tx.phase1_params(params, switch_tolerance=1e-6)
    want = jx_refine.phase1_params(
        pdhg_params(optimality_criteria(1e-8)), 1e-6
    )
    assert (p1.dtype, p1.stats_dtype, p1.matrix_format) == (
        want.dtype, want.stats_dtype, want.matrix_format
    ) == ("float32", "float32", "auto")
    assert p1.termination_criteria.eps_optimal_relative == 1e-6
    assert p1.termination_criteria.eps_optimal_absolute == 1e-6
    loose = port_params(pdhg_params(optimality_criteria(1e-4)))
    assert tx.phase1_params(
        loose
    ).termination_criteria.eps_optimal_relative == 1e-4
    for fmt in ("auto", "routed", "ell", "dense", "coo", "dense_onchip"):
        shim = types.SimpleNamespace(matrix_format=fmt)
        assert tx_refine._phase1_format(shim) == jx_refine._phase1_format(shim)
        assert tx_refine._tail_format(shim) == jx_refine._tail_format(shim)


def fake_phase1(problem, reason, value):
    """The fields of a phase-1 output with every entry `value`."""
    m, n = problem.constraint_matrix.shape
    return dict(
        primal_solution=np.full(n, value), dual_solution=np.full(m, value),
        termination_reason=reason, termination_string="PRIMAL_INFEASIBLE",
        iteration_count=40, iteration_stats=[],
    )


@pytest.mark.parametrize("entry", ["split_precision",
                                    "iterative_refinement"])
def test_unconfirmed_infeasibility_is_a_numerical_error(entry, monkeypatch):
    """Where the port departs from the reference on purpose. A phase-1
    output with an infeasibility reason that host f64 does not confirm
    and a non-finite iterate is neither refinable nor trusted. The
    reference's callers throw the trust flag away
    (firstorderlp_tpu/refine.py:184 and :630, `refinable, _ = ...`) and
    return the unconfirmed verdict as final; the port returns
    TERMINATION_REASON_NUMERICAL_ERROR."""
    p = fixtures.example_lp()  # feasible: no certificate can be confirmed
    q = port_problem(p)

    def fake(package):
        fields = fake_phase1(
            p, package.TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE,
            np.nan,
        )
        out = package.SaddlePointOutput(**fields)
        return lambda params, problem, prepared, elapsed_offset=0.0: out

    monkeypatch.setattr(tx_refine, "_optimize", fake(tx))
    monkeypatch.setattr(jx_refine, "_optimize", fake(jx))
    jparams = jx_params(False)
    tparams = port_params(jparams)
    with np.errstate(invalid="ignore"):
        if entry == "split_precision":
            got = tx.optimize_split_precision(tparams, q, device="cpu")
            want = jx_refine.optimize_split_precision(jparams, p)
        else:
            got, got_fb = tx.optimize_iterative_refinement(
                tparams, q, device="cpu"
            )
            want, _ = jx_refine.optimize_iterative_refinement(jparams, p)
            assert not got_fb
    assert got.termination_reason.name == (
        "TERMINATION_REASON_NUMERICAL_ERROR"
    )
    assert got.termination_string == "NUMERICAL_ERROR"
    # the divergence: the reference hands the unconfirmed verdict back
    assert want.termination_reason.name == (
        "TERMINATION_REASON_PRIMAL_INFEASIBLE"
    )


def test_phase1_verdict():
    crit = port_params(
        pdhg_params(optimality_criteria(1e-8))
    ).termination_criteria
    q = port_problem(fixtures.example_lp())
    reason = tx.TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE
    finite = tx.SaddlePointOutput(**fake_phase1(q, reason, 0.0))
    # unconfirmed, finite: seeds the refinement path, never final
    assert tx_refine._phase1_verdict(q, crit, finite) == (True, False)
    with np.errstate(invalid="ignore"):
        nan = tx.SaddlePointOutput(**fake_phase1(q, reason, np.nan))
        assert tx_refine._phase1_verdict(q, crit, nan) == (False, False)
    optimal = dataclasses.replace(
        finite,
        termination_reason=tx.TerminationReason.TERMINATION_REASON_OPTIMAL,
    )
    assert tx_refine._phase1_verdict(q, crit, optimal) == (True, True)
    time_limit = dataclasses.replace(
        finite,
        termination_reason=(
            tx.TerminationReason.TERMINATION_REASON_TIME_LIMIT
        ),
    )
    assert tx_refine._phase1_verdict(q, crit, time_limit) == (False, True)


def test_confirmed_infeasibility_stays_final():
    """tests/test_refine.py expects the confirmed certificate of
    example_lp_easy_primal_infeasible to stand; so does the port."""
    p = fixtures.example_lp_easy_primal_infeasible()
    params = port_params(pdhg_params(optimality_criteria(1e-8)))
    out, used_fallback = tx.optimize_iterative_refinement(
        params, port_problem(p), device="cpu"
    )
    assert not used_fallback
    assert out.termination_reason == (
        tx.TerminationReason.TERMINATION_REASON_PRIMAL_INFEASIBLE
    )


def test_mirror_prox_is_not_ported():
    """The name is from before Mirror Prox was ported, when both hooks
    raised for it. Now they dispatch on the parameter type: Mirror Prox
    parameters get Mirror Prox's prepare and solver (the entry points
    themselves are held in test_torch_mirror_prox.py)."""
    from firstorderlp_torch.models import mirror_prox as tx_mp
    from test_mirror_prox import mp_params
    from test_torch_mirror_prox import port_mp_params

    q = port_problem(fixtures.example_lp())
    mp = port_mp_params(mp_params(optimality_criteria(1e-6),
                                  diagonal_scaling="l2"))
    prepared = tx_refine._prepare(mp, q, device="cpu")
    assert isinstance(prepared, tx_mp.PreparedMpProblem)
    out = tx_refine._optimize(mp, q, prepared)
    assert out.termination_reason.name == OPTIMAL
    # the tail's prepare stays on the earlier phase's device
    tail = tx_refine._prepare(mp, q, warm_start=(out.primal_solution,
                                                 out.dual_solution),
                              _reuse=prepared)
    assert tail.device == prepared.device
    pdhg = tx_refine._prepare(
        port_params(pdhg_params(optimality_criteria(1e-6))), q, device="cpu"
    )
    assert isinstance(pdhg, tx_pdhg.PreparedProblem)


def test_entry_points_follow_the_device_rule():
    q = port_problem(fixtures.example_lp())
    params = port_params(jx_params(False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx.optimize_split_precision(params, q)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx.optimize_iterative_refinement(params, q)
    # a prepared problem brings its device: every phase stays on it
    prepared = tx.prepare_problem(tx.phase1_params(params), q, device="cpu")
    seen = []
    inner = tx_refine._optimize

    def watching(stage_params, problem, stage_prepared, elapsed_offset=0.0):
        seen.append(stage_prepared.device.type)
        seen.append(
            stage_prepared.bundle.scaled.objective_vector.device.type
        )
        return inner(stage_params, problem, stage_prepared, elapsed_offset)

    tx_refine._optimize = watching
    try:
        out, _ = tx.optimize_iterative_refinement(
            params, q, prepared=prepared, max_rounds=1
        )
    finally:
        tx_refine._optimize = inner
    assert out.termination_reason.name == OPTIMAL
    assert len(seen) >= 4 and set(seen) == {"cpu"}


def test_prepare_reuses_an_earlier_phase():
    q = port_problem(fixtures.example_lp())
    params = port_params(jx_params(False))
    first = tx.prepare_problem(params, q, device="cpu")  # f64, f64 stats
    f32 = dataclasses.replace(params, dtype="float32",
                              stats_dtype="float64")
    again = tx.prepare_problem(f32, q, _reuse=first)
    assert again.device == first.device
    assert again.scaled_problem is first.scaled_problem
    assert again.bundle.original is first.bundle.original
    assert again.bundle.qp_cache is first.bundle.qp_cache
    assert again.bundle.scaled.objective_vector.dtype == torch.float32
    # another stats dtype: nothing of the bundle can be reused
    other = tx.prepare_problem(
        dataclasses.replace(f32, stats_dtype="float32"), q, _reuse=first
    )
    assert other.bundle.original is not first.bundle.original
    assert other.bundle.original.objective_vector.dtype == torch.float32
    warm = tx.prepare_problem(
        params, q, _reuse=first, warm_start=(np.ones(4), np.ones(3)),
    )
    np.testing.assert_allclose(
        warm.initial_state.current_primal_solution.numpy(),
        first.scaled_problem.variable_rescaling,
    )


def test_elapsed_offset_pre_charges_the_time_limit():
    q = port_problem(fixtures.example_lp())
    params = port_params(jx_params(False))
    limited = dataclasses.replace(
        params,
        termination_criteria=dataclasses.replace(
            params.termination_criteria, time_sec_limit=1000.0
        ),
    )
    out = tx_pdhg.optimize(limited, q, device="cpu")
    assert out.termination_reason.name == OPTIMAL
    out = tx_pdhg.optimize(limited, q, device="cpu", _elapsed_offset=1000.0)
    assert out.termination_reason.name == "TERMINATION_REASON_TIME_LIMIT"
    assert out.iteration_stats[-1].cumulative_time_sec >= 1000.0


def test_time_limit_is_global_across_phases():
    """With the budget spent in phase 1, neither entry point starts another
    phase, and an OPTIMAL that holds only at the relaxed switch
    tolerance is not reported as the caller's."""
    q = port_problem(fixtures.example_lp())
    params = port_params(jx_params(False))
    calls = []
    inner = tx_refine._optimize

    def slow_phase1(stage_params, problem, prepared, elapsed_offset=0.0):
        calls.append(stage_params.dtype)
        out = inner(stage_params, problem, prepared, elapsed_offset)
        tx_refine._time.sleep(0.3)
        return out

    limited = dataclasses.replace(
        params,
        termination_criteria=dataclasses.replace(
            params.termination_criteria, time_sec_limit=0.25
        ),
    )
    tx_refine._optimize = slow_phase1
    try:
        out = tx.optimize_split_precision(limited, q, device="cpu")
        out2, used_fallback = tx.optimize_iterative_refinement(
            limited, q, device="cpu"
        )
    finally:
        tx_refine._optimize = inner
    assert calls == ["float32", "float32"]
    assert out.termination_reason.name == "TERMINATION_REASON_TIME_LIMIT"
    assert out2.termination_reason.name == "TERMINATION_REASON_TIME_LIMIT"
    assert used_fallback


def test_offset_stats():
    q = port_problem(fixtures.example_lp())
    params = port_params(jx_params(False))
    out = tx_pdhg.optimize(params, q, device="cpu")
    shifted = tx_refine._offset_stats(out.iteration_stats, 7, 2.5, 1.0)
    for s, base in zip(shifted, out.iteration_stats):
        assert s.iteration_number == base.iteration_number + 7
        assert s.cumulative_kkt_matrix_passes == (
            base.cumulative_kkt_matrix_passes + 2.5
        )
        assert s.cumulative_time_sec == base.cumulative_time_sec + 1.0
