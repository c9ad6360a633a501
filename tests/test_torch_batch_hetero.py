"""Heterogeneous fleets (firstorderlp_torch.batch.solve_batch), the
per-instance fleet ingest and their lane operators against the JAX
package, on the CPU, in f64.

- parallel.pad_problem against the JAX package's, exactly.
- ops/block_lanes.BlockLanesOp: its plain products against per-lane
  scipy products and against the JAX package's aligned ELL planes
  (_align_ell_ops) under vmap; its int32 limits; the original copy
  sharing the scaled copy's index tensors.
- The per-instance ingest (_prepare_fleet_slow): the initial lane state
  against the JAX package's for adaptive, constant-step, QP and Mirror
  Prox QP fleets.
- One step and one segment of a heterogeneous fleet from the JAX
  package's leading-axis batched state (convert.
  fleet_state_from_leading_arrays), adaptive, constant and with an
  objective matrix.
- Whole heterogeneous fleets: tests/test_batch.py's five fleets against
  the JAX package's solve_batch (the same reasons, solutions within the
  atol those tests use; the L1-SVM path's objectives, whose optima are
  not unique).
- C4: a bound-width fleet's lanes against the JAX package's optimize
  with bound_width_rescaling=True (its own fleets drop the flag).
- Errors and the device rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import batch as jx_batch
from firstorderlp_tpu.generators import (
    generate_l1_svm_lp,
    generate_pagerank_lp,
    random_svm_data,
)
from firstorderlp_tpu.models import pdhg as jx_pdhg
from firstorderlp_tpu.ops.linops import build_sparse_op
from firstorderlp_tpu.parallel.sharded import pad_problem as jx_pad_problem

import firstorderlp_torch as tx
from firstorderlp_torch import batch, convert
from firstorderlp_torch.ops import block_lanes, routed
from firstorderlp_torch.parallel import pad_problem

import fixtures
from test_mirror_prox import mp_params
from test_torch_batch import (
    STEP_TOLERANCE,
    constant_steps,
    fleet_mp_params,
    fleet_pdhg_params,
    pagerank_fleet,
    qp_fleet,
    state_leaves_of_port,
    to_port,
    xla_pdhg_factors,
)
from test_torch_pdhg import (
    assert_close_normwise,
    port_params,
    port_problem,
    state_leaves,
)
from utils import (
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

CPU = torch.device("cpu")
OPTIMAL = "TERMINATION_REASON_OPTIMAL"


def with_q(problem, weight):
    """`problem` with the objective matrix weight * I (a Tikhonov term)."""
    n = problem.constraint_matrix.shape[1]
    return dataclasses.replace(
        problem, objective_matrix=sp.csc_matrix(weight * sp.eye(n)))


def svm_lp(weight=1.0, seed=2):
    data = random_svm_data(n_samples=24, n_features=6, density=0.5,
                           seed=seed)
    return generate_l1_svm_lp(data, regularizer_weight=weight)


# ---------------------------------------------------------------------------
# pad_problem and the block lane operator
# ---------------------------------------------------------------------------

PADS = {
    "lp_to_fleet_shape": (fixtures.example_lp, 7, 9),
    "qp_to_fleet_shape": (fixtures.example_qp, 3, 5),
    "round_up_to_multiples": (lambda: generate_pagerank_lp(30, seed=0),
                              8, 16),
    "already_that_shape": (fixtures.example_lp, 3, 4),
}


@pytest.mark.parametrize("case", sorted(PADS))
def test_pad_problem_matches_jax(case):
    make, rows, cols = PADS[case]
    problem = make()
    want, wm, wn = jx_pad_problem(problem, rows, cols)
    got, gm, gn = pad_problem(port_problem(problem), rows, cols)
    assert (gm, gn) == (wm, wn)
    assert got.num_equalities == want.num_equalities
    assert got.objective_constant == want.objective_constant
    for field in ("variable_lower_bound", "variable_upper_bound",
                  "objective_vector", "right_hand_side"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    for field in ("constraint_matrix", "objective_matrix"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape, field
        assert abs(sp.csr_matrix(g) - sp.csr_matrix(w)).nnz == 0, field


def mixed_matrices():
    """Five matrices of one padded shape with different patterns: the
    constraint matrices of PageRank LPs of 20-45 nodes, one L1-SVM LP
    and an empty one."""
    mats = [generate_pagerank_lp(nodes, seed=nodes).constraint_matrix
            for nodes in (20, 33, 45)]
    mats.append(svm_lp().constraint_matrix)
    m = max(a.shape[0] for a in mats)
    n = max(a.shape[1] for a in mats)
    padded = [sp.csr_matrix((a.tocoo().data, (a.tocoo().row, a.tocoo().col)),
                            shape=(m, n)) for a in mats]
    padded.append(sp.csr_matrix((m, n)))
    return padded


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_lanes_products_match_scipy_and_aligned_ell(dtype):
    """A_b x_b and A_b' y_b per lane: against scipy in f64 (f64: rtol
    1e-12; f32: the f32 rounding of a sum) and, in f64, against the JAX
    package's aligned ELL planes under vmap."""
    mats = mixed_matrices()
    lanes = len(mats)
    m, n = mats[0].shape
    t_dtype = getattr(torch, dtype)
    op = block_lanes.build_block_lanes(mats, CPU, t_dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, lanes))
    y = rng.standard_normal((m, lanes))
    got_ax = op.mv(torch.as_tensor(x).to(t_dtype)).double().numpy()
    got_aty = op.rmv(torch.as_tensor(y).to(t_dtype)).double().numpy()
    assert got_ax.shape == (m, lanes) and got_aty.shape == (n, lanes)
    want_ax = np.stack([a @ x[:, b] for b, a in enumerate(mats)], axis=1)
    want_aty = np.stack([a.T @ y[:, b] for b, a in enumerate(mats)], axis=1)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    for got, want, absmat, v in ((got_ax, want_ax, False, x),
                                 (got_aty, want_aty, True, y)):
        scale = np.stack([
            (abs(a).T if absmat else abs(a)) @ np.abs(v[:, b])
            for b, a in enumerate(mats)], axis=1)
        assert np.all(np.abs(got - want) <= rtol * scale + 1e-300)
    if dtype == "float32":
        # the wrapper's CPU path is the plain version, bit for bit
        plain = block_lanes.block_lanes_spmv_plain(
            op.a, torch.as_tensor(x).float())
        assert torch.equal(plain, op.mv(torch.as_tensor(x).float()))
        return
    ops = jx_batch._align_ell_ops(
        [build_sparse_op(a, jnp.float64, np.asarray) for a in mats])
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([np.asarray(v) for v in xs]), *ops)
    jax_ax = np.asarray(jax.vmap(lambda o, v: o.mv(v))(stacked, x.T)).T
    jax_aty = np.asarray(jax.vmap(lambda o, v: o.rmv(v))(stacked, y.T)).T
    np.testing.assert_allclose(got_ax, jax_ax, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_aty, jax_aty, rtol=1e-12, atol=1e-14)


def test_block_matrix_interleaves_the_lanes():
    """Entry (i, j) of lane b sits at (i B + b, j B + b), so a flattened
    (dim, B) tensor is the block matrix's vector; the f32 operator's
    kernel matrices hold it and its transpose, the original copy reuses
    the scaled copy's index tensors, items and tickets."""
    mats = mixed_matrices()
    lanes = len(mats)
    block = block_lanes.block_matrix(mats)
    assert block.has_canonical_format
    assert block.nnz == sum(a.nnz for a in mats)
    for b, a in enumerate(mats):
        np.testing.assert_array_equal(
            block[b::lanes, b::lanes].toarray(), a.toarray())
    scaled = block_lanes.build_block_lanes(mats, CPU, label="Q")
    assert (scaled.a.label, scaled.at.label) == ("Q", "QT")
    assert isinstance(scaled.a, routed.CsrKernelMatrix)
    doubled = block_lanes.build_block_lanes([2.0 * a for a in mats], CPU,
                                            share_with=scaled)
    assert doubled.a.indices is scaled.a.indices
    assert doubled.at.tickets is scaled.at.tickets
    assert torch.equal(doubled.a.vals, 2.0 * scaled.a.vals)
    other = block_lanes.build_block_lanes(mats[::-1], CPU,
                                          share_with=scaled)
    assert other.a.indices is not scaled.a.indices


def test_block_lanes_refuse_what_int32_cannot_index():
    wide = [sp.csr_matrix(([1.0], ([0], [2**28 - 1])), shape=(1, 2**28))] * 8
    with pytest.raises(ValueError, match="int32"):
        block_lanes.build_block_lanes(wide, CPU)
    # the f64 operator indexes with int64
    op = block_lanes.build_block_lanes(wide[:1], CPU, torch.float64)
    assert op.shape == (1, 2**28)
    with pytest.raises(ValueError, match="pad the fleet"):
        block_lanes.block_matrix([sp.csr_matrix((2, 3)),
                                  sp.csr_matrix((3, 3))])


# ---------------------------------------------------------------------------
# The per-instance ingest: initial lane states
# ---------------------------------------------------------------------------


SLOW_INGESTS = {
    "pdhg_constant": (
        lambda: constant_steps(fleet_pdhg_params(optimality_criteria(1e-6))),
        pagerank_fleet),
    "pdhg_qp": (lambda: fleet_pdhg_params(optimality_criteria(1e-6)),
                qp_fleet),
    "pdhg_qp_constant": (
        lambda: constant_steps(fleet_pdhg_params(optimality_criteria(1e-6))),
        qp_fleet),
    "mirror_prox_qp": (
        lambda: fleet_mp_params(optimality_criteria(1e-6), "l2"), qp_fleet),
    "mirror_prox_qp_l1": (
        lambda: fleet_mp_params(optimality_criteria(1e-6), "l1"), qp_fleet),
}


@pytest.mark.parametrize("case", sorted(SLOW_INGESTS))
def test_slow_ingest_initial_state_matches_jax(case):
    """Step sizes, primal weights, KKT passes (the power method's
    iterations for constant steps) and mirror-map scalings per lane, and
    the scaled bundle's vectors and rescaling, at rtol 1e-12."""
    make_params, make_problems = SLOW_INGESTS[case]
    params, problems = make_params(), make_problems()
    jfleet = jx_batch.prepare_shared_pattern_fleet(params, problems)
    tfleet = batch.prepare_shared_pattern_fleet(
        to_port(params), [port_problem(p) for p in problems], device="cpu")
    want = state_leaves(jfleet.initial_state)
    got = state_leaves_of_port(tfleet.initial_state)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        if np.issubdtype(value.dtype, np.floating):
            np.testing.assert_allclose(got[key], value, rtol=1e-12, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    jb, tb = jfleet.batched_bundle.scaled, tfleet.bundle.scaled
    for field in ("objective_vector", "right_hand_side",
                  "variable_lower_bound", "variable_upper_bound"):
        np.testing.assert_allclose(getattr(tb, field).numpy(),
                                   np.asarray(getattr(jb, field)),
                                   rtol=1e-12, err_msg=field)
    np.testing.assert_allclose(
        tfleet.bundle.variable_rescaling.numpy(),
        np.asarray(jfleet.batched_bundle.variable_rescaling), rtol=1e-12)
    assert (tb.objective_matrix is not None) == case.endswith(
        ("qp", "qp_l1", "qp_constant"))


# ---------------------------------------------------------------------------
# One step and one segment of a heterogeneous fleet from a JAX state
# ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def jax_hetero_start(params, problems, monkeypatch):
    """The JAX package's solve_batch ingest as its loop receives it: its
    leading-axis batched bundle, state and config, taken at the first
    segment call."""
    seen = {}
    real = jx_batch._run_segment_batched

    def capture(bundle, state, elapsed, config):
        seen.update(bundle=bundle, state=state, config=config)
        raise _Captured

    monkeypatch.setattr(jx_batch, "_run_segment_batched", capture)
    with pytest.raises(_Captured):
        jx_batch.solve_batch(params, problems)
    monkeypatch.setattr(jx_batch, "_run_segment_batched", real)
    return seen["bundle"], seen["state"], seen["config"]


def hetero_problems(qp=False):
    """Three sizes, two sparsity families and numbers of equalities 1,
    0, 1; with `qp`, an objective matrix in each (the JAX package's
    solve_batch cannot stack a fleet of LPs and QPs together)."""
    problems = [generate_pagerank_lp(60, seed=1), svm_lp(),
                generate_pagerank_lp(90, seed=2)]
    if qp:
        problems = [with_q(p, w) for p, w in zip(problems, (0.1, 0.01, 1.0))]
    return problems


HETERO_STEPS = {
    "adaptive": lambda: (fleet_pdhg_params(
        terminate_on_iteration_limit(1000)), False),
    "constant": lambda: (constant_steps(fleet_pdhg_params(
        terminate_on_iteration_limit(1000))), False),
    "qp": lambda: (fleet_pdhg_params(terminate_on_iteration_limit(1000)),
                   True),
}


@pytest.mark.parametrize("case", sorted(HETERO_STEPS))
def test_hetero_ingest_matches_jax(case, monkeypatch):
    """prepare_batch's initial lane state (step sizes, primal weights,
    KKT passes: the power method's iterations for constant steps) and
    scaled bundle (vectors, rescaling, per-lane equality rows) against
    the JAX package's solve_batch ingest, at rtol 1e-12."""
    params, qp = HETERO_STEPS[case]()
    problems = hetero_problems(qp)
    jbundle, jstate, _ = jax_hetero_start(params, problems, monkeypatch)
    fleet = batch.prepare_batch(port_params(params),
                                [port_problem(p) for p in problems],
                                device="cpu")
    compare_leaves(fleet.initial_state, minor_leaves(jstate), rtol=1e-12)
    tb, jb = fleet.bundle.scaled, jbundle.scaled
    for field in ("objective_vector", "right_hand_side",
                  "variable_lower_bound", "variable_upper_bound"):
        np.testing.assert_allclose(getattr(tb, field).numpy(),
                                   np.asarray(getattr(jb, field)).T,
                                   rtol=1e-12, err_msg=field)
    np.testing.assert_array_equal(tb.is_equality.numpy(),
                                  np.asarray(jb.is_equality).T)
    for field in ("constraint_rescaling", "variable_rescaling"):
        np.testing.assert_allclose(
            getattr(fleet.bundle, field).numpy(),
            np.asarray(getattr(jbundle, field)).T, rtol=1e-12,
            err_msg=field)
    assert fleet.lane_shapes == [(p.num_constraints, p.num_variables)
                                 for p in problems]
    assert (tb.objective_matrix is not None) == qp


def minor_leaves(jstate):
    return {k: np.moveaxis(v, 0, -1) for k, v in state_leaves(jstate).items()}


def compare_leaves(got, want, rtol):
    got = state_leaves_of_port(got)
    for key, value in want.items():
        if np.issubdtype(value.dtype, np.floating):
            assert_close_normwise(got[key], value,
                                  STEP_TOLERANCE.get(key, rtol), key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def hetero_mid_solve(case, monkeypatch, start=50):
    params, qp = HETERO_STEPS[case]()
    problems = hetero_problems(qp)
    bundle, state, config = jax_hetero_start(params, problems, monkeypatch)
    while int(np.min(np.asarray(state.iteration))) < start:
        state, _ = jx_batch._run_segment_batched(
            bundle, state, jnp.asarray(0.0, jnp.float64), config)
    tparams = port_params(params)
    tfleet = batch.prepare_batch(tparams, [port_problem(p) for p in problems],
                                 device="cpu")
    return params, bundle, state, config, tparams, tfleet


@pytest.mark.parametrize("case", sorted(HETERO_STEPS))
def test_hetero_step_from_jax_state(case, monkeypatch):
    """One trial in every lane against the JAX package's vmapped
    _take_step (rtol 1e-12; the step size at 1e-6); a lane that is not
    active stays bitwise as it was; padded rows and columns stay zero."""
    monkeypatch.setattr(batch, "_pdhg_step_size_factors", xla_pdhg_factors)
    params, jbundle, jstate, _, tparams, tfleet = hetero_mid_solve(
        case, monkeypatch)
    policy = params.step_size_policy_params
    want = jax.vmap(lambda b, s: jx_pdhg._take_step(b.scaled, s, policy))(
        jbundle, jstate)
    tstate = convert.fleet_state_from_leading_arrays(state_leaves(jstate))
    compare_leaves(tstate, minor_leaves(jstate), rtol=0.0)

    def step(active):
        if case == "constant":
            return batch.pdhg_lane_step_constant(tfleet.bundle.scaled,
                                                 tstate, active)
        return batch.pdhg_lane_step(tfleet.bundle.scaled, tstate, active,
                                    tparams.step_size_policy_params)

    got = step(torch.ones(3, dtype=torch.bool))
    compare_leaves(got, minor_leaves(want), rtol=1e-12)
    # the SVM lane (38 x 38) is padded to 91 x 90: its padding is zero
    assert not got.current_primal_solution[38:, 1].any()
    assert not got.current_dual_solution[38:, 1].any()
    held = step(torch.tensor([True, False, True]))
    before, after = state_leaves_of_port(tstate), state_leaves_of_port(held)
    for key in before:
        np.testing.assert_array_equal(after[key][..., 1],
                                      before[key][..., 1], err_msg=key)


@pytest.mark.parametrize("case", sorted(HETERO_STEPS))
def test_hetero_segment_from_jax_state(case, monkeypatch):
    """One evaluation and the trials to the next against the JAX
    package's _run_segment_batched: iterates at rtol 1e-10, counters
    (KKT passes included) exactly, the evaluation's reasons, restart
    choices and convergence information."""
    monkeypatch.setattr(batch, "_pdhg_step_size_factors", xla_pdhg_factors)
    _, jbundle, jstate, config, tparams, tfleet = hetero_mid_solve(
        case, monkeypatch)
    want, jres = jx_batch._run_segment_batched(
        jbundle, jstate, jnp.asarray(0.0, jnp.float64), config)
    tstate = convert.fleet_state_from_leading_arrays(state_leaves(jstate))
    got, tres, counts = batch.run_segment(tfleet.bundle, tstate, 0.0,
                                          batch._config(tparams))
    assert counts.running and counts.trials >= 30
    compare_leaves(got, minor_leaves(want), rtol=1e-10)
    np.testing.assert_array_equal(tres.restart_used.numpy(),
                                  np.asarray(jres.restart_used))
    np.testing.assert_array_equal(tres.termination_reason.numpy(),
                                  np.asarray(jres.termination_reason))
    for field in jres.conv._fields:
        np.testing.assert_allclose(
            getattr(tres.conv, field).numpy(),
            np.asarray(getattr(jres.conv, field)), rtol=1e-10, atol=1e-13,
            err_msg=field)


# ---------------------------------------------------------------------------
# Whole heterogeneous fleets, against the JAX package's solve_batch
# ---------------------------------------------------------------------------


def l1_svm_fleet():
    data = random_svm_data(n_samples=30, n_features=8, density=0.4, seed=1)
    return [generate_l1_svm_lp(data, regularizer_weight=w)
            for w in (0.1, 1.0, 4.0)]


def mixed_pagerank():
    return [generate_pagerank_lp(nodes, seed=10 + i)
            for i, nodes in enumerate((120, 190, 260, 150, 220, 300))]


def rescaled(criteria):
    return pdhg_params(criteria, ruiz_iterations=10, pock_chambolle_alpha=1.0)


# tests/test_batch.py's fleets: (parameters, problems, atol of the
# solutions; None: the objective at rtol 1e-6, the optima not being
# unique)
HETERO_FLEETS = {
    "lp_and_cc_lp": (lambda: pdhg_params(optimality_criteria(1e-9)),
                     lambda: [fixtures.example_lp(), fixtures.example_cc_lp()],
                     1e-6),
    "lp_and_infeasible": (
        lambda: pdhg_params(optimality_criteria(1e-8)),
        lambda: [fixtures.example_lp(),
                 fixtures.example_lp_easy_primal_infeasible()], 1e-6),
    "qps": (lambda: pdhg_params(optimality_criteria(1e-9)),
            lambda: [fixtures.example_qp(), fixtures.example_qp2()], 1e-7),
    "l1_svm": (lambda: rescaled(optimality_criteria(1e-6)), l1_svm_fleet,
               None),
    "mixed_pagerank": (lambda: rescaled(optimality_criteria(1e-6)),
                       mixed_pagerank, 1e-5),
}


@pytest.mark.parametrize("case", sorted(HETERO_FLEETS))
def test_solve_batch_matches_jax(case):
    make_params, make_problems, atol = HETERO_FLEETS[case]
    params, problems = make_params(), make_problems()
    want = jx_batch.solve_batch(params, problems)
    stats = batch.FleetRunStats()
    got = batch.solve_batch(port_params(params),
                            [port_problem(p) for p in problems],
                            device="cpu", run_stats=stats)
    print(case, "iterations port", [o.iteration_count for o in got],
          "jax", [o.iteration_count for o in want])
    assert len(got) == len(want) == len(problems)
    assert stats.dispatches >= 1 and stats.trials > 0
    for problem, w, g in zip(problems, want, got):
        assert g.termination_reason.name == w.termination_reason.name
        assert g.primal_solution.shape == (problem.num_variables,)
        assert g.dual_solution.shape == (problem.num_constraints,)
        stats_g, stats_w = g.iteration_stats[-1], w.iteration_stats[-1]
        assert (stats_g.convergence_information[0].candidate_type.name
                == stats_w.convergence_information[0].candidate_type.name
                == "POINT_TYPE_AVERAGE_ITERATE")
        assert stats_g.restart_used.name == stats_w.restart_used.name == (
            "RESTART_CHOICE_UNSPECIFIED")
        if atol is None:
            np.testing.assert_allclose(
                stats_g.convergence_information[0].primal_objective,
                stats_w.convergence_information[0].primal_objective,
                rtol=1e-6)
            continue
        assert stats_g.iteration_number == stats_w.iteration_number
        if g.termination_reason.name == OPTIMAL:
            np.testing.assert_allclose(g.primal_solution, w.primal_solution,
                                       atol=atol)
            np.testing.assert_allclose(g.dual_solution, w.dual_solution,
                                       atol=atol)


def test_solve_batch_checkpoint_resumes(tmp_path):
    """A heterogeneous fleet stopped by an iteration limit with a
    checkpoint resumes to the reasons and solutions of an uninterrupted
    run (the loop and the checkpoint are the shared-pattern fleet's)."""
    params = port_params(rescaled(optimality_criteria(1e-7)))
    problems = [port_problem(p) for p in mixed_pagerank()[:3]]
    full = batch.solve_batch(params, problems, device="cpu")
    path = str(tmp_path / "fleet.npz")
    first = dataclasses.replace(
        params, checkpoint_path=path,
        termination_criteria=dataclasses.replace(
            params.termination_criteria, iteration_limit=80))
    cut = batch.solve_batch(first, problems, device="cpu")
    assert {o.termination_reason.name for o in cut} == {
        "TERMINATION_REASON_ITERATION_LIMIT"}
    resumed = batch.solve_batch(
        dataclasses.replace(params, resume_from_checkpoint=path), problems,
        device="cpu")
    for a, b in zip(resumed, full):
        assert a.termination_reason.name == b.termination_reason.name == (
            OPTIMAL)
        np.testing.assert_allclose(a.primal_solution, b.primal_solution,
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# C4: the bound-width step is applied
# ---------------------------------------------------------------------------


def bound_width_fleet():
    """example_lp with its bounds stretched over four decades, so the
    bound-width step moves the iterates."""
    problems = []
    for stretch in (1.0, 10.0, 1e4):
        p = fixtures.example_lp()
        problems.append(dataclasses.replace(
            p, variable_upper_bound=p.variable_upper_bound * stretch))
    return problems


@pytest.mark.parametrize("entry", ["shared_pattern", "solve_batch"])
def test_bound_width_fleet_matches_single_solves(entry):
    """Each lane against the JAX package's optimize with
    bound_width_rescaling=True (the same reason, solutions within 1e-6),
    and the lanes' KKT passes against the port's own optimize with the
    flag: the fleet applies the step that the JAX package's fleets drop
    (C4)."""
    params = dataclasses.replace(pdhg_params(optimality_criteria(1e-8)),
                                 bound_width_rescaling=True)
    problems = bound_width_fleet()
    tparams = port_params(params)
    tproblems = [port_problem(p) for p in problems]
    solve = (batch.solve_batch if entry == "solve_batch"
             else batch.solve_batch_shared_pattern)
    got = solve(tparams, tproblems, device="cpu")
    for problem, tproblem, out in zip(problems, tproblems, got):
        want = jx.optimize(params, problem)
        assert out.termination_reason.name == want.termination_reason.name
        assert out.termination_reason.name == OPTIMAL
        np.testing.assert_allclose(out.primal_solution, want.primal_solution,
                                   atol=1e-6)
        np.testing.assert_allclose(out.dual_solution, want.dual_solution,
                                   atol=1e-6)
        single = tx.optimize(tparams, tproblem, device="cpu")
        assert out.iteration_count == single.iteration_count
        assert out.iteration_stats[-1].cumulative_kkt_matrix_passes == (
            pytest.approx(single.iteration_stats[-1]
                          .cumulative_kkt_matrix_passes))


# ---------------------------------------------------------------------------
# Errors and the device rule
# ---------------------------------------------------------------------------


def test_solve_batch_refuses_what_the_reference_refuses():
    problems = [port_problem(fixtures.example_lp())]
    mp = to_port(mp_params(optimality_criteria(1e-6)))
    with pytest.raises(ValueError, match="PDHG"):
        batch.solve_batch(mp, problems, device="cpu")
    mpock = dataclasses.replace(
        port_params(pdhg_params(optimality_criteria(1e-6))),
        step_size_policy_params=tx.MalitskyPockStepsizeParameters(
            downscaling_factor=0.7, breaking_factor=1.0,
            interpolation_coefficient=1.0))
    with pytest.raises(ValueError, match="adaptive or constant"):
        batch.solve_batch(mpock, problems, device="cpu")
    assert batch.solve_batch(mpock, [], device="cpu") == []


def test_slow_ingest_refuses_mixed_shapes_and_patterns():
    params = port_params(constant_steps(fleet_pdhg_params(
        optimality_criteria(1e-6))))
    shapes = [port_problem(generate_pagerank_lp(n, seed=0)) for n in (40, 50)]
    with pytest.raises(ValueError, match="identical problem shapes"):
        batch.prepare_shared_pattern_fleet(params, shapes, device="cpu")
    patterns = [port_problem(generate_pagerank_lp(40, seed=s))
                for s in (0, 1)]
    with pytest.raises(ValueError, match="identical index structure"):
        batch.prepare_shared_pattern_fleet(params, patterns, device="cpu")
    base = generate_pagerank_lp(40, seed=0)
    q_patterns = [port_problem(with_q(base, 1.0)),
                  port_problem(dataclasses.replace(
                      base, objective_matrix=sp.csc_matrix(
                          sp.diags(np.r_[1.0, np.zeros(39)]))))]
    with pytest.raises(ValueError, match="identical index structure"):
        batch.prepare_shared_pattern_fleet(
            port_params(fleet_pdhg_params(optimality_criteria(1e-6))),
            q_patterns, device="cpu")


def test_solve_batch_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = port_params(pdhg_params(optimality_criteria(1e-6)))
    problems = [port_problem(fixtures.example_lp()),
                port_problem(fixtures.example_qp())]
    for call in (batch.prepare_batch, batch.solve_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(params, problems)
    fleet = batch.prepare_batch(params, problems, device="cpu")
    assert fleet.device == CPU and fleet.lane_shapes == [(3, 4), (1, 2)]
    assert fleet.bundle.scaled.constraint_matrix.a.vals.device == CPU
    assert fleet.bundle.scaled.is_equality.shape == (3, 2)
    out = batch.solve_batch(params, problems, fleet=fleet)
    assert [o.termination_reason.name for o in out] == [OPTIMAL] * 2
