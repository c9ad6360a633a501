"""The shared-pattern fleet (firstorderlp_torch.batch) against the JAX
package's, on the CPU, in f64.

- Ingest: the on-device rescaling against the JAX package's
  _device_fleet_build (rtol 1e-12: scaled values, cumulative scalings,
  scaled vectors, step sizes, norms) and the initial lane states
  against its prepared fleet (PDHG, Mirror Prox l1 / l2 / off).
- One lane step and one segment from a JAX batched state
  (convert.fleet_state_from_arrays) against the JAX package's vmapped
  _take_step and _run_segment_shared, PDHG (adaptive and constant
  steps, LP and QP) and Mirror Prox (LP and QP): iterates at rtol 1e-10
  (the step size and the step-weighted sums at 1e-6, as in the
  single-instance segment tests), counters exact, and a lane that had
  already terminated bitwise unchanged.
- Whole fleets against the JAX package's solve_batch_shared_pattern
  (both ingests: constant steps and QPs take the per-instance one): the
  same reasons and iteration counts, solutions within atol 1e-6
  (objectives at rtol 1e-6 for the L1-SVM path, whose optima are not
  unique); and each lane against the port's own single-instance
  optimize.
- Errors (a FleetSpec's refusals among them), checkpoint/resume (both
  ingests, and across packages), the device rule.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_tpu import batch as jx_batch
from firstorderlp_tpu import checkpoint as jx_ckpt
from firstorderlp_tpu.generators import (
    generate_l1_svm_lp,
    generate_pagerank_lp,
    generate_pagerank_lp_fleet,
    pagerank_fleet_spec as jx_fleet_spec,
    random_svm_data,
)
from firstorderlp_tpu.models import mirror_prox as jx_mp
from firstorderlp_tpu.models import pdhg as jx_pdhg
from firstorderlp_tpu.models.common import HashableCriteria

import firstorderlp_torch as tx
from firstorderlp_torch import batch, convert
from firstorderlp_torch.generators import pagerank_fleet_spec
from firstorderlp_torch.ops import lanes

from test_mirror_prox import mp_params
from test_torch_mirror_prox import port_mp_params
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
DAMPING = [0.85, 0.9, 0.99]


def canonical(matrix):
    csr = sp.csr_matrix(matrix, dtype=np.float64)
    csr.sum_duplicates()
    csr.sort_indices()
    return csr


def pagerank_fleet(nodes=120):
    return generate_pagerank_lp_fleet(nodes, DAMPING, seed=3)


def fleet_pdhg_params(criteria):
    return dataclasses.replace(
        pdhg_params(criteria, ruiz_iterations=10, pock_chambolle_alpha=1.0),
        matrix_format="ell",
    )


def fleet_mp_params(criteria, scaling):
    return mp_params(criteria, diagonal_scaling=scaling, ruiz_iterations=10,
                     pock_chambolle_alpha=1.0)


def constant_steps(params):
    return dataclasses.replace(
        params, step_size_policy_params=jx_pdhg.ConstantStepsizeParams())


def qp_fleet(nodes=120):
    """pagerank_fleet with an objective matrix lambda I per lane (a
    Tikhonov path over the damping sweep)."""
    return [dataclasses.replace(p, objective_matrix=sp.csc_matrix(
        w * sp.eye(p.constraint_matrix.shape[1])))
        for p, w in zip(pagerank_fleet(nodes), (0.01, 0.1, 1.0))]


def to_port(params):
    return (port_mp_params(params)
            if isinstance(params, jx_mp.MirrorProxParameters)
            else port_params(params))


def port_fleet(params, problems):
    return batch.prepare_shared_pattern_fleet(
        to_port(params), [port_problem(p) for p in problems], device="cpu")


# ---------------------------------------------------------------------------
# Ingest
# ---------------------------------------------------------------------------

RESCALINGS = {
    "ruiz10_pc1": (10, False, 1.0),
    "ruiz3_l2": (3, True, None),
    "l2_pc1.5": (0, True, 1.5),
}


@pytest.mark.parametrize("case", sorted(RESCALINGS))
def test_rescaling_matches_device_fleet_build(case):
    ruiz, l2, alpha = RESCALINGS[case]
    problems = pagerank_fleet(80)
    pat = canonical(problems[0].constraint_matrix)
    m, n = pat.shape
    v_orig = np.stack([canonical(p.constraint_matrix).data
                       for p in problems], axis=1)
    vectors = {
        key: np.stack([np.asarray(getattr(p, attr), np.float64)
                       for p in problems], axis=1)
        for key, attr in (("c", "objective_vector"), ("b", "right_hand_side"),
                          ("lo", "variable_lower_bound"),
                          ("hi", "variable_upper_bound"))
    }
    id_op = jx_batch._ell_value_positions(pat)
    id_planes = {
        half: [np.asarray(bk.vals).astype(np.int32).reshape(-1)
               for bk in getattr(id_op, half).buckets]
        for half in ("fwd", "bwd")
    }
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(pat.indptr))
    (planes, _, scaled_vectors, cum_con, cum_var, step, norm_c,
     norm_b) = jx_batch._device_fleet_build(
        jnp.asarray(v_orig), rows, pat.indices.astype(np.int32),
        {k: jnp.asarray(v) for k, v in vectors.items()}, id_planes, m, n,
        ruiz, l2, alpha,
    )
    # the scaled values back in csr entry order from the ELL planes
    v_want = np.zeros_like(v_orig)
    for ids, plane in zip(id_planes["fwd"], planes["fwd"]):
        keep = ids > 0
        v_want[ids[keep] - 1] = np.asarray(plane)[keep]

    pattern = lanes.build_lanes_pattern(pat, CPU)
    got = batch.fleet_rescale(
        pattern, torch.as_tensor(v_orig),
        {k: torch.as_tensor(v) for k, v in vectors.items()}, ruiz, l2, alpha,
    )

    def close(a, b, name):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=0, err_msg=name)

    close(got.v.numpy(), v_want, "scaled values")
    close(got.cum_con.numpy(), cum_con, "constraint rescaling")
    close(got.cum_var.numpy(), cum_var, "variable rescaling")
    for key in ("c", "b", "lo", "hi"):
        close(got.vectors[key].numpy(), scaled_vectors[key], key)
    close(got.step_size.numpy(), step, "step size")
    close(got.norm_c.numpy(), norm_c, "norm c")
    close(got.norm_b.numpy(), norm_b, "norm b")


INITIAL_STATES = {
    "pdhg": lambda: fleet_pdhg_params(optimality_criteria(1e-6)),
    "mp_l1": lambda: fleet_mp_params(optimality_criteria(1e-6), "l1"),
    "mp_l2": lambda: fleet_mp_params(optimality_criteria(1e-6), "l2"),
    "mp_off": lambda: fleet_mp_params(optimality_criteria(1e-6), "off"),
}


@pytest.mark.parametrize("case", sorted(INITIAL_STATES))
def test_initial_lane_state_matches_jax(case):
    params = INITIAL_STATES[case]()
    problems = pagerank_fleet(80)
    want = state_leaves(
        jx_batch.prepare_shared_pattern_fleet(params, problems).initial_state)
    got = dict(
        (key.replace("/", "."), value) for key, value in
        __import__("firstorderlp_torch.checkpoint", fromlist=["_leaves"])
        ._leaves(port_fleet(params, problems).initial_state)
    )
    assert set(got) == set(want)
    for key, value in want.items():
        mine = got[key].numpy()
        assert mine.shape == value.shape, key
        if np.issubdtype(value.dtype, np.floating):
            np.testing.assert_allclose(mine, value, rtol=1e-12, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(mine, value, err_msg=key)


def test_fleet_spec_lanes_match_the_stacked_fleet():
    """pagerank_fleet_spec generates each lane's values and rhs (in f32,
    as the JAX package's spec does) within f32 rounding of the problem
    list's, and the same rhs as the JAX package's generators."""
    damping = [0.7, 0.85, 0.95]
    spec = pagerank_fleet_spec(100, damping, seed=1)
    problems = generate_pagerank_lp_fleet(100, damping, seed=1)
    v, vectors, const = batch._spec_lanes(
        spec, torch.float64, CPU, (101, 100, spec.base_problem
                                   .constraint_matrix.nnz))
    want_v = np.stack([canonical(p.constraint_matrix).data
                       for p in problems], axis=1)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-6, atol=1e-7)
    want_b = np.stack([p.right_hand_side for p in problems], axis=1)
    np.testing.assert_allclose(vectors["b"].numpy(), want_b, rtol=1e-6)
    jspec = jx_fleet_spec(100, damping, seed=1)
    jb = np.asarray(jax.vmap(jspec.right_hand_side)(
        jnp.asarray(damping))).T
    np.testing.assert_allclose(vectors["b"].numpy(), jb, rtol=1e-7)
    np.testing.assert_array_equal(vectors["c"].numpy(), 0.0)
    assert const.shape == (3,) and not const.any()


@pytest.mark.parametrize("damping", [[0.5, 0.0], []])
def test_fleet_spec_rejects_damping_zero_and_empty(damping):
    with pytest.raises(ValueError):
        pagerank_fleet_spec(50, damping)


# ---------------------------------------------------------------------------
# One step and one segment from a JAX batched state
# ---------------------------------------------------------------------------


def xla_pdhg_factors(total, policy, dtype):
    """The lane step-size factors with XLA's pow, as the JAX package
    computes them (numpy's or PyTorch's f64 pow can differ in the last
    bit, and the adaptive step amplifies such a bit)."""
    t = jnp.asarray(total.numpy(), jnp.float64) + 1.0
    return (torch.as_tensor(np.array(1 - t ** (-policy.reduction_exponent))),
            torch.as_tensor(np.array(1 + t ** (-policy.growth_exponent))))


def xla_mp_factors(iteration, dtype):
    it = jnp.asarray(iteration.numpy(), jnp.float64) + 1.0
    return (torch.as_tensor(np.array(1 - it ** (-0.3))),
            torch.as_tensor(np.array(1 + it ** (-0.6))))


def jax_config(params):
    criteria = HashableCriteria.from_criteria(params.termination_criteria)
    if isinstance(params, jx_mp.MirrorProxParameters):
        return jx_mp._MpConfig(
            criteria=criteria, restart_params=params.restart_params,
            termination_evaluation_frequency=(
                params.termination_evaluation_frequency),
            need_bound_estimates=True,
        )
    return jx_pdhg._PdhgConfig(
        criteria=criteria, restart_params=params.restart_params,
        step_policy=params.step_size_policy_params,
        termination_evaluation_frequency=(
            params.termination_evaluation_frequency),
        need_bound_estimates=True,
    )


# solver: (parameters, fleet); constant steps and QPs take the
# per-instance ingest
SOLVERS = {
    "pdhg": (lambda: fleet_pdhg_params(terminate_on_iteration_limit(1000)),
             pagerank_fleet),
    "pdhg_constant": (lambda: constant_steps(fleet_pdhg_params(
        terminate_on_iteration_limit(1000))), pagerank_fleet),
    "pdhg_qp": (lambda: fleet_pdhg_params(terminate_on_iteration_limit(1000)),
                qp_fleet),
    "mirror_prox": (lambda: fleet_mp_params(
        terminate_on_iteration_limit(1000), "l2"), pagerank_fleet),
    "mirror_prox_qp": (lambda: fleet_mp_params(
        terminate_on_iteration_limit(1000), "l2"), qp_fleet),
}


def is_mp_solver(solver):
    return solver.startswith("mirror_prox")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("solver", ["mirror_prox", "pdhg"])
def test_step_size_factors_match_the_jax_formulas(solver, dtype):
    """The port's own step-size factors (the one-step and one-segment
    tests above swap in XLA's pow) against the JAX package's formulas
    (pdhg.py:387-390 and mirror_prox.py:205-206 there) in the working
    precision, at counts 0 to 10^6: within 2 units in the last place of
    1.0, the factors lying in [0, 2]."""
    counts = np.unique(np.concatenate([
        np.arange(0, 2000), np.geomspace(1, 1e6, 500).astype(np.int64)]))
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    if solver == "pdhg":
        policy = port_params(fleet_pdhg_params(
            optimality_criteria(1e-8))).step_size_policy_params
        got = batch._pdhg_step_size_factors(torch.as_tensor(counts), policy,
                                            t_dtype)
        t = jnp.asarray(counts).astype(j_dtype)
        want = (1 - (t + 1.0) ** (-policy.reduction_exponent),
                1 + (t + 1.0) ** (-policy.growth_exponent))
    else:
        got = batch._mp_step_size_factors(torch.as_tensor(counts), t_dtype)
        it = jnp.asarray(counts).astype(j_dtype)
        want = (1 - (it + 1.0) ** (-0.3), 1 + (it + 1.0) ** (-0.6))
    ulp = 2 * np.finfo(dtype).eps
    for g, w in zip(got, want):
        assert g.dtype == t_dtype
        w = np.asarray(w, dtype=dtype)
        assert w.dtype == np.dtype(dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ulp)


def mid_solve(solver, start):
    """The JAX fleet run to iteration `start` or later, and both
    packages' fleets and configs."""
    make_params, make_problems = SOLVERS[solver]
    params, problems = make_params(), make_problems()
    jfleet = jx_batch.prepare_shared_pattern_fleet(params, problems)
    config = jax_config(params)
    state = jfleet.initial_state
    while int(np.min(np.asarray(state.iteration))) < start:
        state, _ = jx_batch._run_segment_shared(
            jfleet.batched_bundle, state, jnp.asarray(0.0, jnp.float64),
            config, jfleet.axes_box)
    tparams = to_port(params)
    tfleet = port_fleet(params, problems)
    return params, jfleet, config, state, tparams, tfleet


def to_state(solver, jstate):
    convert_fn = (convert.mp_fleet_state_from_arrays
                  if is_mp_solver(solver)
                  else convert.fleet_state_from_arrays)
    return convert_fn(state_leaves(jstate), device="cpu")


# The step size, the step-weighted sums and the last step's difference
# of iterates (a difference of two iterates held at 1e-10 of their own
# scale, which cancels three to four digits) at 1e-6; the rest at rtol.
STEP_TOLERANCE = {"step_size": 1e-6, "avg.sum_primal_solutions": 1e-6,
                  "avg.sum_dual_solutions": 1e-6,
                  "avg.sum_primal_solution_weights": 1e-6,
                  "avg.sum_dual_solution_weights": 1e-6,
                  "delta_primal": 1e-6, "delta_dual": 1e-6,
                  # A'y: each entry a sum of terms far larger than itself
                  "current_dual_product": 1e-8}


def compare_states(got, want, rtol=1e-10, skip=()):
    got = state_leaves_of_port(got)
    for key, value in state_leaves(want).items():
        if key in skip:
            continue
        mine = got[key]
        if np.issubdtype(value.dtype, np.floating):
            assert_close_normwise(mine, value, STEP_TOLERANCE.get(key, rtol),
                                  key)
        else:
            np.testing.assert_array_equal(mine, value, err_msg=key)


def state_leaves_of_port(state, prefix=""):
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(state_leaves_of_port(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v.numpy()
    return out


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_one_lane_step_from_jax_state(solver, monkeypatch):
    monkeypatch.setattr(batch, "_pdhg_step_size_factors", xla_pdhg_factors)
    monkeypatch.setattr(batch, "_mp_step_size_factors", xla_mp_factors)
    params, jfleet, _, jstate, tparams, tfleet = mid_solve(solver, 50)
    bundle_axes, state_axes = jfleet.axes_box.trees()
    if is_mp_solver(solver):
        def step(b, s):
            s = jx_mp._take_step(b.scaled, s)
            return dataclasses.replace(s, iteration=s.iteration + 1)
    else:
        def step(b, s):
            return jx_pdhg._take_step(b.scaled, s,
                                      params.step_size_policy_params)
    want = jax.vmap(step, in_axes=(bundle_axes, state_axes),
                    out_axes=state_axes)(jfleet.batched_bundle, jstate)
    tstate = to_state(solver, jstate)

    def port_step(active):
        scaled = tfleet.bundle.scaled
        if is_mp_solver(solver):
            return batch.mp_lane_step(scaled, tstate, active)
        if solver == "pdhg_constant":
            return batch.pdhg_lane_step_constant(scaled, tstate, active)
        return batch.pdhg_lane_step(scaled, tstate, active,
                                    tparams.step_size_policy_params)

    got = port_step(torch.ones(len(DAMPING), dtype=torch.bool))
    compare_states(got, want, rtol=1e-12)
    # an inactive lane does not move at all
    held = port_step(torch.tensor([True, False, True]))
    before, after = (state_leaves_of_port(tstate),
                     state_leaves_of_port(held))
    for key in before:
        np.testing.assert_array_equal(after[key][..., 1],
                                      before[key][..., 1], err_msg=key)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_one_segment_from_jax_state(solver, monkeypatch):
    """Lane 1 had terminated (OPTIMAL) before the segment: both packages
    leave it as it was, bitwise; the other lanes agree with the JAX
    package's segment, counters exactly."""
    monkeypatch.setattr(batch, "_pdhg_step_size_factors", xla_pdhg_factors)
    monkeypatch.setattr(batch, "_mp_step_size_factors", xla_mp_factors)
    params, jfleet, config, jstate, tparams, tfleet = mid_solve(solver, 50)
    reasons = np.asarray(jstate.termination_reason).copy()
    reasons[1] = 1
    jstate = dataclasses.replace(jstate,
                                 termination_reason=jnp.asarray(reasons))
    tstate = to_state(solver, jstate)
    want, jres = jx_batch._run_segment_shared(
        jfleet.batched_bundle, jstate, jnp.asarray(0.0, jnp.float64), config,
        jfleet.axes_box)
    got, tres, counts = batch.run_segment(tfleet.bundle, tstate, 0.0,
                                          batch._config(tparams))
    assert counts.running and counts.trials >= 30
    start = int(np.asarray(jstate.iteration)[0])
    assert np.all(np.asarray(want.iteration)[[0, 2]] >= start + 30)
    compare_states(got, want)
    np.testing.assert_array_equal(tres.restart_used.numpy(),
                                  np.asarray(jres.restart_used))
    np.testing.assert_array_equal(tres.termination_reason.numpy(),
                                  np.asarray(jres.termination_reason))
    for field in jres.conv._fields:
        np.testing.assert_allclose(
            getattr(tres.conv, field).numpy(),
            np.asarray(getattr(jres.conv, field)), rtol=1e-10, atol=1e-13,
            err_msg=field)
    before, after = (state_leaves_of_port(tstate),
                     state_leaves_of_port(got))
    jbefore = state_leaves(jstate)
    jafter = state_leaves(want)
    for key in before:
        np.testing.assert_array_equal(after[key][..., 1],
                                      before[key][..., 1], err_msg=key)
        np.testing.assert_array_equal(jafter[key][..., 1],
                                      jbefore[key][..., 1], err_msg=key)


def test_next_evaluation_iteration():
    config = batch._config(port_params(fleet_pdhg_params(
        terminate_on_iteration_limit(100))))
    cases = {1: 2, 9: 10, 10: 41, 11: 41, 40: 41, 41: 81, 80: 81, 81: 101,
             100: 101, 101: 121}
    for iteration, want in cases.items():
        assert batch.next_eval_iteration(iteration, config) == want
        evals = batch._is_eval_iteration(
            torch.arange(iteration + 1, want + 1), config).numpy()
        assert evals[-1] and not evals[:-1].any()


# ---------------------------------------------------------------------------
# Whole fleets
# ---------------------------------------------------------------------------


def svm_fleet():
    data = random_svm_data(n_samples=24, n_features=6, density=0.5, seed=2)
    return [generate_l1_svm_lp(data, regularizer_weight=w)
            for w in (0.1, 1.0, 4.0)]


FLEETS = {
    "pdhg_pagerank": (lambda: fleet_pdhg_params(optimality_criteria(1e-8)),
                      pagerank_fleet),
    "pdhg_constant": (lambda: constant_steps(fleet_pdhg_params(
        optimality_criteria(1e-8))), pagerank_fleet),
    "pdhg_qp": (lambda: fleet_pdhg_params(optimality_criteria(1e-8)),
                qp_fleet),
    "mp_l2_qp": (lambda: fleet_mp_params(optimality_criteria(1e-6), "l2"),
                 qp_fleet),
    "pdhg_l1_svm_path": (
        lambda: fleet_pdhg_params(optimality_criteria(1e-7)), svm_fleet),
    "mp_l2": (lambda: fleet_mp_params(optimality_criteria(1e-6), "l2"),
              pagerank_fleet),
    "mp_off": (lambda: fleet_mp_params(optimality_criteria(1e-6), "off"),
               pagerank_fleet),
}

# The L1-SVM LPs' optimal sets are not points: the two packages' f64
# trajectories, equal in iteration counts, drift apart along the optimal
# face (up to 4e-5 over 3,960 iterations, and a few step trials of some
# 4,200 KKT passes accepted in one and rejected in the other), so there
# the objective is held at rtol 1e-6 instead of the solutions and the
# KKT passes.
NON_UNIQUE = {"pdhg_l1_svm_path"}
# The QP fleet's f64 step sizes drift apart from the JAX package's by
# about 1e-10 (relative) by iteration 121, as the LP fleets' do (see
# STEP_TOLERANCE); at 1e-8 one borderline trial of some 320 is rejected
# in one package and accepted in the other, so there the KKT passes are
# held within one trial (iterations and solutions as for the others).
KKT_TRIALS_APART = {"pdhg_qp": 1.0}

_solved = {}


def solved(case):
    """(problems, JAX outputs, port outputs) of a FLEETS case, solved
    once per test process."""
    if case not in _solved:
        make_params, make_problems = FLEETS[case]
        params = make_params()
        criteria = params.termination_criteria
        params = dataclasses.replace(
            params, termination_criteria=dataclasses.replace(
                criteria, iteration_limit=5000))
        problems = make_problems()
        want = jx_batch.solve_batch_shared_pattern(params, problems)
        got = batch.solve_batch_shared_pattern(
            to_port(params), [port_problem(p) for p in problems],
            device="cpu")
        _solved[case] = (params, problems, want, got)
    return _solved[case]


def assert_same_solution(case, got, want):
    if case in NON_UNIQUE:
        np.testing.assert_allclose(
            got.iteration_stats[-1].convergence_information[0]
            .primal_objective,
            want.iteration_stats[-1].convergence_information[0]
            .primal_objective, rtol=1e-6)
        return
    np.testing.assert_allclose(got.primal_solution, want.primal_solution,
                               atol=1e-6)
    np.testing.assert_allclose(got.dual_solution, want.dual_solution,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_matches_jax(case):
    _, _, want, got = solved(case)
    print(case, "iterations port", [o.iteration_count for o in got],
          "jax", [o.iteration_count for o in want])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.termination_reason.name == w.termination_reason.name
        assert g.termination_reason.name == OPTIMAL
        assert_same_solution(case, g, w)
        gs, ws = g.iteration_stats[-1], w.iteration_stats[-1]
        assert gs.iteration_number == ws.iteration_number
        if case not in NON_UNIQUE:
            assert gs.cumulative_kkt_matrix_passes == pytest.approx(
                ws.cumulative_kkt_matrix_passes,
                abs=KKT_TRIALS_APART.get(case, 0.0))


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_fleet_lanes_match_single_solves(case):
    params, problems, _, got = solved(case)
    tparams = to_port(params)
    for problem, out in zip(problems, got):
        single = tx.optimize(tparams, port_problem(problem), device="cpu")
        assert single.termination_reason == out.termination_reason
        assert_same_solution(case, out, single)


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_fleet_spec_matches_jax(solver):
    damping = [0.7, 0.9]
    if solver == "pdhg":
        params = fleet_pdhg_params(optimality_criteria(1e-8))
    else:
        params = fleet_mp_params(optimality_criteria(1e-7), "l2")
    want = jx_batch.solve_batch_shared_pattern(
        params, jx_fleet_spec(200, damping, seed=2))
    got = batch.solve_batch_shared_pattern(
        to_port(params), pagerank_fleet_spec(200, damping, seed=2),
        device="cpu")
    print(solver, "iterations port", [o.iteration_count for o in got],
          "jax", [o.iteration_count for o in want])
    for w, g in zip(want, got):
        assert g.termination_reason.name == w.termination_reason.name == (
            OPTIMAL)
        np.testing.assert_allclose(g.primal_solution, w.primal_solution,
                                   atol=1e-6)
        np.testing.assert_allclose(g.dual_solution, w.dual_solution,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Errors and the device rule
# ---------------------------------------------------------------------------


def test_mismatched_patterns_raise():
    problems = [port_problem(generate_pagerank_lp(num_nodes=60, seed=s))
                for s in (0, 1)]
    params = port_params(fleet_pdhg_params(optimality_criteria(1e-6)))
    with pytest.raises(ValueError, match="identical"):
        batch.solve_batch_shared_pattern(params, problems, device="cpu")


def qp_base_spec(spec):
    base = spec.base_problem
    return dataclasses.replace(spec, base_problem=dataclasses.replace(
        base, objective_matrix=sp.csc_matrix(
            sp.eye(base.constraint_matrix.shape[1]))))


# case: (a change of the parameters, of the spec, the error's words)
SPEC_REFUSALS = {
    "qp_base": (lambda p: p, qp_base_spec, "FleetSpec fleets are LP-only"),
    "constant_step": (constant_steps, lambda s: s,
                      "require the adaptive step rule"),
}


@pytest.mark.parametrize("case", sorted(SPEC_REFUSALS))
def test_fleet_spec_refusals_match_jax(case):
    """A FleetSpec over a QP, or with constant steps: both packages
    raise the same ValueError."""
    change_params, change_spec, words = SPEC_REFUSALS[case]
    params = change_params(fleet_pdhg_params(optimality_criteria(1e-6)))
    with pytest.raises(ValueError, match=words):
        jx_batch.prepare_shared_pattern_fleet(
            params, change_spec(jx_fleet_spec(40, [0.8, 0.9])))
    with pytest.raises(ValueError, match=words):
        batch.prepare_shared_pattern_fleet(
            to_port(params), change_spec(pagerank_fleet_spec(40, [0.8, 0.9])),
            device="cpu")


def test_fleet_spec_refuses_bound_width_rescaling():
    """The device rescaling has no bound-width step: a FleetSpec with the
    flag raises (the JAX package drops the flag: C4 in ROADMAP.md)."""
    params = dataclasses.replace(
        port_params(fleet_pdhg_params(optimality_criteria(1e-6))),
        bound_width_rescaling=True)
    with pytest.raises(ValueError, match="bound_width_rescaling"):
        batch.prepare_shared_pattern_fleet(
            params, pagerank_fleet_spec(40, [0.8, 0.9]), device="cpu")


def test_malitsky_pock_fleet_is_refused():
    params = dataclasses.replace(
        port_params(fleet_pdhg_params(optimality_criteria(1e-6))),
        step_size_policy_params=tx.MalitskyPockStepsizeParameters(
            downscaling_factor=0.7, breaking_factor=1.0,
            interpolation_coefficient=1.0))
    with pytest.raises(ValueError, match="adaptive or constant"):
        batch.prepare_shared_pattern_fleet(
            params, [port_problem(p) for p in pagerank_fleet(40)],
            device="cpu")


def test_empty_fleet():
    params = port_params(fleet_pdhg_params(optimality_criteria(1e-6)))
    assert batch.solve_batch_shared_pattern(params, [], device="cpu") == []


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = port_params(fleet_pdhg_params(optimality_criteria(1e-6)))
    spec = pagerank_fleet_spec(40, [0.8, 0.9])
    for call in (batch.prepare_shared_pattern_fleet,
                 batch.solve_batch_shared_pattern):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(params, spec)
    fleet = batch.prepare_shared_pattern_fleet(params, spec, device="cpu")
    assert fleet.device == CPU
    assert fleet.bundle.scaled.constraint_matrix.vals.device == CPU


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def test_fleet_fingerprint():
    problems = pagerank_fleet(40)
    h = hashlib.sha256()
    for p in problems:
        h.update(jx_ckpt.problem_fingerprint(p).encode())
    assert batch.fleet_fingerprint(
        [port_problem(p) for p in problems]) == "fleet:" + h.hexdigest()
    spec = pagerank_fleet_spec(40, [0.8, 0.9])
    fp = batch.fleet_fingerprint(spec)
    assert fp.startswith("fleet-spec:")
    assert fp == batch.fleet_fingerprint(pagerank_fleet_spec(40, [0.8, 0.9]))
    assert fp != batch.fleet_fingerprint(pagerank_fleet_spec(40, [0.8, 0.91]))


def phases(params, path):
    """(phase 1: 80 iterations, checkpointing every dispatch; phase 2:
    resume to the criteria)."""
    criteria = params.termination_criteria
    first = dataclasses.replace(
        params,
        termination_criteria=dataclasses.replace(criteria,
                                                 iteration_limit=80),
        checkpoint_path=path,
    )
    return first, dataclasses.replace(params, resume_from_checkpoint=path)


@pytest.mark.parametrize("ingest", ["list", "fleet_spec"])
def test_checkpoint_resume(ingest, tmp_path):
    """Both ingests resume to the reasons and solutions of an
    uninterrupted run (a FleetSpec fleet is fingerprinted by its base
    problem and thetas)."""
    params = port_params(fleet_pdhg_params(optimality_criteria(1e-7)))
    if ingest == "list":
        fleet = [port_problem(p) for p in
                 generate_pagerank_lp_fleet(150, [0.85, 0.95], seed=5)]
    else:
        fleet = pagerank_fleet_spec(150, [0.85, 0.95], seed=5)
    full = batch.solve_batch_shared_pattern(params, fleet, device="cpu")
    first, second = phases(params, str(tmp_path / "fleet.npz"))
    cut = batch.solve_batch_shared_pattern(first, fleet, device="cpu")
    assert all(o.termination_reason.name
               == "TERMINATION_REASON_ITERATION_LIMIT" for o in cut)
    resumed = batch.solve_batch_shared_pattern(second, fleet, device="cpu")
    for a, b in zip(resumed, full):
        assert a.termination_reason == b.termination_reason
        assert a.termination_reason.name == OPTIMAL
        np.testing.assert_allclose(a.primal_solution, b.primal_solution,
                                   atol=1e-8)
        np.testing.assert_allclose(a.dual_solution, b.dual_solution,
                                   atol=1e-8)
    # another fleet's checkpoint is refused
    other = dataclasses.replace(
        second, resume_from_checkpoint=str(tmp_path / "fleet.npz"))
    with pytest.raises(ValueError, match="different problem"):
        batch.solve_batch_shared_pattern(
            other, pagerank_fleet_spec(150, [0.85, 0.9], seed=5),
            device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    params = fleet_pdhg_params(optimality_criteria(1e-7))
    problems = generate_pagerank_lp_fleet(150, [0.85, 0.95], seed=5)
    tproblems = [port_problem(p) for p in problems]
    full = jx_batch.solve_batch_shared_pattern(params, problems)
    first, second = phases(params, str(tmp_path / "fleet.npz"))
    if writer == "jax":
        jx_batch.solve_batch_shared_pattern(first, problems)
        resumed = batch.solve_batch_shared_pattern(
            to_port(second), tproblems, device="cpu")
    else:
        batch.solve_batch_shared_pattern(to_port(first), tproblems,
                                         device="cpu")
        resumed = jx_batch.solve_batch_shared_pattern(second, problems)
    for a, b in zip(resumed, full):
        assert a.termination_reason.name == b.termination_reason.name
        assert a.termination_reason.name == OPTIMAL
        np.testing.assert_allclose(a.primal_solution, b.primal_solution,
                                   atol=1e-6)
        np.testing.assert_allclose(a.dual_solution, b.dual_solution,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# The lane restart scheme against the port's single-instance one
# ---------------------------------------------------------------------------


def lane_of(tree, i):
    """Lane i of a lane dataclass or tuple (vectors (dim, B), scalars
    (B,)), with the single-instance solver's Python counters and flag."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: lane_of(getattr(tree, f.name), i)
            for f in dataclasses.fields(tree)})
    return tree[..., i]


def single_lane_problem(fleet, i):
    from firstorderlp_torch.ops.device_problem import DeviceQp
    from firstorderlp_torch.ops.linops import build_csr_op

    qp = fleet.bundle.scaled
    op = qp.constraint_matrix
    pattern = op.pattern
    csr = sp.csr_matrix(
        (op.vals[:, i].numpy(), pattern.fwd.indices.numpy(),
         pattern.fwd.indptr.numpy()), shape=pattern.shape)
    return DeviceQp(
        variable_lower_bound=qp.variable_lower_bound[:, i],
        variable_upper_bound=qp.variable_upper_bound[:, i],
        objective_vector=qp.objective_vector[:, i],
        objective_constant=qp.objective_constant[i],
        right_hand_side=qp.right_hand_side[:, i],
        is_equality=qp.is_equality[:, 0],
        is_equality_f32=qp.is_equality_f32[:, 0],
        constraint_matrix=build_csr_op(csr, torch.float64, CPU),
        objective_matrix=None,
    )


@pytest.mark.parametrize("metric", ["gap_over_distance",
                                    "gap_over_distance_squared",
                                    "no_restart_to_current"])
@pytest.mark.parametrize("scheme", ["no_restarts", "fixed_frequency",
                                    "adaptive_normalized",
                                    "adaptive_localized",
                                    "adaptive_distance"])
def test_lane_restart_scheme_matches_single_instance(scheme, metric):
    """Every scheme and metric, per lane, against the port's
    saddle_point.run_restart_scheme on that lane alone (f64, rtol 1e-12),
    mid-solve, with one lane that has no localized gap yet and one that
    restarts artificially."""
    from firstorderlp_torch import saddle_point

    tparams = port_params(fleet_pdhg_params(
        terminate_on_iteration_limit(1000)))
    fleet = batch.prepare_shared_pattern_fleet(
        tparams, [port_problem(p) for p in pagerank_fleet(60)],
        device="cpu")
    config = batch._config(tparams)
    state = fleet.initial_state
    while int(state.iteration.min()) < 45:
        state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
    # lane 1 has no localized gap yet; lane 2's last restart had a tiny
    # gap (the localized scheme keeps the lane: no restart) and moved far
    far = torch.tensor([1.0, 1.0, 1e30], dtype=torch.float64)
    info = dataclasses.replace(
        state.restart_info,
        has_gap=torch.tensor([True, False, True]),
        last_restart_length=torch.tensor([3, 1, 7]),
        gap=state.restart_info.gap * torch.tensor([1.0, 1.0, 1e-30],
                                                  dtype=torch.float64),
        primal_distance_moved_last_restart_period=(
            state.restart_info.primal_distance_moved_last_restart_period
            * far),
        dual_distance_moved_last_restart_period=(
            state.restart_info.dual_distance_moved_last_restart_period
            * far),
    )
    params = dataclasses.replace(
        tparams.restart_params,
        restart_scheme=tx.RestartScheme(scheme),
        restart_to_current_metric=tx.RestartToCurrentMetric(metric),
        restart_frequency_if_fixed=5,
    )
    x, y = state.current_primal_solution, state.current_dual_solution
    primal_norm = (1.0 / state.step_size) * state.primal_weight * (
        torch.ones_like(x))
    dual_norm = (1.0 / state.step_size) / state.primal_weight * (
        torch.ones_like(y))
    # lane 0 restarts artificially (its average is long); lanes 1 and 2
    # count more iterations, so their scheme decides
    iterations = state.iteration - 1 + torch.tensor([0, 1000, 1000])
    got = batch.lane_restart_scheme(
        fleet.bundle.scaled, state.avg, x, y, info, iterations, primal_norm,
        dual_norm, state.primal_weight, params)
    for i in range(len(DAMPING)):
        want = saddle_point.run_restart_scheme(
            single_lane_problem(fleet, i), lane_of(state.avg, i), x[:, i],
            y[:, i], lane_of(info, i), iterations[i], primal_norm[:, i],
            dual_norm[:, i], state.primal_weight[i], params)
        assert int(got.restart_choice[i]) == want.restart_choice
        for name, mine, theirs in (
                ("primal", got.primal_solution[:, i], want.primal_solution),
                ("dual", got.dual_solution[:, i], want.dual_solution)):
            np.testing.assert_allclose(mine.numpy(), theirs.numpy(),
                                       rtol=1e-12, atol=0, err_msg=name)
        for f in dataclasses.fields(want.restart_info):
            mine = getattr(lane_of(got.restart_info, i), f.name)
            theirs = getattr(want.restart_info, f.name)
            np.testing.assert_allclose(
                np.asarray(mine, np.float64), np.asarray(theirs, np.float64),
                rtol=1e-12, atol=1e-300, err_msg=f.name)
        for f in dataclasses.fields(want.avg):
            np.testing.assert_allclose(
                np.asarray(getattr(lane_of(got.avg, i), f.name), np.float64),
                np.asarray(getattr(want.avg, f.name), np.float64),
                rtol=1e-12, atol=0, err_msg=f.name)
