"""The port's fused statistics and termination check (models/common.
evaluate_fused_statistics: F2d stats_point, A x and A'y, F2e
stats_primal, A ray, F2f stats_dual of ops/eval_stats.py) on the CPU,
where the wrappers take the plain versions.

- Against the JAX package's evaluate_unscaled_stats (f32, its RoutedOp
  in Pallas interpret mode, as tests/test_torch_ops.py runs it) at the
  same point, made with numpy from a seed: a 1,000-node PageRank LP,
  example_lp (at its optimum, under the l_inf norm too, and with
  infinite bounds), the easy primal-infeasible and the dual-infeasible
  LPs at their certificates, a numerical error, the iteration, KKT-pass
  and time limits, infeasibility detection off, an infinite entry (NaN
  objectives) and x = 0 (the ray's norm 0). Reasons exactly; f32 values
  in the rounding class: |d| <= 1e-5 max|want| + 1e-7 for vectors, and
  for scalars rtol 1e-5 with atol 1e-6 (the two packages round their
  sums differently, so a gap of nearly equal objectives moves by an
  ulp of the objectives). The whole evaluation (_eval_block) against
  the JAX one from the same PDHG state: the statistics, the reason and
  the evaluation point.
- Against the port's eager statistics (the previous release's route):
  maxima bitwise, every other field in the rounding class, the same
  reason; the plain totals' f64 sums against the eager f32 sums within
  n 2^-24 sum|t| plus an ulp (the f32 sum's own error bound); the
  evaluation point (F2d) bitwise evaluation_point's.
- The route: which bundles take it (f32 kernel operator, CSR and tile
  plan) and which stay eager (f64, QP, a mesh's ShardedRoutedOp, a
  fleet); an evaluation makes three B2 products (A x, A'y, A ray), two
  with infeasibility detection off, where the eager route made four.
- The wrappers' contracts: the argument structures, the totals' order
  and the reason codes against csrc/eval_stats.cu, host numbers and
  tensors alike, other devices refused.
- The kernels' launches: the constants against the source, F2e's and
  F2f's grid and order of addition, F2d's grid (a model of its walk
  over x's and y's chunks) and its output buffer (every part on 16
  bytes); F2d's plain choice of the point bitwise the JAX _eval_block's.
"""

import ctypes
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.models import common as jx_common
from firstorderlp_tpu.models import pdhg as jx_pdhg

import firstorderlp_torch as tx
from firstorderlp_torch.iteration_stats import (
    DeviceConvergenceInfo,
    DeviceInfeasibilityInfo,
)
from firstorderlp_torch.models import common as tx_common
from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import eval_stats, kernels_build, routed
from firstorderlp_torch.saddle_point import SolutionWeightedAverage

import eval_stats_cases as esc
import fixtures
import trial_cases as tc
from test_torch_pdhg import jax_config, port_problem
from test_torch_pdhg_step import jax_params, jax_problem, jax_state

# the fields that are maxima (or maxima divided by the same scalar): the
# fused route gives the eager route's bits there
MAXIMA = ("l_inf_primal_residual", "l_inf_dual_residual",
          "relative_l_inf_primal_residual", "relative_l_inf_dual_residual",
          "l_inf_primal_variable", "l_inf_dual_variable",
          "max_primal_ray_infeasibility", "primal_ray_quadratic_norm",
          "max_dual_ray_infeasibility")


# ---------------------------------------------------------------------------
# Both packages' problems and points
# ---------------------------------------------------------------------------


def example_lp_open():
    """example_lp with x2 and x4 unbounded above and x3 below."""
    p = fixtures.example_lp()
    return dataclasses.replace(
        p, variable_lower_bound=np.array([0.0, 0.0, -np.inf, 0.0]),
        variable_upper_bound=np.array([2.0, np.inf, 6.0, np.inf]))


JAX_PROBLEMS = {
    "pagerank": lambda: jax_problem("pagerank"),
    "example_lp": fixtures.example_lp,
    "example_lp_open": example_lp_open,
    "primal_infeasible": fixtures.example_lp_easy_primal_infeasible,
    "dual_infeasible": fixtures.example_lp_dual_infeasible,
}
_PREPARED = {}


def prepared(name):
    """(the port's PreparedProblem, the JAX package's) of the problem, f32
    on the kernel operator (CSR), with the same rescaling."""
    if name not in _PREPARED:
        jproblem = JAX_PROBLEMS[name]()
        port = tx_pdhg.prepare_problem(tc.params(), port_problem(jproblem),
                                       device="cpu")
        jprep = jx_pdhg.prepare_problem(jax_params("adaptive"), jproblem)
        for field in ("variable_rescaling", "constraint_rescaling"):
            assert np.array_equal(
                getattr(port.bundle, field).numpy(),
                np.asarray(getattr(jprep.bundle, field))), field
        _PREPARED[name] = port, jprep
    return _PREPARED[name]


# (problem, the original point or "random", criteria, flag, iteration,
# KKT passes, elapsed seconds, the reason it reaches)
POINTS = {
    "pagerank": ("pagerank", "random", {}, False, 7, 12.0, 0.5, 0),
    "optimal": ("example_lp", ([1.0, 0.0, 6.0, 2.0], [0.5, 4.0, 0.0]), {},
                False, 7, 12.0, 0.5, 1),
    "optimal_l_inf": ("example_lp", ([1.0, 0.0, 6.0, 2.0], [0.5, 4.0, 0.0]),
                      {"optimality_norm": "l_inf"}, False, 7, 12.0, 0.5, 1),
    "infinite_bounds": ("example_lp_open", "random", {}, False, 7, 12.0,
                        0.5, 0),
    "primal_infeasible": ("primal_infeasible", ([0.0, 0.0], [1.0]),
                          {"eps_primal_infeasible": 1e-6}, False, 7, 12.0,
                          0.5, 2),
    "dual_infeasible": ("dual_infeasible", ([2.0, 1.0], [0.0]),
                        {"eps_dual_infeasible": 1e-6}, False, 7, 12.0, 0.5,
                        3),
    "numerical_error": ("example_lp", "random", {}, True, 7, 12.0, 0.5, 7),
    "iteration_limit": ("example_lp", "random", {"iteration_limit": 5},
                        False, 7, 12.0, 0.5, 5),
    "kkt_limit": ("example_lp", "random", {"kkt_matrix_pass_limit": 10.0},
                  False, 7, 12.0, 0.5, 6),
    "time_limit": ("example_lp", "random", {"time_sec_limit": 0.25}, False,
                   7, 12.0, 0.5, 4),
    "no_ray": ("pagerank", "random", {"eps_primal_infeasible": 0.0,
                                      "eps_dual_infeasible": 0.0}, False, 7,
               12.0, 0.5, 0),
    "non_finite": ("pagerank", "non_finite", {}, False, 7, 12.0, 0.5, 0),
    "zero": ("pagerank", "zero", {}, False, 7, 12.0, 0.5, 0),
}
BASE_CRITERIA = dict(eps_optimal_absolute=1e-4, eps_optimal_relative=1e-4)


def criteria_pair(overrides):
    """The case's TerminationCriteria in the port's and the JAX
    package's types."""
    kwargs = {**BASE_CRITERIA, **overrides}
    norm = kwargs.pop("optimality_norm", "l2")
    return (tx.TerminationCriteria(optimality_norm=tx.OptimalityNorm(norm),
                                   **kwargs),
            jx.TerminationCriteria(optimality_norm=jx.OptimalityNorm(norm),
                                   **kwargs))


def scaled_point(port, kind, seed=0):
    """The scaled f32 point (x, y) of the case: the original point given,
    times the rescaling, or one made with numpy from `seed`."""
    bundle = port.bundle
    vr = bundle.variable_rescaling.numpy()
    cr = bundle.constraint_rescaling.numpy()
    n, m = vr.shape[0], cr.shape[0]
    if isinstance(kind, tuple):
        x, y = (np.asarray(v, np.float64) for v in kind)
        return (torch.as_tensor(np.float32(x) * vr),
                torch.as_tensor(np.float32(y) * cr))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "non_finite":
        x[n // 2] = np.inf
    return torch.as_tensor(x), torch.as_tensor(y)


def assert_rounding_class(got, want, name, scalar=True):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scalar:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        return
    bound = 1e-5 * float(np.max(np.abs(want), initial=0.0)) + 1e-7
    assert float(np.max(np.abs(got - want), initial=0.0)) <= bound, name


def port_stats(case, host_numbers=False):
    """(port prepared, JAX prepared, x, y, the port's (conv, infeas,
    reason)) of a POINTS case on the fused route."""
    problem, kind, overrides, flag, it, kkt, elapsed, _ = POINTS[case]
    port, jprep = prepared(problem)
    x, y = scaled_point(port, kind)
    criteria, _ = criteria_pair(overrides)
    assert tx_common.fused_statistics(port.bundle, x)
    if not host_numbers:
        flag = torch.tensor(flag)
        it = torch.tensor(it, dtype=torch.int64)
        kkt = torch.tensor(kkt, dtype=torch.float64)
        elapsed = torch.tensor(elapsed, dtype=torch.float64)
    return port, jprep, x, y, tx_common.evaluate_unscaled_stats(
        port.bundle, criteria, x, y, flag, it, kkt, elapsed)


def eager_stats(bundle, *args):
    """The port's eager statistics (the previous release's route) on a
    bundle the fused route would take."""
    saved = tx_common.fused_statistics
    tx_common.fused_statistics = lambda *a: False
    try:
        return tx_common.evaluate_unscaled_stats(bundle, *args)
    finally:
        tx_common.fused_statistics = saved


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(POINTS))
def test_fused_statistics_match_the_jax_statistics(case):
    problem, kind, overrides, flag, it, kkt, elapsed, reason = POINTS[case]
    port, jprep, x, y, (conv, infeas, got_reason) = port_stats(case)
    _, jcriteria = criteria_pair(overrides)
    jconv, jinfeas, jreason = jx_common.evaluate_unscaled_stats(
        jprep.bundle, jcriteria, jnp.asarray(x.numpy()),
        jnp.asarray(y.numpy()), jnp.asarray(flag), jnp.asarray(it),
        jnp.asarray(kkt, jnp.float64), jnp.asarray(elapsed, jnp.float64))
    assert int(got_reason) == int(jreason) == reason
    for name in DeviceConvergenceInfo._fields:
        assert_rounding_class(getattr(conv, name), getattr(jconv, name),
                              name)
    for name in DeviceInfeasibilityInfo._fields:
        assert_rounding_class(getattr(infeas, name), getattr(jinfeas, name),
                              name)
    if case == "non_finite":
        assert np.isnan(float(conv.dual_objective))
        assert np.isnan(float(conv.primal_objective))
    if case == "no_ray":
        assert all(float(v) == 0.0 for v in infeas)


@pytest.mark.parametrize("case", ["accept", "first"])
def test_evaluation_matches_the_jax_evaluation(case):
    """The whole _eval_block from the same PDHG state on the 1,000-node
    LP (an average to evaluate, or the first iteration's empty one):
    the statistics, the reason and the evaluation point against the
    JAX package's."""
    port, jprep = prepared("pagerank")
    config = tx_pdhg._make_config(tc.params())
    state, _ = tc.case_state(port, case)
    state = tx_pdhg._device_counters(state)
    new, result = tx_pdhg._eval_block(port.bundle, state, 0.0, config)
    jstate = jax_state(jprep.initial_state, state)
    jnew, jresult = jx_pdhg._eval_block(
        jprep.bundle, jstate, jnp.asarray(0.0, jnp.float64),
        jax_config(jax_params("adaptive")))
    assert int(result.termination_reason) == int(jresult.termination_reason)
    for part in ("conv", "infeas"):
        for name, g, w in zip(getattr(result, part)._fields,
                              getattr(result, part), getattr(jresult, part)):
            assert_rounding_class(g, w, f"{part}.{name}")
    for name in ("avg_primal_out", "avg_dual_out"):
        assert_rounding_class(getattr(new, name), getattr(jnew, name), name,
                              scalar=False)


# ---------------------------------------------------------------------------
# Against the port's eager statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(POINTS))
def test_fused_statistics_match_the_eager_statistics(case):
    problem, kind, overrides, flag, it, kkt, elapsed, reason = POINTS[case]
    port, _, x, y, (conv, infeas, got_reason) = port_stats(case)
    criteria, _ = criteria_pair(overrides)
    econv, einfeas, ereason = eager_stats(port.bundle, criteria, x, y, flag,
                                          it, kkt, elapsed)
    assert int(got_reason) == int(ereason) == reason
    for part, got, want in (("conv", conv, econv),
                            ("infeas", infeas, einfeas)):
        for name, g, w in zip(got._fields, got, want):
            if name in MAXIMA:
                assert np.array_equal(g.numpy(), w.numpy(), equal_nan=True), (
                    f"{part}.{name}: {float(g)!r} != {float(w)!r}")
            else:
                assert_rounding_class(g, w, f"{part}.{name}")


@pytest.mark.parametrize("case", esc.KERNEL_CASES)
def test_plain_totals_are_the_f32_sums_within_their_bound(case):
    """Each f64 sum of the plain totals against torch.sum of the same
    terms in f32 (the previous release's sums): within n 2^-24 sum|t|
    plus one ulp of the f32 sum."""
    n, m = 3000, 2001
    inp = esc.kernel_inputs(n, m, case, seed=4)
    point = eval_stats.stats_point_plain(
        inp["x"], inp["y"], inp["variable_rescaling"],
        inp["constraint_rescaling"], inp["average"])
    _, sums, _ = eval_stats.primal_terms(
        point.primal, inp["aty"], inp["objective"], inp["lower"],
        inp["upper"], point.primal_norm, inp["criteria"].ray)
    dual_sums, _ = eval_stats.dual_terms(point.dual, inp["ax"], inp["aray"],
                                         inp["rhs"], inp["is_equality"])
    for name, terms in {**sums, **dual_sums}.items():
        fused = float(torch.sum(terms, dtype=torch.float64).float())
        eager = float(torch.sum(terms))
        size = terms.shape[0]
        bound = size * 2.0 ** -24 * float(terms.double().abs().sum()) + (
            float(np.spacing(np.float32(abs(eager)))))
        assert fused == eager or abs(fused - eager) <= bound or (
            np.isnan(fused) and np.isnan(eager)), (name, fused, eager)


@pytest.mark.parametrize("case", ["mixed", "empty_average",
                                  "numerical_error", "zero"])
def test_point_is_bitwise_evaluation_point(case):
    """F2d's point against common.evaluation_point and the division by
    the rescaling, and the fused statistics from the average against
    those from that point."""
    inp = esc.kernel_inputs(500, 301, case, seed=2)
    a = inp["average"]
    avg = SolutionWeightedAverage(a.sum_x, a.sum_y, a.count_x, a.count_y,
                                     a.weight_x, a.weight_y)
    state = type("State", (), {"avg": avg,
                               "numerical_error": a.numerical_error})
    want_x, want_y = tx_common.evaluation_point(state, inp["x"], inp["y"])
    point = eval_stats.stats_point(inp["x"], inp["y"],
                                   inp["variable_rescaling"],
                                   inp["constraint_rescaling"], a)
    for got, want in ((point.scaled_primal, want_x),
                      (point.scaled_dual, want_y),
                      (point.primal, want_x / inp["variable_rescaling"]),
                      (point.dual, want_y / inp["constraint_rescaling"])):
        assert torch.equal(got, want)
    assert torch.equal(point.primal_norm,
                       torch.amax(torch.abs(point.primal)))


# the PDHG state's changes: (average fields set to zero, numerical error)
PICKS = {
    "average": ((), False),
    "numerical_error": ((), True),
    "count_x_zero": (("sum_primal_solutions_count",), False),
    "count_y_zero": (("sum_dual_solutions_count",), False),
    "weight_x_zero": (("sum_primal_solution_weights",), False),
    "weight_y_zero": (("sum_dual_solution_weights",), False),
}


@pytest.mark.parametrize("case", sorted(PICKS))
def test_plain_point_picks_as_the_jax_eval_block(case):
    """stats_point_plain's scaled point against the JAX package's
    _eval_block's evaluation point (avg_primal_out and avg_dual_out,
    firstorderlp_tpu/models/pdhg.py:586-610) from the same PDHG state on
    the 1,000-node LP, bitwise: the average over its weights, the current
    iterate where the numerical error is set or a count is zero, a zero
    weight read as 1."""
    port, jprep = prepared("pagerank")
    state, _ = tc.case_state(port, "accept")
    zeroed, flag = PICKS[case]
    avg = dataclasses.replace(state.avg, **{
        name: torch.zeros_like(getattr(state.avg, name)) for name in zeroed})
    state = tx_pdhg._device_counters(dataclasses.replace(
        state, avg=avg, numerical_error=torch.tensor(flag)))
    jnew, _ = jx_pdhg._eval_block(
        jprep.bundle, jax_state(jprep.initial_state, state),
        jnp.asarray(0.0, jnp.float64), jax_config(jax_params("adaptive")))
    point = eval_stats.stats_point_plain(
        state.current_primal_solution, state.current_dual_solution,
        port.bundle.variable_rescaling, port.bundle.constraint_rescaling,
        eval_stats.Average(avg.sum_primal_solutions, avg.sum_dual_solutions,
                           avg.sum_primal_solutions_count,
                           avg.sum_dual_solutions_count,
                           avg.sum_primal_solution_weights,
                           avg.sum_dual_solution_weights,
                           state.numerical_error))
    current = case in ("numerical_error", "count_x_zero", "count_y_zero")
    for got, want, iterate in (
            (point.scaled_primal, jnew.avg_primal_out,
             state.current_primal_solution),
            (point.scaled_dual, jnew.avg_dual_out,
             state.current_dual_solution)):
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, iterate) == current


def test_statistics_from_the_average_are_those_from_its_point():
    """evaluate_fused_statistics with an average: the point and every
    statistic bitwise those of evaluate_unscaled_stats at
    evaluation_point's point."""
    port, _ = prepared("pagerank")
    config = tx_pdhg._make_config(tc.params())
    state, _ = tc.case_state(port, "accept")
    state = tx_pdhg._device_counters(state)
    x, y = state.current_primal_solution, state.current_dual_solution
    args = (state.numerical_error, 7, 12.0, 0.5)
    got = tx_common.evaluate_fused_statistics(
        port.bundle, config.criteria, x, y, state.avg, *args)
    px, py = tx_common.evaluation_point(state, x, y)
    want = tx_common.evaluate_unscaled_stats(port.bundle, config.criteria,
                                             px, py, *args)
    assert torch.equal(got[0], px) and torch.equal(got[1], py)
    for g, w in zip(got[2:], want):
        for u, v in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def test_which_bundles_take_the_fused_route():
    for tile_aligned in (False, True):
        prep, _ = tc.prepared("bounded", "adaptive", "cpu",
                              tile_aligned=tile_aligned)
        x = prep.initial_state.current_primal_solution
        assert tx_common.fused_statistics(prep.bundle, x)
        assert not tx_common.fused_statistics(prep.bundle, x.double())
        assert not tx_common.fused_statistics(prep.bundle, x[:, None])
    f64 = dataclasses.replace(tc.params(), dtype="float64",
                              matrix_format="sparse")
    prep = tx_pdhg.prepare_problem(f64, tc.PROBLEMS["bounded"](),
                                   device="cpu")
    assert not tx_common.fused_statistics(
        prep.bundle, prep.initial_state.current_primal_solution)
    qp = tx_pdhg.prepare_problem(tc.params(), port_problem(
        fixtures.example_qp()), device="cpu")
    assert not tx_common.fused_statistics(
        qp.bundle, qp.initial_state.current_primal_solution)


def test_meshes_and_fleets_stay_eager(monkeypatch):
    """A mesh's operator (ShardedRoutedOp) and a fleet's lanes run the
    eager statistics: no F2d launch is asked for."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.parallel import sharded_optimize, solver_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("the fused statistics were taken")

    monkeypatch.setattr(eval_stats, "stats_point", refuse)
    problem = tc.PROBLEMS["bounded"]()
    params = dataclasses.replace(
        tc.params(), termination_criteria=tx.TerminationCriteria(
            iteration_limit=30))
    out = sharded_optimize(params, problem,
                           solver_mesh(2, 1, [torch.device("cpu")] * 2))
    assert out.iteration_count > 0
    fleet = batch.solve_batch_shared_pattern(
        params, [problem, problem], device="cpu")
    assert len(fleet) == 2


@pytest.mark.parametrize("case,products", [
    ("pagerank", {"A": 2, "AT": 1}), ("no_ray", {"A": 1, "AT": 1})])
def test_an_evaluation_makes_three_products(case, products, monkeypatch):
    """A x, A'y and A ray on the original operator (A x and A'y with
    infeasibility detection off), where the eager route computed A'y of
    the same dual twice."""
    calls = {"A": 0, "AT": 0}
    plain = routed.spmv_csr_plain

    def counted(mat, x):
        calls[mat.label] += 1
        return plain(mat, x)

    monkeypatch.setattr(routed, "spmv_csr_plain", counted)
    port_stats(case)
    assert calls == products
    problem, kind, overrides, *_ = POINTS[case]
    port, _ = prepared(problem)
    x, y = scaled_point(port, kind)
    calls.update(A=0, AT=0)
    eager_stats(port.bundle, criteria_pair(overrides)[0], x, y, False, 7,
                12.0, 0.5)
    assert calls["AT"] == (2 if case == "pagerank" else 1)


# ---------------------------------------------------------------------------
# The wrappers' contracts
# ---------------------------------------------------------------------------


def source():
    with open(os.path.join(kernels_build.CSRC_DIR, "eval_stats.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", ["PointArgs", "PrimalArgs", "DualArgs"])
def test_argument_structs_match_the_c_structs(name):
    from test_torch_kernels_build import c_struct_fields

    cls = {"PointArgs": eval_stats._PointArgs,
           "PrimalArgs": eval_stats._PrimalArgs,
           "DualArgs": eval_stats._DualArgs}[name]
    got = [(n, "p" if t is ctypes.c_void_p else "i") for n, t in cls._fields_]
    assert got == c_struct_fields(name)


@pytest.mark.parametrize("enum,names", [
    ("PrimalTotal", eval_stats.PRIMAL_TOTALS),
    ("DualTotal", eval_stats.DUAL_TOTALS)])
def test_totals_order_matches_the_c_enums(enum, names):
    body = re.search(rf"enum {enum} : int {{(.*?)\n}};", source(),
                     re.DOTALL).group(1)
    members = [m for m in re.findall(r"^\s*k(\w+)", body, re.MULTILINE)
               if m not in ("PrimalSums", "PrimalTotals", "DualSums",
                            "DualTotals")]
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", m).lower() for m in members]
    assert snake == list(names)


def test_reason_codes_match_termination_reason():
    found = re.findall(r"reason = (\d);\s*// (\w+)", source())
    assert len(found) == 7
    for code, name in found:
        full = (name if name.startswith("TERMINATION") else
                f"TERMINATION_REASON_{name}")
        assert int(tx.TerminationReason[full]) == int(code), name


def test_pytorch_rounds_python_floats_to_f32_against_f32_tensors():
    """The rule the kernel's thresholds follow (the host rounds each
    criterion to f32): a Python float meets an f32 tensor as its f32
    value in a sum, a product and a comparison."""
    t = torch.tensor(0.1, dtype=torch.float32)
    assert bool(t <= 0.1) and not bool(t < 0.1 + 1e-12)
    one = torch.tensor(1.0, dtype=torch.float32)
    s = 2.0 ** -24 * (1.0 + 2.0 ** -25)  # rounds to 2^-24 in f32
    assert float(one + s) == 1.0  # 1 + 2^-24 ties to 1.0
    assert float(torch.tensor(3.0) * (1 / 3)) == float(
        np.float32(3.0) * np.float32(1 / 3))


def test_host_numbers_and_tensors_give_the_same_statistics():
    for case in ("numerical_error", "iteration_limit", "time_limit"):
        tensors = port_stats(case)[-1]
        numbers = port_stats(case, host_numbers=True)[-1]
        for g, w in zip(tensors[:2], numbers[:2]):
            assert all(torch.equal(u, v) for u, v in zip(g, w))
        assert int(tensors[2]) == int(numbers[2]) == POINTS[case][-1]


def test_wrappers_refuse_other_devices_and_a_ray_out_of_place():
    inp = esc.kernel_inputs(50, 31, "mixed")
    with pytest.raises(ValueError):
        eval_stats.stats_point(inp["x"].to("meta"), inp["y"].to("meta"),
                               inp["variable_rescaling"].to("meta"),
                               inp["constraint_rescaling"].to("meta"))
    with pytest.raises(ValueError):
        eval_stats.stats_point(inp["x"], inp["y"].to("meta"),
                               inp["variable_rescaling"],
                               inp["constraint_rescaling"])
    point = eval_stats.stats_point(inp["x"], inp["y"],
                                   inp["variable_rescaling"],
                                   inp["constraint_rescaling"])
    _, totals = eval_stats.stats_primal(
        point.primal, inp["aty"], inp["objective"], inp["lower"],
        inp["upper"], point.primal_norm, True)
    with pytest.raises(ValueError):
        eval_stats.stats_dual(point.dual, inp["ax"], None, inp["rhs"],
                              inp["is_equality"], totals, point.primal_norm,
                              inp["scalars"], inp["criteria"])


# ---------------------------------------------------------------------------
# F2e's and F2f's grid, slots and order of addition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,value", [
    ("kStatsThreads", eval_stats.THREADS),
    ("kChunkFloats", eval_stats.CHUNK_FLOATS),
    ("kSlotFloats", eval_stats.SLOT_FLOATS),
    ("kStatsSlots", eval_stats.SLOTS),
    ("kReach", eval_stats.REACH),
])
def test_launch_constants_match_the_kernel(name, value):
    found = re.search(rf"constexpr int {name} = ([0-9 *]+);", source())
    assert found, name
    assert eval(found.group(1)) == value


def test_partials_are_value_major():
    """The kernel's partial_index and its mirror: value k of block b at
    k * blocks + b, every (value, block) its own place in the partials
    the wrappers allocate (K x blocks after the K totals)."""
    body = re.search(r"int partial_index\(int k, int b, int blocks\) "
                     r"\{\s*return ([^;]+);", source())
    assert body.group(1) == "k * blocks + b"
    for k_count, blocks in ((len(eval_stats.PRIMAL_TOTALS), 98),
                            (len(eval_stats.DUAL_TOTALS), 1),
                            (len(eval_stats.DUAL_TOTALS), 528)):
        places = {eval_stats.partial_index(k, b, blocks)
                  for k in range(k_count) for b in range(blocks)}
        assert places == set(range(k_count * blocks))


@pytest.mark.parametrize("sms,depth", [(132, 2), (132, 8), (114, 3)])
@pytest.mark.parametrize("n", [0, 1, 4, 5, 1_029, 100_000, 100_001,
                               1_000_000, 4_000_000])
def test_grid_is_a_slot_a_thread_within_one_wave(n, sms, depth):
    """stats_grid: a thread a 16-byte slot while the slots fit in one
    wave of the card (the SMs times the blocks each holds), one wave
    past that, at least one block."""
    grid = eval_stats.stats_grid(n, sms, depth)
    slots = -(-n // eval_stats.SLOT_FLOATS)
    assert 1 <= grid <= sms * depth
    if slots <= sms * depth * eval_stats.THREADS:
        assert grid == max(1, -(-slots // eval_stats.THREADS))
    else:
        assert grid == sms * depth


# (n, m): n + m from 2 to 4M, every n mod 4, parts that end inside a
# chunk and on its end
POINT_SHAPES = [(1, 1), (2, 3), (3, 2), (4, 5), (1_023, 1), (1_024, 1_024),
                (1_025, 1_027), (100_000, 100_001), (100_001, 100_002),
                (100_002, 100_003), (100_003, 100_000),
                (1_000_000, 1_000_001), (1_999_999, 2_000_001)]


@pytest.mark.parametrize("sms,depth", [(132, 8), (132, 1), (114, 3)])
@pytest.mark.parametrize("n,m", POINT_SHAPES)
def test_point_grid_is_a_slot_a_thread_within_one_wave(n, m, sms, depth):
    """point_grid and a model of stats_point_kernel's walk (chunk c to
    block c mod grid, thread t to slot (c - first chunk of its part) T +
    t, slots past the part's end idle): every 16-byte slot of x's and of
    y's part taken once, each chunk wholly in one part; a block a chunk
    while the chunks fit in one wave, one wave past that, at least one
    block; the blocks with an entry of x, which draw the ticket, are
    those below x's chunks, min(x's chunks, grid) of them."""
    t = eval_stats.THREADS
    grid = eval_stats.point_grid(n, m, sms, depth)
    x_chunks, y_chunks = (eval_stats.point_chunks(k) for k in (n, m))
    assert 1 <= grid <= sms * depth
    if x_chunks + y_chunks <= sms * depth:
        assert grid == x_chunks + y_chunks
    else:
        assert grid == sms * depth
    chunks = np.arange(x_chunks + y_chunks)
    for first, count, length in ((0, x_chunks, n), (x_chunks, y_chunks, m)):
        part = chunks[first:first + count]
        assert part.size * eval_stats.CHUNK_FLOATS >= length
        assert (part.size - 1) * eval_stats.CHUNK_FLOATS < length
        slots = ((part - first)[:, None] * t + np.arange(t)[None, :])
        taken = slots[slots * eval_stats.SLOT_FLOATS < length]
        assert np.array_equal(np.sort(taken),
                              np.arange(-(-length // eval_stats.SLOT_FLOATS)))
    with_x = {int(b) for b in chunks[:x_chunks] % grid}
    assert with_x == set(range(min(x_chunks, grid)))
    assert all(b >= x_chunks for b in set(range(grid)) - with_x)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 100_000, 100_001, 100_002,
                               100_003])
def test_point_layout_starts_every_part_on_16_bytes(n, scaled):
    """point_layout, for m of every residue mod 4: the scaled x and y
    (with an average), the primal, the dual and the norm each at a
    multiple of 4 floats, in that order, none overlapping the next, all
    inside the buffer."""
    for m in (1, 2, 3, 4, 100_001, 100_002, 100_003, 100_004):
        offsets, size = eval_stats.point_layout(n, m, scaled)
        assert (offsets[0] is None) == (offsets[1] is None) == (not scaled)
        parts = [(at, length) for at, length in zip(offsets, (n, m, n, m, 1))
                 if at is not None]
        assert parts[0][0] == 0
        for (at, length), (following, _) in zip(parts, parts[1:]):
            assert at % eval_stats.SLOT_FLOATS == 0
            assert following >= at + length
            assert following - (at + length) < eval_stats.SLOT_FLOATS
        assert parts[-1][0] % eval_stats.SLOT_FLOATS == 0
        assert parts[-1][0] + 1 == size


def test_occupancy_kernels_match_the_entry_point():
    """stats_wave's kernel argument names the kernel that
    folp_stats_occupancy queries for it."""
    body = source()[source().index("int folp_stats_occupancy"):]
    found = dict(re.findall(r"kernel == (\d)\) \{\s*return \(int\)"
                            r"cudaOccupancyMaxActiveBlocksPerMultiprocessor"
                            r"\(\s*blocks, (\w+)_kernel", body))
    found.update(re.findall(r"kernel != (\d)\) return [^;]+;\s*return "
                            r"\(int\)cudaOccupancyMaxActiveBlocksPer"
                            r"Multiprocessor\(\s*blocks, (\w+)_kernel", body))
    assert {name: int(k) for k, name in found.items()} == eval_stats.OCCUPANCY


def warp_tree(v):
    """A shuffle tree over the last axis (32 lanes): lane l adds lane
    l + off, off 16 down to 1; lane 0's value."""
    v = v.copy()
    off = 16
    while off:
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


def kernel_order_sum(terms, blocks):
    """One f64 sum of F2e or F2f in the kernel's order (numpy's f64 adds
    round as the card's): thread t of the launch adds the entries of its
    slots t, t + T B, ... in index order; a shuffle tree in each warp;
    the warps in order from 0 (the block's partial); in the last block,
    lane l adds the partials of blocks l, l + 32, ... from 0, then a
    shuffle tree. Also the number of times each entry was added."""
    threads = blocks * eval_stats.THREADS
    slots = -(-terms.size // eval_stats.SLOT_FLOATS)
    rounds = max(1, -(-slots // threads))
    grid = np.zeros(rounds * threads * eval_stats.SLOT_FLOATS)
    grid[:terms.size] = terms
    grid = grid.reshape(rounds, threads, eval_stats.SLOT_FLOATS)
    index = np.arange(grid.size).reshape(grid.shape)
    seen = np.zeros(grid.size, dtype=np.int64)
    acc = np.zeros(threads)
    for r in range(rounds):
        for k in range(eval_stats.SLOT_FLOATS):
            acc = acc + grid[r, :, k]
            seen[index[r, :, k]] += 1
    warps = warp_tree(acc.reshape(blocks, eval_stats.THREADS // 32, 32))
    partial = np.zeros(blocks)
    for w in range(warps.shape[1]):
        partial = partial + warps[:, w]
    lanes = np.zeros(32)
    for b0 in range(0, blocks, 32):
        part = np.zeros(32)
        part[:min(32, blocks - b0)] = partial[b0:b0 + 32]
        lanes = lanes + part
    return float(warp_tree(lanes)), seen[:terms.size]


@pytest.mark.parametrize("n,depth", [(1, 4), (5, 4), (1_029, 4),
                                     (100_001, 4), (1_000_000, 2),
                                     (2_000_003, 1)])
def test_kernel_order_adds_each_term_once_within_the_bound(n, depth):
    """The kernels' order of addition on stats_grid's grid (a model of
    store_partials_last and launch_totals) adds every entry once, and
    lands within esc.sum_bound (2^-40 sum|t|) of the plain version's f64
    sum: the bound the card tests hold the kernels' totals to."""
    rng = np.random.default_rng(n)
    terms = rng.normal(size=n).astype(np.float32).astype(np.float64)
    blocks = eval_stats.stats_grid(n, 132, depth)
    got, seen = kernel_order_sum(terms, blocks)
    assert np.all(seen == 1)
    want = float(torch.sum(torch.as_tensor(terms.astype(np.float32)),
                           dtype=torch.float64))
    assert abs(got - want) <= esc.sum_bound(torch.as_tensor(terms))
