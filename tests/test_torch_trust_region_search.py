"""The port's f32 exact trust region (ops/trust_region_search.py: the
plain versions of F2a-F2c, which the CPU runs) against the JAX package.

Inputs are made with numpy from seeds at N = 50-2,000 and handed to both
packages. Cases: a mixed problem, a zero radius, g = 0, every component
frozen, infinite bounds (H beyond the last knot > 0), a radius beyond
every knot (t* = tau_max), duplicate knots and a -0.0 knot, each with
bounds of shape (N,) and (B, N).

- solve_bound_constrained_trust_region row by row against the JAX one
  (one row at a time, as the JAX package vmaps it), and the composed
  knot search (tr_search_plain after tr_prologue_plain) against the JAX
  package's _t_star_bisect, at rtol 1e-5, as tests/test_torch_ops.py
  holds the f32 trust region: the port sums in f64 where the JAX
  package sums in f32, so the two differ by f32 rounding;
- bound_optimal_objective_euclidean_batched, whose lower and upper
  values now come from the solve's two split sums, against the JAX one
  in f32 (rtol 1e-5) and against the four sums over slices it used
  before;
- the plain versions composed give the previous release's eager t*
  (written out below as `eager_t_star`) bit for bit where no sum lies
  near a rounding midpoint: the "exact" cases, whose terms are small
  integers (a tau^2 = (u - c)^2 and a = d^2 with d in {1, 2, 4}), so
  every partial sum of a row is an integer below 2^24, exact in f32 in
  any order, and the f32 and the f64 sums are the same number;
- the launch plans (F2b's clusters, F2c's blocks a row from the card's
  SMs and a model of its slot runs) and the wrappers' input checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import trust_region as jx_tr
from firstorderlp_tpu.generators import generate_pagerank_lp as jx_pagerank
from firstorderlp_tpu.ops import device_problem as jx_dev

import firstorderlp_torch as tx
from firstorderlp_torch import trust_region as tx_tr
from firstorderlp_torch.generators import generate_pagerank_lp
from firstorderlp_torch.ops import device_problem as tx_dev
from firstorderlp_torch.ops import routed
from firstorderlp_torch.ops import trust_region_search as trs

import trust_region_cases as tc

RTOL = 1e-5  # f32 sums in a different order and precision
CPU = torch.device("cpu")
CASES, BOUNDS, EXACT_CASES = tc.CASES, tc.BOUNDS, tc.EXACT_CASES
case_inputs, exact_inputs = tc.case_inputs, tc.exact_inputs


def torch_args(args):
    return [torch.as_tensor(v) for v in args]


def row_of(v, i, rows):
    return v[i] if v.ndim == 2 else v


def jax_solve(args):
    """The JAX package's f32 exact solve, one row at a time."""
    c, g, lower, upper, weight, radius = args
    rows = c.shape[0]
    out = []
    for i in range(rows):
        res = jx_tr.solve_bound_constrained_trust_region(
            *(jnp.asarray(row_of(v, i, rows)) for v in (c, g, lower, upper,
                                                        weight)),
            jnp.asarray(radius[i]))
        out.append((np.asarray(res.solution), float(res.value)))
    return out


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("case", CASES)
def test_f32_solve_matches_the_jax_package(case, bounds):
    args = case_inputs(case, bounds, seed=CASES.index(case))
    got = tx_tr.solve_bound_constrained_trust_region(*torch_args(args))
    assert got.solution.dtype == torch.float32
    for i, (solution, value) in enumerate(jax_solve(args)):
        np.testing.assert_allclose(got.solution[i].numpy(), solution,
                                   rtol=RTOL, atol=RTOL * 1e-2)
        np.testing.assert_allclose(float(got.value[i]), value, rtol=RTOL,
                                   atol=RTOL * 1e-2)
    if case in ("radius_zero", "all_frozen"):
        np.testing.assert_array_equal(got.solution.numpy(), args[0])
    if case == "g_zero":
        np.testing.assert_array_equal(got.solution[0].numpy(), args[0][0])


def jax_t_star(args):
    """The JAX package's _t_star_bisect on its own knots (the lines of its
    solve_bound_constrained_trust_region before it), and its rule for a
    zero radius or g = 0."""
    c, g, lower, upper, weight, radius = args
    rows = c.shape[0]
    out = []
    for i in range(rows):
        ci, gi, li, ui, wi = (jnp.asarray(row_of(v, i, rows))
                              for v in (c, g, lower, upper, weight))
        frozen = ((ci >= ui) & (gi <= 0.0)) | ((ci <= li) & (gi >= 0.0))
        d = jnp.where(frozen, 0.0, -gi / wi)
        tau = jnp.where(d > 0, (ui - ci) / jnp.where(d > 0, d, 1.0),
                        jnp.where(d < 0, (li - ci) / jnp.where(d < 0, d, 1.0),
                                  0.0))
        r = jnp.asarray(radius[i])
        t = jx_tr._t_star_bisect(tau, wi * d * d, r * r)
        out.append(0.0 if (radius[i] <= 0 or not np.any(gi * gi != 0))
                   else float(t))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("case", CASES)
def test_knot_search_matches_the_jax_bisection(case, bounds):
    args = case_inputs(case, bounds, seed=10 + CASES.index(case))
    t = torch_args(args)
    t_star = trs.tr_search_plain(trs.tr_prologue_plain(*t[:5]), t[5])
    np.testing.assert_allclose(t_star.numpy(), jax_t_star(args), rtol=RTOL,
                               atol=1e-7)
    if case == "beyond_every_knot":  # every moving component at a bound
        p = trs.tr_prologue_plain(*t[:5])
        np.testing.assert_array_equal(t_star.numpy(), p.tau_max.numpy())


def test_a_negative_zero_knot_is_positive_zero():
    args = case_inputs("negative_zero_tau", "shared", seed=3)
    c, g, lower, upper, weight, _ = torch_args(args)
    raw = (lower - c) / (-g / weight)  # the knot as the formula gives it
    assert torch.all(torch.signbit(raw[:, 7]))
    p = trs.tr_prologue_plain(c, g, lower, upper, weight)
    assert not torch.any(torch.signbit(p.tau))
    assert torch.all(p.tau[:, 7] == 0.0)


def eager_t_star(c, g, lower, upper, weight, radius):
    """The previous release's eager f32 route to t*
    (trust_region._exact_trust_region and _t_star_bisect before the
    kernels), f32 sums throughout."""
    frozen = ((c >= upper) & (g <= 0.0)) | ((c <= lower) & (g >= 0.0))
    direction = torch.where(frozen, 0.0, -g / weight)
    tau = torch.where(
        direction > 0,
        (upper - c) / torch.where(direction > 0, direction, 1.0),
        torch.where(direction < 0,
                    (lower - c) / torch.where(direction < 0, direction, 1.0),
                    0.0))
    a = weight * direction * direction
    target_r2 = radius * radius
    tau = torch.clamp_min(tau, 0.0)
    finite = torch.isfinite(tau)
    a_tau2 = torch.where(finite, a * tau * tau, 0.0)
    a_total = torch.sum(a, dim=-1)
    a_finite_total = torch.sum(torch.where(finite, a, 0.0), dim=-1)
    s_total = torch.sum(a_tau2, dim=-1)
    h_infinite = a_total - a_finite_total
    tau_max = torch.clamp_min(
        torch.amax(torch.where(finite, tau, 0.0), dim=-1), 0.0)

    def r2_parts(t):
        clamped = finite & (tau <= t[:, None])
        s = torch.sum(torch.where(clamped, a_tau2, 0.0), dim=-1)
        h = a_total - torch.sum(torch.where(clamped, a, 0.0), dim=-1)
        return s, h

    lo = torch.zeros_like(tau_max, dtype=torch.int32)
    hi = tau_max.contiguous().view(torch.int32)
    for _ in range(31):
        mid = lo + ((hi - lo + 1) >> 1)
        t = mid.view(torch.float32)
        s, h = r2_parts(t)
        below = s + t * t * h < target_r2
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    low_before, high_before = r2_parts(lo.view(torch.float32))
    any_hit = s_total + tau_max * tau_max * h_infinite >= target_r2
    t_interior = torch.sqrt(torch.clamp_min(target_r2 - low_before, 0.0)
                            / torch.where(high_before > 0, high_before, 1.0))
    t_beyond = torch.where(
        h_infinite > 0,
        torch.sqrt(torch.clamp_min(target_r2 - s_total, 0.0)
                   / torch.where(h_infinite > 0, h_infinite, 1.0)),
        tau_max)
    t_star = torch.where(any_hit, t_interior, t_beyond)
    degenerate = (radius <= 0.0) | (torch.sum(g * g, dim=-1) == 0.0)
    return torch.where(degenerate, 0.0, t_star)


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("case", EXACT_CASES)
def test_plain_versions_give_the_eager_t_star_where_sums_are_exact(case,
                                                                   bounds):
    """Every term is a small integer and every row's sum below 2^24 (the
    module's note), so no sum lies near a rounding midpoint: the f64
    sums rounded to f32 are the eager f32 sums, and t* and the solution
    are the previous release's bits."""
    args = torch_args(exact_inputs(case, bounds, seed=EXACT_CASES.index(case)))
    p = trs.tr_prologue_plain(*args[:5])
    assert float(torch.max(torch.sum(p.a, dim=-1))) < 2 ** 24
    assert float(torch.max(p.s_total)) < 2 ** 24
    t_star = trs.tr_search_plain(p, args[5])
    want = eager_t_star(*args)
    assert torch.equal(t_star.view(torch.int32), want.view(torch.int32))
    solution, _, _ = trs.tr_solution_plain(*args[:5], t_star, 7)
    direction = torch.where(
        ((args[0] >= args[3]) & (args[1] <= 0.0))
        | ((args[0] <= args[2]) & (args[1] >= 0.0)),
        0.0, -args[1] / args[4])
    eager_solution = torch.clamp(args[0] + want[:, None] * direction,
                                 args[2], args[3])
    assert torch.equal(solution.view(torch.int32),
                       eager_solution.view(torch.int32))


@pytest.mark.parametrize("split", [0, 1, 150, 399, 400])
def test_solution_parts_are_the_value_split(split):
    args = torch_args(case_inputs("mixed", "rows", seed=5))
    t_star = trs.tr_search_plain(trs.tr_prologue_plain(*args[:5]), args[5])
    solution, parts, value = trs.tr_solution_plain(*args[:5], t_star, split)
    terms = (args[1] * (solution - args[0])).double()
    np.testing.assert_array_equal(
        parts.numpy(),
        torch.stack([terms[:, :split].sum(-1), terms[:, split:].sum(-1)],
                    -1).float().numpy())
    np.testing.assert_array_equal(value.numpy(),
                                  terms.sum(-1).float().numpy())
    # every term is g (x - c) <= 0: x moves against g
    assert torch.all(terms <= 0)
    got = tx_tr.solve_bound_constrained_trust_region(*args, split=split)
    assert torch.equal(got.parts, parts) and torch.equal(got.value, value)


def test_one_row_and_no_split():
    args = case_inputs("mixed", "shared", rows=1, seed=6)
    t = torch_args(args)
    whole = tx_tr.solve_bound_constrained_trust_region(*t)
    assert whole.parts is None
    one = tx_tr.solve_bound_constrained_trust_region(
        t[0][0], t[1][0], *t[2:5], float(args[5][0]), split=100)
    assert torch.equal(one.solution, whole.solution[0])
    assert torch.equal(one.value, whole.value[0])
    assert one.parts.shape == (2,)


def test_f64_and_approximate_routes_return_no_parts():
    """Without a split no route returns parts; with one, the f64 exact
    and the approximate routes return the sums of g (solution - c) over
    the two slices, as the f32 route does."""
    args = [torch.as_tensor(v, dtype=torch.float64)
            for v in case_inputs("mixed", "shared", seed=7)]
    f32 = torch_args(case_inputs("mixed", "shared", seed=7))
    for inputs, approx in ((args, False), (args, True), (f32, True)):
        assert tx_tr.solve_bound_constrained_trust_region(
            *inputs, solve_approximately=approx).parts is None
        got = tx_tr.solve_bound_constrained_trust_region(
            *inputs, solve_approximately=approx, split=10)
        terms = inputs[1] * (got.solution - inputs[0])
        assert torch.equal(got.parts, torch.stack(
            [terms[:, :10].sum(-1), terms[:, 10:].sum(-1)], -1))


def lp_bundles(nodes=300):
    want = jx_dev.to_device_scaled(
        jx.rescale_problem(3, True, 1.0, 0, jx_pagerank(nodes, seed=0)),
        jnp.float32, "dense")
    got = tx_dev.to_device_scaled(
        tx.rescale_problem(3, True, 1.0, 0, generate_pagerank_lp(nodes,
                                                                 seed=0)),
        torch.float32, "dense", CPU)
    return want, got


@pytest.mark.parametrize("radii", [(0.0, 0.3, 2.0), (1e-3, 1e-1, 1e3)])
def test_euclidean_batched_bounds_match_the_jax_package(radii):
    """Lower and upper values from the split sums (the dual part is the
    negation of the dual bound's terms) against the JAX package's f32
    bound_optimal_objective_euclidean_batched, and against the sums over
    the solution's slices that the port took before."""
    want, got = lp_bundles()
    n, m = got.scaled.num_variables, got.scaled.num_constraints
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, n)).astype(np.float32)
    y = np.abs(rng.normal(size=(3, m))).astype(np.float32)
    pw = rng.uniform(0.5, 2.0, n).astype(np.float32)
    dw = rng.uniform(0.5, 2.0, m).astype(np.float32)
    r = np.asarray(radii, np.float32)
    bw = jx_tr.bound_optimal_objective_euclidean_batched(
        want.scaled, jnp.asarray(x), jnp.asarray(y), jnp.asarray(pw),
        jnp.asarray(dw), jnp.asarray(r))
    tt = [torch.as_tensor(v) for v in (x, y, pw, dw, r)]
    bg = tx_tr.bound_optimal_objective_euclidean_batched(got.scaled, *tt)
    scale = float(np.max(np.abs(np.asarray(bw.lagrangian_value)))) + 1.0
    for a, b in zip(bg, bw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL * scale)
    # the slice sums of the previous release, on this solve's solution
    qx = torch.stack([got.scaled.qx(v) for v in tt[0]])
    aty = torch.stack([got.scaled.aty(v) for v in tt[1]])
    ax = torch.stack([got.scaled.ax(v) for v in tt[0]])
    pg = qx + got.scaled.objective_vector[None, :] - aty
    dg = got.scaled.right_hand_side[None, :] - ax
    dual_lb = torch.where(got.scaled.is_equality, -torch.inf, 0.0).float()
    res = tx_tr.solve_bound_constrained_trust_region(
        torch.cat(tt[:2], 1), torch.cat([pg, -dg], 1),
        torch.cat([got.scaled.variable_lower_bound, dual_lb]),
        torch.cat([got.scaled.variable_upper_bound,
                   torch.full((m,), torch.inf)]),
        torch.cat(tt[2:4]), tt[4])
    lower = bg.lagrangian_value + torch.sum(
        (res.solution[:, :n] - tt[0]) * pg, dim=1)
    upper = bg.lagrangian_value + torch.sum(
        (res.solution[:, n:] - tt[1]) * dg, dim=1)
    slice_scale = 2 * scale
    np.testing.assert_allclose(bg.lower_bound_value.numpy(), lower.numpy(),
                               rtol=RTOL, atol=RTOL * slice_scale)
    np.testing.assert_allclose(bg.upper_bound_value.numpy(), upper.numpy(),
                               rtol=RTOL, atol=RTOL * slice_scale)


@pytest.mark.parametrize("dtype,approx", [
    (torch.float64, False), (torch.float64, True), (torch.float32, True)])
def test_other_routes_give_the_previous_slice_sums(dtype, approx):
    """The f64 exact and the approximate routes' lower and upper values,
    now taken from the solve's split sums, are bitwise the previous
    release's sums over the solution's primal and dual slices: the terms
    are the same products, and the dual one's negation is exact."""
    got = tx_dev.to_device_scaled(
        tx.rescale_problem(3, True, 1.0, 0, generate_pagerank_lp(300,
                                                                 seed=0)),
        dtype, "dense", CPU).scaled
    n, m = got.num_variables, got.num_constraints
    rng = np.random.default_rng(12)
    x, y, pw, dw, r = (torch.as_tensor(v, dtype=dtype) for v in (
        rng.normal(size=(3, n)), np.abs(rng.normal(size=(3, m))),
        rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, m),
        np.array([0.0, 0.3, 2.0])))
    bounds = tx_tr.bound_optimal_objective_euclidean_batched(
        got, x, y, pw, dw, r, approx)
    pg = (torch.stack([got.qx(v) for v in x]) + got.objective_vector[None]
          - torch.stack([got.aty(v) for v in y]))
    dg = got.right_hand_side[None] - torch.stack([got.ax(v) for v in x])
    res = tx_tr.solve_bound_constrained_trust_region(
        torch.cat([x, y], 1), torch.cat([pg, -dg], 1),
        torch.cat([got.variable_lower_bound,
                   torch.where(got.is_equality, -torch.inf, 0.0).to(dtype)]),
        torch.cat([got.variable_upper_bound,
                   torch.full((m,), torch.inf, dtype=dtype)]),
        torch.cat([pw, dw]), r, approx)
    lagrangian = bounds.lagrangian_value
    assert torch.equal(bounds.lower_bound_value, lagrangian + torch.sum(
        (res.solution[:, :n] - x) * pg, dim=1))
    assert torch.equal(bounds.upper_bound_value, lagrangian + torch.sum(
        (res.solution[:, n:] - y) * dg, dim=1))


@pytest.mark.parametrize("approx", [False, True])
def test_lane_bounds_give_the_previous_slice_sums(monkeypatch, approx):
    """An f64 fleet's lane_euclidean_bounds at two points of every lane,
    exact and approximate: the lower and upper values from the split
    sums are bitwise the previous release's sums over the solution's
    slices, against the primal gradient and b - A x."""
    from firstorderlp_torch import batch
    from firstorderlp_torch.saddle_point import compute_dual_gradient

    from test_torch_batch import fleet_pdhg_params, pagerank_fleet, port_fleet
    from utils import optimality_criteria

    problem = port_fleet(fleet_pdhg_params(optimality_criteria(1e-6)),
                         pagerank_fleet()).bundle.scaled
    n, lanes = problem.objective_vector.shape
    m = problem.right_hand_side.shape[0]
    rng = np.random.default_rng(13)

    assert problem.objective_vector.dtype == torch.float64

    def lane_tensor(v):
        return torch.as_tensor(v, dtype=torch.float64)

    points = [(lane_tensor(rng.normal(size=(n, lanes))),
               lane_tensor(np.abs(rng.normal(size=(m, lanes)))),
               lane_tensor(rng.uniform(0.1, 2.0, lanes))) for _ in range(2)]
    weights = (lane_tensor(rng.uniform(0.5, 2.0, (n, lanes))),
               lane_tensor(rng.uniform(0.5, 2.0, (m, lanes))))
    solves = []

    def keep(*args, **kwargs):
        solves.append(tx_tr.solve_bound_constrained_trust_region(*args,
                                                                  **kwargs))
        return solves[-1]

    monkeypatch.setattr(batch, "solve_bound_constrained_trust_region", keep)
    bounds = batch.lane_euclidean_bounds(problem, points, *weights,
                                         solve_approximately=approx)
    for i, ((x, y, _), got) in enumerate(zip(points, bounds)):
        sol = solves[0].solution[i * lanes:(i + 1) * lanes]
        _, ax, pg, lagrangian = batch._lp_parts(problem, x, y)
        dual_gradient = compute_dual_gradient(problem, x, ax)
        assert torch.equal(got.lower_bound_value, lagrangian + torch.sum(
            (sol[:, :n] - x.T) * pg.T, dim=1))
        assert torch.equal(got.upper_bound_value, lagrangian + torch.sum(
            (sol[:, n:] - y.T) * dual_gradient.T, dim=1))


def test_the_cpu_route_launches_nothing():
    routed.reset_launch_counts()
    args = torch_args(case_inputs("mixed", "rows", seed=8))
    tx_tr.solve_bound_constrained_trust_region(*args, split=5)
    assert not any(routed.LAUNCHES.values())


def plan(cluster, smem_bytes):
    return trs.SearchPlan(cluster, smem_bytes)


@pytest.mark.parametrize("rows,n,max_cluster,want", [
    (3, 200_001, 16, plan(16, 8 * 12_501)),  # 100k nodes
    (3, 200_001, 8, plan(8, 8 * 25_001)),
    (384, 40_001, 16, plan(2, 8 * 20_001)),  # the fleet
    (384, 40_001, 8, plan(2, 8 * 20_001)),
    (2, 250_000, 16, plan(16, 8 * 15_625)),  # past 8 blocks' stage
    (2, 250_000, 8, trs.WHOLE_CARD),
    (1, 436_224, 16, plan(16, 8 * 27_264)),  # 16 full slices
    (1, 436_225, 16, trs.WHOLE_CARD),
    (2, 50, 16, plan(16, 8 * 4)),
    (2, 50, 8, plan(8, 8 * 7)),
    (3, 2_000_001, 16, trs.WHOLE_CARD),  # 1M nodes
    (3, 2_000_001, 8, trs.WHOLE_CARD),
    (1, 0, 16, plan(16, 0)),
])
def test_search_plans(rows, n, max_cluster, want):
    """F2b's plan: a cluster that stages the whole row where one can
    (the fewest blocks that hold it, raised towards TARGET_BLOCKS), else
    the whole-card path, chosen by the row's length alone."""
    got = trs.search_plan(rows, n, max_cluster)
    assert got == want
    if got != trs.WHOLE_CARD:
        assert got.smem_bytes <= trs.STAGE_BYTES
        assert got.cluster * got.smem_bytes >= 8 * n
        assert 1 <= got.cluster <= max_cluster <= trs.WIDE_CLUSTER
    else:
        assert 8 * n > max_cluster * trs.STAGE_BYTES
    blocks = trs.solution_blocks(rows, n, 132, 3)
    assert 1 <= blocks and (blocks - 1) * trs.SOLUTION_THREADS < max(n, 1)
    assert trs.SEARCH_TRIPS == -(-trs.KNOT_TRIPS // trs.SEARCH_BITS)
    # the search's constants are the kernel's
    import os
    import re

    from firstorderlp_torch.ops import kernels_build

    with open(os.path.join(kernels_build.CSRC_DIR,
                           "trust_region_search.cu")) as f:
        source = f.read()
    for name, value in (("kSearchBits", trs.SEARCH_BITS),
                        ("kSearchThreads", trs.SEARCH_THREADS),
                        ("kSolutionThreads", trs.SOLUTION_THREADS),
                        ("kSweepThreads", trs.SWEEP_THREADS),
                        ("kSweepValues", trs.SWEEP_VALUES),
                        ("kSweepRowDoubles", trs.SWEEP_ROW_DOUBLES)):
        assert re.search(rf"constexpr int {name} = {value};", source), name


@pytest.mark.parametrize("rows,n,sms,depth,want", [
    (3, 200_001, 132, 3, 132),  # the main path: one wave of 3 x 132
    (384, 40_001, 132, 3, 2),  # the fleet
    (1, 300_000, 132, 3, 293),  # a long row: a block a 256-slot run
    (3, 200_001, 114, 3, 114),  # a card of 114 SMs
    (3, 200_001, 132, 4, 176),  # an SM that holds 4 blocks
    (3, 2_000_001, 132, 3, 132),  # 1M nodes
    (2, 50, 132, 3, 1),
    (1, 0, 132, 3, 1),
    (65_535, 10, 132, 3, 1),
])
def test_solution_blocks(rows, n, sms, depth, want):
    """F2c's grid: one wave (the blocks the card's SMs hold at once) over
    all rows, at most one block a run of SOLUTION_THREADS slots of a row,
    at least one."""
    assert trs.solution_blocks(rows, n, sms, depth) == want
    assert trs.solution_blocks(rows, n, sms, 2 * depth) >= want


@pytest.mark.parametrize("n,blocks", [(0, 1), (1, 1), (7, 1), (1_029, 2),
                                      (200_001, 132), (40_001, 2),
                                      (300_000, 293), (10, 6)])
def test_solution_runs_cover_every_slot_once(n, blocks):
    """A model of tr_solution_kernel's indexing: block b of a row takes
    slots [b per, (b + 1) per) of the row's ceil(n / 4) (per = ceil(slots
    / blocks)), thread i the slots i, i + T, ... of its run; each entry
    below n is one thread's, and no thread takes more than ceil(per / T)
    slots."""
    slots = -(-n // 4)
    per = -(-slots // blocks)
    seen = []
    for b in range(blocks):
        begin, end = b * per, min(b * per + per, slots)
        for i in range(trs.SOLUTION_THREADS):
            mine = list(range(begin + i, end, trs.SOLUTION_THREADS))
            assert len(mine) <= -(-per // trs.SOLUTION_THREADS)
            seen += [4 * q + k for q in mine for k in range(4)
                     if 4 * q + k < n]
    assert sorted(seen) == list(range(n))


def heap_points(lo, hi, bits):
    """The test points of the bisection's next `bits` levels from
    [lo, hi] in heap order (node i's children 2i, below its point, and
    2i + 1, from its point up), as the kernel's node_point gives them."""
    points = []
    for node in range(1, 2 ** bits):
        a, b = lo, hi
        for bit in bin(node)[3:]:
            mid = a + ((b - a + 1) >> 1)
            a, b = (mid, b) if bit == "1" else (a, mid - 1)
        points.append(a + ((b - a + 1) >> 1))
    return points


def k_way_t_star(p, radius, bits):
    """A torch model of tr_search's K-way search (K = 2^bits - 1) with
    the plain version's f64 sums: ceil(31 / bits) trips, each testing the
    K heap points at once, then walking down their answers; S and H at
    the final lo are those of the last point the walk went above, or
    S(+0) and H(+0); t* from them as the plain version's tail."""
    target = radius * radius
    lo = torch.zeros_like(p.tau_max, dtype=torch.int32)
    hi = p.tau_max.contiguous().view(torch.int32)
    s_lo, h_lo = trs._r2_parts(p, torch.zeros_like(p.tau_max))
    rows = torch.arange(lo.shape[0])
    for _ in range(-(-trs.KNOT_TRIPS // bits)):
        points = heap_points(lo, hi, bits)
        sums = [trs._r2_parts(p, q.view(torch.float32)) for q in points]
        s = torch.stack([s for s, _ in sums])
        h = torch.stack([h for _, h in sums])
        t = torch.stack(points).view(torch.float32)
        below = s + t * t * h < target
        node = torch.ones_like(lo, dtype=torch.int64)
        for _ in range(bits):
            mid = lo + ((hi - lo + 1) >> 1)
            up = below[node - 1, rows]
            s_lo = torch.where(up, s[node - 1, rows], s_lo)
            h_lo = torch.where(up, h[node - 1, rows], h_lo)
            lo = torch.where(up, mid, lo)
            hi = torch.where(up, hi, mid - 1)
            node = 2 * node + up.long()
    return trs.t_star_from(p, radius, s_lo, h_lo)


def repeated_knot_rows(seed, rows=6, n=300):
    """Rows whose knots repeat (bounds and steps from small sets), with
    frozen components (+0 knots), infinite bounds and radii from 0 to
    past every knot."""
    rng = np.random.default_rng(seed)
    lower = -rng.choice([0.5, 1.0, 2.0, np.inf], (rows, n))
    upper = rng.choice([0.5, 1.0, 2.0, np.inf], (rows, n))
    c = np.where(rng.random((rows, n)) < 0.2, lower, 0.0)
    c = np.where(np.isinf(c), 0.0, c)
    g = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], (rows, n))
    weight = rng.choice([0.5, 1.0, 2.0], (rows, n))
    radius = np.concatenate([[0.0, 1e-6], rng.uniform(0.01, 30.0, rows - 3),
                             [1e6]])
    return [torch.as_tensor(np.asarray(v, np.float32))
            for v in (c, g, lower, upper, weight, radius)]


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("inputs", ["cases", "repeated_knots"])
def test_k_way_search_gives_the_bisection_bits(inputs):
    """The kernel's search (SEARCH_BITS levels a trip), modelled with
    the plain version's sums, ends on the bisection's lo with its S and
    H, so t* is tr_search_plain's bit for bit: on every case of
    tests/trust_region_cases.py with both bound shapes, and on seeded
    rows with repeated knots, +0 knots and infinite bounds."""
    if inputs == "cases":
        rows = [torch_args(case_inputs(case, bounds,
                                       seed=20 + CASES.index(case)))
                for case in CASES for bounds in BOUNDS]
    else:
        rows = [repeated_knot_rows(seed) for seed in range(8)]
    for args in rows:
        p = trs.tr_prologue_plain(*args[:5])
        assert same_bits(k_way_t_star(p, args[5], trs.SEARCH_BITS),
                         trs.tr_search_plain(p, args[5]))


@pytest.mark.parametrize("rows,n,sms,depth,want", [
    (3, 2_000_001, 132, 3, 132),  # 1M nodes: one wave of 3 x 132
    (3, 2_000_001, 132, 2, 88),
    (1, 500_000, 132, 3, 396),
    (3, 200_001, 132, 3, 132),
    (384, 40_001, 132, 3, 2),
    (2, 50, 132, 3, 1),
    (1, 0, 132, 3, 1),
])
def test_sweep_blocks(rows, n, sms, depth, want):
    """The whole-card path's grid: one wave of SWEEP_THREADS-thread
    blocks over all rows, at most one block a run of SWEEP_THREADS slots
    of a row, at least one."""
    assert trs.sweep_blocks(rows, n, sms, depth) == want


def sweep_runs(n, blocks):
    """A model of csrc warp_run: the whole-card path's warp runs of a row
    of `n` entries, block by block and warp by warp, [begin, end) in
    entries (the row's ceil(n / 4) slots cut into `blocks` runs, each
    into SWEEP_WARPS); a warp's list of live knots starts at its
    `begin`."""
    slots = -(-n // 4)
    per_block = -(-slots // blocks)
    per_warp = -(-per_block // trs.SWEEP_WARPS)
    runs = []
    for b in range(blocks):
        run, run_end = b * per_block, min(b * per_block + per_block, slots)
        for w in range(trs.SWEEP_WARPS):
            end = min(run + (w + 1) * per_warp, run_end)
            begin = min(run + w * per_warp, end)
            runs.append((min(4 * begin, n), min(4 * end, n)))
    return runs


@pytest.mark.parametrize("n,blocks", [(0, 1), (1, 1), (7, 1), (401, 1),
                                      (2_000, 3), (4_099, 5), (300, 40),
                                      (2_000_001, 132)])
def test_sweep_runs_cover_every_entry_once(n, blocks):
    """The whole-card path's warp runs (csrc warp_run): in order, each
    entry below n in exactly one run, every run inside its block's run of
    ceil(ceil(n / 4) / blocks) slots and starting on a 16-byte slot."""
    runs = sweep_runs(n, blocks)
    assert len(runs) == blocks * trs.SWEEP_WARPS
    per_block = 4 * -(-(-(-n // 4)) // blocks)
    seen = 0
    for i, (begin, end) in enumerate(runs):
        assert begin == seen or begin == end, (i, begin, seen)
        assert begin % 4 == 0 or begin == n
        b = i // trs.SWEEP_WARPS
        assert b * per_block <= begin or begin == end
        assert end <= min((b + 1) * per_block, n)
        seen = max(seen, end)
    assert seen == n
    assert sum(end - begin for begin, end in runs) == n


def _bits(v: int) -> torch.Tensor:
    """The f32 whose bits are the int32 `v`."""
    return torch.tensor(v, dtype=torch.int32).view(torch.float32)


def whole_card_t_star(p, radius, n, blocks, bits=trs.SEARCH_BITS):
    """A torch model of the whole-card path, row by row: each warp's list
    holds the live knots (finite, > 0) of its run (sweep_runs) in
    column order; the base sums start from the knots no list holds (the
    +0 ones in S, the others in H). Each trip tests the K heap points of
    the bracket: every warp folds the knots at or below lo into the
    fold's S and those above hi into its H and keeps the rest, in order;
    S and H of a point are the base, with the fold added, plus the kept
    knots' parts; then the walk down the K answers, as k_way_t_star's.
    f64 sums, rounded once; t* from the plain version's tail."""
    rows = p.tau.shape[0]
    runs = sweep_runs(n, blocks)
    s_lo_all, h_lo_all = trs._r2_parts(p, torch.zeros_like(p.tau_max))
    s_lo_all, h_lo_all = s_lo_all.clone(), h_lo_all.clone()
    target = radius * radius
    for r in range(rows):
        tau, a = p.tau[r], p.a[r]
        clamped = a * tau * tau
        live = torch.isfinite(tau) & (tau > 0)
        lists = [torch.arange(b, e)[live[b:e]] for b, e in runs]
        base_s = torch.sum(clamped[tau <= 0], dtype=torch.float64)
        base_h = torch.sum(a[~torch.isfinite(tau)], dtype=torch.float64)
        lo, hi = 0, int(p.tau_max[r].view(torch.int32))
        for _ in range(-(-trs.KNOT_TRIPS // bits)):
            t = torch.tensor(heap_points(lo, hi, bits),
                             dtype=torch.int32).view(torch.float32)
            lo_t, hi_t = _bits(lo), _bits(hi)
            live_s = torch.zeros(len(t), dtype=torch.float64)
            live_h = torch.zeros(len(t), dtype=torch.float64)
            kept = []
            for idx in lists:
                knot = tau[idx]
                down = knot <= lo_t
                up = ~(knot <= hi_t) & ~down
                base_s = base_s + torch.sum(clamped[idx][down],
                                            dtype=torch.float64)
                base_h = base_h + torch.sum(a[idx][up], dtype=torch.float64)
                idx = idx[~down & ~up]
                under = tau[idx][None, :] <= t[:, None]
                live_s += torch.sum(torch.where(under, clamped[idx], 0.0),
                                    dim=1, dtype=torch.float64)
                live_h += torch.sum(torch.where(under, 0.0, a[idx]), dim=1,
                                    dtype=torch.float64)
                kept.append(idx)
            lists = kept
            s = (base_s + live_s).to(torch.float32)
            h = (base_h + live_h).to(torch.float32)
            below = s + t * t * h < target[r]
            node = 1
            for _ in range(bits):
                mid = lo + ((hi - lo + 1) >> 1)
                up = bool(below[node - 1])
                if up:
                    lo = mid
                    s_lo_all[r], h_lo_all[r] = s[node - 1], h[node - 1]
                else:
                    hi = mid - 1
                node = 2 * node + up
    return trs.t_star_from(p, radius, s_lo_all, h_lo_all)


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("inputs", ["cases", "repeated_knots", "edges"])
def test_whole_card_path_gives_the_bisection_bits(inputs, blocks):
    """The whole-card path (per-warp lists of the live knots, the fold of
    the knots that leave the bracket, the last block's walk), modelled
    with the plain version's sums at 1 and 3 blocks a row, gives
    tr_search_plain's t* bit for bit: on every case of
    tests/trust_region_cases.py with both bound shapes, on rows with
    repeated knots, and on rows with no live knot, a zero radius, g = 0
    and NaN inputs."""
    if inputs == "cases":
        rows = [torch_args(case_inputs(case, bounds,
                                       seed=30 + CASES.index(case)))
                for case in CASES for bounds in BOUNDS]
    elif inputs == "repeated_knots":
        rows = [repeated_knot_rows(seed) for seed in range(4)]
    else:
        rows = [torch_args(args) for args in tc.edge_inputs()]
    for args in rows:
        p = trs.tr_prologue_plain(*args[:5])
        n = args[0].shape[1]
        got = whole_card_t_star(p, args[5], n, blocks)
        want = trs.tr_search_plain(p, args[5])
        assert same_bits(got, want), (got, want)


def test_bound_strides_copy_only_what_the_kernel_cannot_read():
    """The kernels read every input through a row and a column stride,
    so nothing is copied: a shared (N,) vector, a (B, N) one, an
    expanded vector and a fleet's transposed (n, B) state."""
    rows, n = 3, 10
    shared = torch.zeros(n)
    assert trs._strided("lower", shared, rows, n) == (shared, 0, 1)
    full = torch.zeros(rows, n)
    assert trs._strided("lower", full, rows, n) == (full, n, 1)
    expanded = shared.expand(rows, n)
    assert trs._strided("lower", expanded, rows, n) == (expanded, 0, 1)
    transposed = torch.zeros(n, rows).T
    for name in ("c", "weight"):
        got = trs._strided(name, transposed, rows, n)
        assert got[0] is transposed and got[1:] == (1, rows)
    with pytest.raises(ValueError):
        trs._strided("lower", torch.zeros(n + 1), rows, n)
    with pytest.raises(ValueError):
        trs._strided("c", shared, rows, n)  # c and g are (B, N)
    with pytest.raises(TypeError):
        trs._strided("lower", torch.zeros(n, dtype=torch.float64), rows, n)


def test_wrappers_refuse_other_devices():
    args = [t.to("meta") for t in torch_args(case_inputs("mixed", seed=9))]
    with pytest.raises(ValueError):
        trs.tr_search(*args)
    t_star = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        trs.tr_solution(*args[:5], t_star, 10)
    mixed = torch_args(case_inputs("mixed", seed=9))
    mixed[5] = mixed[5].to("meta")
    with pytest.raises(ValueError):
        trs.tr_search(*mixed)


def test_argument_struct_matches_the_c_struct():
    """The ctypes TrustRegionArgs has csrc/trust_region_search.cu's
    members, in order and of the same kind (a pointer or an int)."""
    import ctypes

    from test_torch_kernels_build import c_struct_fields

    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i"}
    assert [(n, kind[t]) for n, t in trs._TrustRegionArgs._fields_] == (
        c_struct_fields("TrustRegionArgs"))


@pytest.mark.parametrize("bounds", BOUNDS)
@pytest.mark.parametrize("max_rows,chunks", [
    (3, [(0, 3), (3, 6), (6, 7)]), (7, [(0, 7)]), (1, None)])
def test_calls_past_a_launchs_rows_run_in_chunks(monkeypatch, bounds,
                                                 max_rows, chunks):
    """With MAX_ROWS cut to `max_rows`, a call of 7 rows runs its rows in
    row_chunks' chunks (one launch each on the card; the plain versions
    here, through the same loop), and tr_search and tr_solution give the
    rows of one call bitwise; (N,) bounds reach every chunk whole."""
    c, g, lower, upper, weight, radius = torch_args(
        case_inputs("mixed", bounds, rows=7, n=50, seed=3))
    want_t = trs.tr_search(c, g, lower, upper, weight, radius)
    want = trs.tr_solution(c, g, lower, upper, weight, want_t, 20)
    monkeypatch.setattr(trs, "MAX_ROWS", max_rows)
    got_chunks = []
    for lo, hi, inputs, (r,) in trs.row_chunks(7, c, g, lower, upper,
                                               weight, radius):
        got_chunks.append((lo, hi))
        assert inputs[0].shape == (hi - lo, 50) and r.shape == (hi - lo,)
        assert inputs[2].shape == ((50,) if bounds == "shared"
                                   else (hi - lo, 50))
    assert got_chunks == (chunks or [(i, i + 1) for i in range(7)])
    got_t = trs.tr_search(c, g, lower, upper, weight, radius)
    got = trs.tr_solution(c, g, lower, upper, weight, got_t, 20)
    assert same_bits(got_t, want_t)
    for u, v in zip(got, want):
        assert same_bits(u, v)


def test_an_empty_call_is_one_chunk_of_no_rows():
    c = torch.zeros(0, 5)
    bounds = torch.zeros(5)
    assert [(lo, hi) for lo, hi, _, _ in trs.row_chunks(
        0, c, c, bounds, bounds, bounds)] == [(0, 0)]
    assert trs.tr_search(c, c, bounds, bounds, bounds,
                         torch.zeros(0)).shape == (0,)
