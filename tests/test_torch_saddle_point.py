"""The port's public saddle-point helpers against the JAX package's, in
f64 at rtol 1e-12, on the fixtures: compute_average,
compute_localized_duality_gap(s), compute_primal_gradient(
_from_dual_product), compute_dual_gradient, compute_lagrangian_value
(with tests/test_saddle_point.py::test_compute_lagrangian_value's
cases) and select_initial_primal_weight (with
tests/test_saddle_point.py::test_select_initial_primal_weight's cases);
the fleet's (n, B) vectors give each lane's single value."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu import saddle_point as jx_sp
from firstorderlp_tpu.ops import device_problem as jx_dev

import firstorderlp_torch as tx
from firstorderlp_torch import saddle_point as tx_sp
from firstorderlp_torch.convert import problem_from_arrays
from firstorderlp_torch.ops import device_problem as tx_dev

import fixtures

RTOL = 1e-12
CPU = torch.device("cpu")
FIXTURES = ["example_lp", "example_qp", "example_qp2", "example_cc_lp",
            "example_lp_without_bounds", "example_lp_dependent_rows"]


def port_problem(p):
    return problem_from_arrays(
        p.variable_lower_bound, p.variable_upper_bound, p.objective_matrix,
        p.objective_vector, p.objective_constant, p.constraint_matrix,
        p.right_hand_side, p.num_equalities,
    )


def problems(name, fmt="ell"):
    """The fixture's scaled problem on each package's device."""
    p = getattr(fixtures, name)()
    want = jx_dev.to_device_scaled(
        jx.rescale_problem(3, True, 1.0, 0, p), jnp.float64, fmt
    )
    got = tx_dev.to_device_scaled(
        tx.rescale_problem(3, True, 1.0, 0, port_problem(p)),
        torch.float64, fmt, CPU,
    )
    return want.scaled, got.scaled


def point(problem, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=problem.num_variables),
            np.abs(rng.normal(size=problem.num_constraints)))


def t(v):
    return torch.as_tensor(np.array(v, np.float64))


def close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=RTOL, atol=1e-14,
    )


@pytest.mark.parametrize("fmt", ["ell", "dense"])
@pytest.mark.parametrize("name", FIXTURES)
def test_gradients_and_lagrangian(name, fmt):
    want, got = problems(name, fmt)
    x, y = point(got, 3)
    jxx, jxy = jnp.asarray(x), jnp.asarray(y)
    close(tx_sp.compute_primal_gradient(got, t(x), t(y)),
          jx_sp.compute_primal_gradient(want, jxx, jxy))
    aty = np.asarray(want.aty(jxy))
    close(tx_sp.compute_primal_gradient_from_dual_product(got, t(x), t(aty)),
          jx_sp.compute_primal_gradient_from_dual_product(
              want, jxx, jnp.asarray(aty)))
    close(tx_sp.compute_dual_gradient(got, t(x)),
          jx_sp.compute_dual_gradient(want, jxx))
    close(tx_sp.compute_lagrangian_value(got, t(x), t(y)),
          jx_sp.compute_lagrangian_value(want, jxx, jxy))


def test_compute_lagrangian_value_reference_cases():
    """tests/test_saddle_point.py's cases, exact, in both packages."""
    lp = tx_dev.to_device(port_problem(fixtures.example_lp()), device=CPU)
    assert float(tx_sp.compute_lagrangian_value(
        lp, torch.zeros(4, dtype=torch.float64),
        torch.zeros(3, dtype=torch.float64))) == -14.0
    qp = tx_dev.to_device(port_problem(fixtures.example_qp()), device=CPU)
    for x, y, want in (([1.0, 1.0], [0.0], 0.5), ([1.0, 1.0], [1.0], 1.5),
                       ([0.25, 0.0], [0.0], -0.125)):
        assert float(tx_sp.compute_lagrangian_value(qp, t(x), t(y))) == want
        assert float(jx_sp.compute_lagrangian_value(
            jx_dev.to_device(fixtures.example_qp()), jnp.asarray(x),
            jnp.asarray(y))) == want


def _averages(want, got, seed):
    rng = np.random.default_rng(seed)
    n, m = got.num_variables, got.num_constraints
    j_avg = jx_sp.initialize_solution_weighted_average(n, m)
    t_avg = tx_sp.initialize_solution_weighted_average(
        n, m, torch.float64, CPU)
    for _ in range(3):
        x, y = rng.normal(size=n), rng.normal(size=m)
        w = rng.uniform(0.1, 2.0)
        j_avg = jx_sp.add_to_solution_weighted_average(
            j_avg, jnp.asarray(x), jnp.asarray(y), w)
        t_avg = tx_sp.add_to_solution_weighted_average(
            t_avg, t(x), t(y), torch.tensor(w, dtype=torch.float64))
    return j_avg, t_avg


@pytest.mark.parametrize("name", FIXTURES)
def test_compute_average(name):
    want, got = problems(name)
    j_avg, t_avg = _averages(want, got, 5)
    for a, b in zip(tx_sp.compute_average(t_avg),
                    jx_sp.compute_average(j_avg)):
        close(a, b)


def test_compute_average_of_an_empty_average_is_zero():
    """Where the reference divides 0 by 0, the port gives zeros (the
    restart code never reads an empty average)."""
    avg = tx_sp.initialize_solution_weighted_average(3, 2, torch.float64,
                                                     CPU)
    primal, dual = tx_sp.compute_average(avg)
    assert torch.equal(primal, torch.zeros(3, dtype=torch.float64))
    assert torch.equal(dual, torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_localized_duality_gaps(name, approximate):
    want, got = problems(name)
    n, m = got.num_variables, got.num_constraints
    x, y = point(got, 7)
    rx, ry = point(got, 8)
    ax_, ay = point(got, 9)
    pw = np.full(n, 1.3)
    dw = np.full(m, 0.7)
    j_info = jx_sp.create_last_restart_info(jnp.asarray(rx), jnp.asarray(ry))
    t_info = tx_sp.create_last_restart_info(t(rx), t(ry))

    one_w = jx_sp.compute_localized_duality_gap(
        want, jnp.asarray(x), jnp.asarray(y), jnp.asarray(pw),
        jnp.asarray(dw), 0.8, approximate)
    one_g = tx_sp.compute_localized_duality_gap(
        got, t(x), t(y), t(pw), t(dw), 0.8, approximate)
    for a, b in zip(one_g, one_w):
        close(a, b)

    gaps_w = jx_sp.compute_localized_duality_gaps(
        want, jnp.asarray(x), jnp.asarray(y), jnp.asarray(ax_),
        jnp.asarray(ay), jnp.asarray(pw), jnp.asarray(dw), j_info,
        approximate)
    gaps_g = tx_sp.compute_localized_duality_gaps(
        got, t(x), t(y), t(ax_), t(ay), t(pw), t(dw), t_info, approximate)
    assert isinstance(gaps_g, tx_sp.LocalizedDualityGaps)
    for field in ("gap_at_average", "gap_at_current"):
        for a, b in zip(getattr(gaps_g, field), getattr(gaps_w, field)):
            close(a, b)
    for field in ("distance_traveled_by_average",
                  "distance_traveled_by_current"):
        close(getattr(gaps_g, field), getattr(gaps_w, field))


@pytest.mark.parametrize("name", ["example_lp", "example_qp"])
def test_fleet_vectors_give_each_lanes_value(name):
    """(n, B) and (m, B) inputs: each lane's column is that lane's
    single-instance value (the fleet's restart code calls these)."""
    _, got = problems(name, "dense")
    xs, ys = zip(*(point(got, s) for s in range(3)))
    x2, y2 = t(np.stack(xs, 1)), t(np.stack(ys, 1))

    class Lanes:  # the scaled problem with each vector a (dim, 1) column
        objective_matrix = got.objective_matrix
        objective_vector = got.objective_vector[:, None]
        right_hand_side = got.right_hand_side[:, None]
        objective_constant = got.objective_constant

        @staticmethod
        def ax(v):
            return torch.stack([got.ax(c) for c in v.T], 1)

        @staticmethod
        def aty(v):
            return torch.stack([got.aty(c) for c in v.T], 1)

        @staticmethod
        def qx(v):
            return torch.stack([got.qx(c) for c in v.T], 1)

    lag = tx_sp.compute_lagrangian_value(Lanes, x2, y2)
    grad = tx_sp.compute_primal_gradient(Lanes, x2, y2)
    dual_grad = tx_sp.compute_dual_gradient(Lanes, x2)
    for b in range(3):
        close(lag[b], tx_sp.compute_lagrangian_value(got, x2[:, b],
                                                     y2[:, b]))
        close(grad[:, b], tx_sp.compute_primal_gradient(got, x2[:, b],
                                                        y2[:, b]))
        close(dual_grad[:, b], tx_sp.compute_dual_gradient(got, x2[:, b]))


def test_select_initial_primal_weight_reference_cases():
    """tests/test_saddle_point.py's three cases (the ratio, a zero
    objective, a zero rhs) with all-ones weights, in both packages."""
    lp1 = fixtures.example_lp()
    importance = 1.3
    lp2 = dataclasses.replace(
        lp1, objective_vector=np.zeros(lp1.num_variables))
    lp3 = dataclasses.replace(
        lp1, right_hand_side=np.zeros(lp1.num_constraints))
    ones_n, ones_m = np.ones(lp1.num_variables), np.ones(lp1.num_constraints)
    expected = (importance * np.linalg.norm(lp1.objective_vector)
                / np.linalg.norm(lp1.right_hand_side))
    for lp, want in ((lp1, expected), (lp2, importance), (lp3, importance)):
        got = tx_sp.select_initial_primal_weight(
            tx_dev.to_device(port_problem(lp), device=CPU), t(ones_n),
            t(ones_m), importance)
        ref = jx_sp.select_initial_primal_weight(
            jx_dev.to_device(lp), jnp.asarray(ones_n), jnp.asarray(ones_m),
            importance)
        close(got, want)
        close(got, ref)
    assert float(tx_sp.select_initial_primal_weight(
        tx_dev.to_device(port_problem(lp2), device=CPU), t(ones_n),
        t(ones_m), importance)) == importance


@pytest.mark.parametrize("name", FIXTURES)
def test_select_initial_primal_weight_weighted(name):
    """Weighted norms, on each fixture's scaled problem."""
    want, got = problems(name)
    rng = np.random.default_rng(7)
    wn = rng.uniform(0.5, 2.0, got.num_variables)
    wm = rng.uniform(0.5, 2.0, got.num_constraints)
    close(tx_sp.select_initial_primal_weight(got, t(wn), t(wm), 0.7),
          jx_sp.select_initial_primal_weight(want, jnp.asarray(wn),
                                             jnp.asarray(wm), 0.7))
