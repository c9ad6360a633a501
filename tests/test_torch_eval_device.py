"""The port's evaluation on the device and its multi-segment dispatch
(models/pdhg._eval_block and _run_segments, models/mirror_prox._eval_block
and _run_segments, saddle_point.run_restart_scheme) on the CPU, in f64,
against the JAX package run on the CPU, which is left as it is.

- The device _eval_block of PDHG and of Mirror Prox against the JAX
  _eval_block from the same state, every state field and every
  EvalResult field at rtol 1e-12 (normwise; counters and flags exact):
  running, terminating, already terminated, numerical error, no average
  yet, and each restart choice (no restart, weighted-average reset,
  restart to average) under every restart scheme. An evaluation reads
  nothing back.
- run_restart_scheme against the JAX one (rtol 1e-12), and against
  batch.lane_restart_scheme on a one-lane fleet, bitwise.
- A dispatch of 1, 3 and 64 segments against the JAX _run_segments: the
  same reason, iteration and KKT passes exactly; a PDHG segment with no
  rejection reads back once, its evaluation included, and a dispatch
  loads and unloads the state once.
- A solve checkpointed between dispatches and resumed gives the
  uninterrupted solve's bits.
"""

import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.models import mirror_prox as jx_mp
from firstorderlp_tpu.models import pdhg as jx_pdhg
from firstorderlp_tpu.saddle_point import run_restart_scheme as jx_restart

import firstorderlp_torch as tx
from firstorderlp_torch import batch, convert, saddle_point, spans
from firstorderlp_torch.models import mirror_prox as tx_mp
from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import graphs

import fixtures
from test_mirror_prox import mp_params
from test_torch_batch import (
    fleet_pdhg_params,
    lane_of,
    pagerank_fleet,
    single_lane_problem,
)
from test_torch_mirror_prox import port_mp_params
from test_torch_mirror_prox import xla_step_size_factors as mp_xla_factors
from test_torch_pdhg import (
    jax_config as pdhg_jax_config,
    port_params,
    port_problem,
    random_lp,
    state_leaves,
    xla_step_size_factors,
)
from utils import (
    optimality_criteria,
    pdhg_params,
    terminate_on_iteration_limit,
)

RTOL = 1e-12
RS, RM = jx.RestartScheme, jx.RestartToCurrentMetric
NO, RESET, AVERAGE = 1, 2, 3  # RestartChoice codes


# ---------------------------------------------------------------------------
# States of both packages
# ---------------------------------------------------------------------------


def restart_params(scheme, choice=None):
    """The JAX package's RestartParameters under `scheme` that make the
    evaluated states (example_lp at iteration 81, or 41 for the reset,
    where the current point is the better one) take `choice`: no
    restart (no artificial restart, a reduction no gap reaches, a fixed
    frequency far off), a weighted-average reset (an artificial restart
    at once, the current point better by the metric) or a restart to
    the average (the same, with the metric that always picks the
    average). None: the PDLP defaults."""
    metric = RM.GAP_OVER_DISTANCE_SQUARED
    frequency, threshold, sufficient, necessary = 100, 0.5, 0.1, 0.9
    if choice == NO:
        frequency, threshold, sufficient, necessary = 10**9, 1.0, 1e-9, 1e-9
    elif choice in (RESET, AVERAGE):
        threshold = 1e-9
        if choice == AVERAGE:
            metric = RM.NO_RESTART_TO_CURRENT
    return jx.construct_restart_parameters(
        scheme, metric, frequency, threshold, sufficient, necessary, 0.5,
        False)


def port_restart(rp):
    return tx.RestartParameters(**{
        **dataclasses.asdict(rp),
        "restart_scheme": tx.RestartScheme(rp.restart_scheme.value),
        "restart_to_current_metric": tx.RestartToCurrentMetric(
            rp.restart_to_current_metric.value),
    })


def jax_params(solver, limit=1000):
    criteria = terminate_on_iteration_limit(limit)
    if solver == "pdhg":
        return dataclasses.replace(
            pdhg_params(criteria, ruiz_iterations=10,
                        pock_chambolle_alpha=1.0),
            matrix_format="ell")
    return dataclasses.replace(
        mp_params(criteria, diagonal_scaling="l2", ruiz_iterations=10,
                  pock_chambolle_alpha=1.0),
        matrix_format="ell")


def jax_config(solver, params):
    if solver == "pdhg":
        return pdhg_jax_config(params)
    return jx_mp._MpConfig(
        criteria=jx_pdhg.HashableCriteria.from_criteria(
            params.termination_criteria),
        restart_params=params.restart_params,
        termination_evaluation_frequency=(
            params.termination_evaluation_frequency),
        need_bound_estimates=True,
    )


JAX_MODULE = {"pdhg": jx_pdhg, "mirror_prox": jx_mp}
PORT_MODULE = {"pdhg": tx_pdhg, "mirror_prox": tx_mp}


@functools.lru_cache(maxsize=None)
def jax_case(solver, iteration):
    """(JAX prepared, JAX state at `iteration`) of example_lp in f64, the
    segments run with the PDLP default restarts."""
    params = jax_params(solver)
    module = JAX_MODULE[solver]
    prep = module.prepare_problem(params, fixtures.example_lp())
    config = jax_config(solver, params)
    state = prep.initial_state
    while int(state.iteration) < iteration:
        state, _ = module._run_segment(
            prep.bundle, state, jnp.asarray(0.0, jnp.float64), config)
    assert int(state.iteration) == iteration
    return prep, state


def port_of(solver, params):
    """(port prepared, port config) for the JAX parameters `params`."""
    module = PORT_MODULE[solver]
    if solver == "pdhg":
        tparams = port_params(params)
    else:
        tparams = port_mp_params(params)
    prep = module.prepare_problem(tparams, port_problem(fixtures.example_lp()),
                                  device="cpu")
    return prep, module._make_config(tparams)


def to_port(solver, state):
    leaves = state_leaves(state)
    if solver == "pdhg":
        return convert.state_from_arrays(leaves, device="cpu")
    return convert.mp_state_from_arrays(leaves, device="cpu")


def flat(value, prefix=""):
    """{dotted path: array} of a state or an EvalResult of either
    package (dataclasses and named tuples walked)."""
    if dataclasses.is_dataclass(value):
        items = [(f.name, getattr(value, f.name))
                 for f in dataclasses.fields(value)]
    elif isinstance(value, tuple):
        items = list(value._asdict().items())
    else:
        return {prefix[:-1]: np.asarray(value)}
    out = {}
    for name, v in items:
        out.update(flat(v, f"{prefix}{name}."))
    return out


def assert_matches(got, want, what):
    """Every leaf of `got` (port) against `want` (JAX): integers and flags
    exactly, floats at RTOL of the leaf's largest magnitude."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name]
        if w.dtype.kind in "biu":
            assert np.array_equal(g, w), f"{what} {name}: {g} != {w}"
            continue
        nan = np.isnan(w)
        assert np.array_equal(np.isnan(g), nan), f"{what} {name}: NaN"
        g, w = g[~nan].astype(np.float64), w[~nan]
        same = g == w  # infinities too
        scale = float(np.max(np.abs(w[np.isfinite(w)]), initial=0.0))
        err = float(np.max(np.abs(g[~same] - w[~same]), initial=0.0))
        assert err <= RTOL * scale, (
            f"{what} {name}: {err:.3e} against scale {scale:.3e}")


@contextlib.contextmanager
def host_reads(monkeypatch):
    """Counts the tensor methods that bring a value to the host."""
    calls = []
    with monkeypatch.context() as m:
        for name in ("tolist", "item", "cpu", "numpy", "__bool__",
                     "__int__", "__float__", "__index__"):
            original = getattr(torch.Tensor, name)

            def counted(self, *args, _name=name, _original=original,
                        **kwargs):
                calls.append(_name)
                return _original(self, *args, **kwargs)

            m.setattr(torch.Tensor, name, counted)
        yield calls


# ---------------------------------------------------------------------------
# The evaluation against the JAX package's
# ---------------------------------------------------------------------------

# situation: (evaluated iteration, restart scheme, restart choice, edit)
SITUATIONS = {
    "running": (81, RS.ADAPTIVE_NORMALIZED, None, None),
    "terminating": (81, RS.ADAPTIVE_NORMALIZED, None, "limit"),
    "already_terminated": (81, RS.ADAPTIVE_NORMALIZED, None, "terminated"),
    "numerical_error": (81, RS.ADAPTIVE_NORMALIZED, None, "error"),
    "no_average_yet": (1, RS.ADAPTIVE_NORMALIZED, None, None),
    **{
        f"{scheme.name.lower()}-{label}": (iteration, scheme, choice, None)
        for scheme in RS
        for choice, label, iteration in ((NO, "no_restart", 81),
                                         (RESET, "reset", 41),
                                         (AVERAGE, "to_average", 81))
        # without restarts the average is never chosen
        if not (scheme == RS.NO_RESTARTS and choice == AVERAGE)
    },
}


@pytest.mark.parametrize("situation", sorted(SITUATIONS))
@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_eval_block_matches_the_jax_eval_block(solver, situation,
                                               monkeypatch):
    iteration, scheme, choice, edit = SITUATIONS[situation]
    jprep, jstate = jax_case(solver, iteration)
    params = dataclasses.replace(
        jax_params(solver, limit=80 if edit == "limit" else 1000),
        restart_params=restart_params(scheme, choice))
    if edit == "terminated":
        jstate = dataclasses.replace(jstate,
                                     termination_reason=jnp.int32(3))
    if edit == "error":
        jstate = dataclasses.replace(jstate, numerical_error=jnp.asarray(True))
    jnew, jres = JAX_MODULE[solver]._eval_block(
        jprep.bundle, jstate, jnp.asarray(0.0, jnp.float64),
        jax_config(solver, params))
    tprep, tcfg = port_of(solver, params)
    tstate = to_port(solver, jstate)
    with host_reads(monkeypatch) as calls:
        tnew, tres = PORT_MODULE[solver]._eval_block(
            tprep.bundle, tstate, torch.zeros((), dtype=torch.float64),
            tcfg)
    assert calls == []  # the evaluation reads nothing back
    assert_matches(tnew, jnew, "state")
    assert_matches(tres, jres, "result")
    # the situation is the one named
    reason, used = int(jres.termination_reason), int(jres.restart_used)
    if edit in ("limit", "error", "terminated"):
        assert reason != 0 and used == 0
    else:
        assert reason == 0
    if choice is not None:
        assert used == choice
    if iteration == 1:
        assert int(jstate.avg.sum_primal_solutions_count) == 0


# ---------------------------------------------------------------------------
# The restart scheme against the JAX one and the fleet's
# ---------------------------------------------------------------------------

RESTART_CASES = [(scheme, metric) for scheme in RS for metric in RM]


@pytest.mark.parametrize("scheme,metric", RESTART_CASES,
                         ids=[f"{s.name}-{m.name}" for s, m in RESTART_CASES])
def test_run_restart_scheme_matches_jax_and_one_lane(scheme, metric):
    """At the state of example_lp's iteration 81 with the PDLP
    defaults, against the JAX run_restart_scheme (rtol 1e-12), and on a
    one-lane PageRank fleet against batch.lane_restart_scheme, bitwise."""
    jprep, jstate = jax_case("pdhg", 81)
    rp = dataclasses.replace(restart_params(scheme),
                             restart_to_current_metric=metric)
    tprep, _ = port_of("pdhg", jax_params("pdhg"))
    tstate = to_port("pdhg", jstate)

    def norms(step, weight, x, y):
        return ((1.0 / step) * weight * np.ones_like(x),
                (1.0 / step) / weight * np.ones_like(y))

    pn, dn = norms(float(jstate.step_size), float(jstate.primal_weight),
                   np.asarray(jstate.current_primal_solution),
                   np.asarray(jstate.current_dual_solution))
    want = jx_restart(
        jprep.bundle.scaled, jstate.avg, jstate.current_primal_solution,
        jstate.current_dual_solution, jstate.restart_info,
        jstate.iteration - 1, jnp.asarray(pn), jnp.asarray(dn),
        jstate.primal_weight, rp)
    got = saddle_point.run_restart_scheme(
        tprep.bundle.scaled, tstate.avg, tstate.current_primal_solution,
        tstate.current_dual_solution, tstate.restart_info,
        tstate.iteration - 1, torch.as_tensor(pn), torch.as_tensor(dn),
        tstate.primal_weight, port_restart(rp))
    assert got.restart_choice.dtype == torch.int32
    assert_matches(got, want, "restart")

    tparams = port_params(fleet_pdhg_params(terminate_on_iteration_limit(
        1000)))
    fleet = batch.prepare_shared_pattern_fleet(
        tparams, [port_problem(p) for p in pagerank_fleet(60)[:1]],
        device="cpu")
    config = batch._config(tparams)
    state = fleet.initial_state
    while int(state.iteration.min()) < 81:
        state, _, _ = batch.run_segment(fleet.bundle, state, 0.0, config)
    x, y = state.current_primal_solution, state.current_dual_solution
    primal_norm = (1.0 / state.step_size) * state.primal_weight * (
        torch.ones_like(x))
    dual_norm = (1.0 / state.step_size) / state.primal_weight * (
        torch.ones_like(y))
    lanes = batch.lane_restart_scheme(
        fleet.bundle.scaled, state.avg, x, y, state.restart_info,
        state.iteration - 1, primal_norm, dual_norm, state.primal_weight,
        port_restart(rp))
    single = saddle_point.run_restart_scheme(
        single_lane_problem(fleet, 0), lane_of(state.avg, 0), x[:, 0],
        y[:, 0], lane_of(state.restart_info, 0), state.iteration[0] - 1,
        primal_norm[:, 0], dual_norm[:, 0], state.primal_weight[0],
        port_restart(rp))
    lane = [t[..., 0] for t in graphs._leaves(lanes)]
    assert len(lane) == len(graphs._leaves(single))
    for a, b in zip(lane, graphs._leaves(single)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The dispatch against the JAX package's _run_segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("segments", [1, 3, 64])
@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_dispatch_matches_the_jax_run_segments(solver, segments,
                                               monkeypatch):
    """From iteration 41 of example_lp, with a tolerance it reaches
    within 64 segments: the same reason, iteration and KKT passes."""
    if solver == "pdhg":
        monkeypatch.setattr(tx_pdhg, "_step_size_factors",
                            xla_step_size_factors)
    else:
        monkeypatch.setattr(tx_mp, "_step_size_factors", mp_xla_factors)
    jprep, jstate = jax_case(solver, 41)
    params = dataclasses.replace(
        jax_params(solver), termination_criteria=optimality_criteria(1e-7))
    want_state, want = JAX_MODULE[solver]._run_segments(
        jprep.bundle, jstate, jnp.asarray(0.0, jnp.float64),
        jax_config(solver, params), segments)
    tprep, tcfg = port_of(solver, params)
    tstate = to_port(solver, jstate)
    spans.reset_counts()
    if solver == "pdhg":
        got_state, got, iteration, reason = tx_pdhg._run_segments(
            tprep.bundle, tstate, 0.0, tcfg, segments, 41)
        assert iteration == int(want_state.iteration)
    else:
        got_state, got, reason = tx_mp._run_segments(
            tprep.bundle, tstate, 0.0, tcfg, segments)
    assert reason == int(want.termination_reason)
    assert int(got.termination_reason) == reason
    assert int(got_state.iteration) == int(want_state.iteration)
    assert int(got.iteration) == int(want.iteration)
    assert float(got.cumulative_kkt_passes) == float(
        want.cumulative_kkt_passes)
    assert float(got_state.cumulative_kkt_passes) == float(
        want_state.cumulative_kkt_passes)
    assert spans.COUNTS["loads"] == spans.COUNTS["unloads"] == 1
    if segments == 64:
        assert reason == int(tx.TerminationReason.TERMINATION_REASON_OPTIMAL)
    else:
        assert spans.COUNTS["segments"] == segments


@pytest.mark.parametrize("segments", [1, 3])
def test_a_segment_with_no_rejection_reads_back_once(segments,
                                                     monkeypatch):
    """Constant steps reject nothing: a dispatch of k segments makes k
    read-backs (one .tolist() each, the evaluations' reasons included)
    and nothing else on the host."""
    params = dataclasses.replace(
        jax_params("pdhg"),
        step_size_policy_params=jx.ConstantStepsizeParams())
    tprep, tcfg = port_of("pdhg", params)
    state = tprep.initial_state
    spans.reset_counts()
    with host_reads(monkeypatch) as calls:
        state, _, iteration, reason = tx_pdhg._run_segments(
            tprep.bundle, state, 0.0, tcfg, segments, 1)
    assert reason == 0 and iteration == segments + 1
    assert calls == ["tolist"] * segments
    assert spans.COUNTS["read_backs"] == spans.COUNTS["segments"] == (
        segments)
    assert spans.COUNTS["evaluations"] == segments


@pytest.mark.parametrize("solver", ["pdhg", "mirror_prox"])
def test_checkpoint_between_dispatches_resumes_bitwise(solver, tmp_path):
    """A solve stopped by its iteration limit at 120 (three segments a
    dispatch; the counters saved as the device's tensors) and resumed
    ends with the uninterrupted solve's iteration count and bits."""
    path = str(tmp_path / "state.npz")
    module = PORT_MODULE[solver]
    convert_params = port_params if solver == "pdhg" else port_mp_params
    problem = port_problem(random_lp())
    base = dataclasses.replace(
        convert_params(jax_params(solver)), evaluations_per_dispatch=3,
        termination_criteria=convert_params(dataclasses.replace(
            jax_params(solver),
            termination_criteria=optimality_criteria(1e-8),
        )).termination_criteria)
    full = module.optimize(base, problem, device="cpu")
    first = dataclasses.replace(
        base, checkpoint_path=path, termination_criteria=dataclasses.replace(
            base.termination_criteria, iteration_limit=120))
    stopped = module.optimize(first, problem, device="cpu")
    assert stopped.termination_reason.name == (
        "TERMINATION_REASON_ITERATION_LIMIT")
    with np.load(path) as data:
        assert data["termination_reason"].dtype == np.int32
        assert data["iteration"].dtype == np.int64
        assert data["cumulative_kkt_passes"].dtype == np.float64
        assert data["numerical_error"].dtype == np.bool_
    out = module.optimize(dataclasses.replace(
        base, resume_from_checkpoint=path), problem, device="cpu")
    assert out.termination_reason == full.termination_reason
    assert out.iteration_count == full.iteration_count > 120
    assert out.primal_solution.tobytes() == full.primal_solution.tobytes()
    assert out.dual_solution.tobytes() == full.dual_solution.tobytes()
