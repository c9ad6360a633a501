"""The port's on-device segment (models/pdhg._run_trials and
_run_segments, models/mirror_prox._run_segments) on the CPU, against the
JAX package's _run_segment and against one masked trial at a time.

- A trial (adaptive, constant) or a Mirror Prox iteration that is not
  active changes no bit of the state.
- From JAX states whose segment has rejections, the rounds give bitwise
  the state of the masked trial run one at a time with a read-back each,
  and the counters of the JAX package's _run_segment exactly.
- Read-backs are counted at the host: a segment makes one read-back a
  round (one when nothing is rejected), its evaluation included, and
  nothing else; a Mirror Prox segment makes one, after its evaluation,
  and its iterations none.
- The step-size factors on the device equal the host's pow in f64 to
  1 ulp.
- The graph decision is made by type (ops/graphs.graphable), and a
  bundle made by dataclasses.replace holds no graph of its parent.
"""

import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_tpu as jx
from firstorderlp_tpu.models import mirror_prox as jx_mp
from firstorderlp_tpu.models import pdhg as jx_pdhg

import firstorderlp_torch as tx
from firstorderlp_torch import convert, spans
from firstorderlp_torch.models import mirror_prox as tx_mp
from firstorderlp_torch.models import pdhg as tx_pdhg
from firstorderlp_torch.ops import graphs
from firstorderlp_torch.ops import linops, routed

from test_torch_mirror_prox import mid_solve
from test_torch_pdhg import (
    SEGMENT_CASES,
    jax_config,
    port_params,
    port_problem,
    state_leaves,
    xla_step_size_factors,
)
from utils import pdhg_params, terminate_on_iteration_limit

CPU = torch.device("cpu")


INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32}


def bits(t):
    """A float tensor's bits as integers (NaN payloads included)."""
    return t.view(INT_OF[t.dtype]) if t.dtype in INT_OF else t


def assert_same_bits(got, want, path="state"):
    """Every field equal: tensors bitwise (dtype and shape too), other
    values by ==; a host number against a 0-d tensor by value."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same_bits(getattr(got, f.name), getattr(want, f.name),
                             f"{path}.{f.name}")
    elif isinstance(want, torch.Tensor) and isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype, path
        assert torch.equal(bits(got), bits(want)), path
    elif isinstance(want, torch.Tensor) or isinstance(got, torch.Tensor):
        assert float(got) == float(want), path
    else:
        assert got == want, path


@contextlib.contextmanager
def host_reads(monkeypatch):
    """Counts the tensor methods that bring a value to the host."""
    calls = []
    with monkeypatch.context() as m:
        for name in ("tolist", "item", "__bool__", "__int__", "__float__",
                     "__index__"):
            original = getattr(torch.Tensor, name)

            def counted(self, *args, _name=name, _original=original,
                        **kwargs):
                calls.append(_name)
                return _original(self, *args, **kwargs)

            m.setattr(torch.Tensor, name, counted)
        yield calls


def jax_params(case):
    make, ruiz, alpha, _ = SEGMENT_CASES[case]
    return make(), dataclasses.replace(
        pdhg_params(terminate_on_iteration_limit(1000),
                    ruiz_iterations=ruiz, pock_chambolle_alpha=alpha),
        matrix_format="ell",
    )


def jax_state_at(jprep, jcfg, start):
    state = jprep.initial_state
    while int(state.iteration) < start:
        state, _ = jx_pdhg._run_segment(
            jprep.bundle, state, jnp.asarray(0.0, jnp.float64), jcfg)
    assert int(state.iteration) == start
    return state


def port_state(case, start, policy=None):
    """(port prepared, port config, port state, JAX prepared, JAX config,
    JAX state) at the case's iteration `start`, f64."""
    problem, jparams = jax_params(case)
    if policy is not None:
        jparams = dataclasses.replace(jparams,
                                      step_size_policy_params=policy)
    jprep = jx_pdhg.prepare_problem(jparams, problem)
    jcfg = jax_config(jparams)
    state = jax_state_at(jprep, jcfg, start)
    tparams = port_params(jparams)
    tprep = tx_pdhg.prepare_problem(tparams, port_problem(problem),
                                    device="cpu")
    tstate = convert.state_from_arrays(state_leaves(state), device="cpu")
    return tprep, tx_pdhg._make_config(tparams), tstate, jprep, jcfg, state


# ---------------------------------------------------------------------------
# An inactive trial changes no bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["adaptive", "constant"])
@pytest.mark.parametrize("case", ["pagerank300", "random_lp"])
def test_inactive_pdhg_trial_changes_no_bit(case, rule):
    policy = (jx.ConstantStepsizeParams() if rule == "constant" else None)
    tprep, tcfg, tstate, *_ = port_state(case, 41, policy)
    dstate = tx_pdhg._device_counters(tstate)
    problem = tprep.bundle.scaled
    off = tx_pdhg._trial(problem, dstate, tcfg.step_policy,
                         torch.tensor(False))
    assert_same_bits(off, dstate)
    on = tx_pdhg._trial(problem, dstate, tcfg.step_policy,
                        torch.tensor(True))
    assert int(on.total_number_iterations) == tstate.total_number_iterations + 1
    assert float(on.cumulative_kkt_passes) == tstate.cumulative_kkt_passes + 1
    assert not torch.equal(on.current_dual_solution,
                           dstate.current_dual_solution) or not torch.equal(
        on.step_size, dstate.step_size)


@pytest.mark.parametrize("case", ["example_lp_l2", "pagerank300_l1"])
def test_inactive_mirror_prox_iteration_changes_no_bit(case):
    """A Mirror Prox iteration is inactive when the numerical-error flag
    is already up: every field, the iteration counter too, stays."""
    _, state, _, tprep, _ = mid_solve(case)
    tstate = tx_mp._device_counters(
        convert.mp_state_from_arrays(state_leaves(state), device="cpu"))
    frozen = dataclasses.replace(tstate, numerical_error=torch.tensor(True))
    after = tx_mp._iterate(tprep.bundle.scaled, frozen)
    assert_same_bits(after, frozen)
    moved = tx_mp._iterate(tprep.bundle.scaled, tstate)
    assert int(moved.iteration) == int(tstate.iteration) + 1
    assert int(moved.iterations_completed) == int(
        tstate.iterations_completed) + 1


# ---------------------------------------------------------------------------
# Rounds against trial by trial, and against the JAX segment
# ---------------------------------------------------------------------------

# case, first iteration of a segment whose JAX trials include rejections
REJECTING_SEGMENTS = {
    "random_lp": ("random_lp", 10),
    "pagerank300": ("pagerank300", 2),
    "example_lp": ("example_lp", 41),
}


def trial_by_trial(bundle, state, config):
    """The evaluation, then the masked trial one at a time, with a
    read-back of the predicate before each."""
    state, _ = tx_pdhg._eval_block(bundle, state, 0.0, config)
    start = state.iteration.clone()
    dstate = tx_pdhg._device_counters(state)
    trials = 0
    while bool(tx_pdhg._trial_active(dstate, start, config)):
        dstate = tx_pdhg._masked_trial(bundle.scaled, config, dstate, start)
        trials += 1
    return dstate, trials


@pytest.mark.parametrize("name", sorted(REJECTING_SEGMENTS))
def test_rounds_equal_trial_by_trial_and_the_jax_counters(name,
                                                          monkeypatch):
    monkeypatch.setattr(tx_pdhg, "_step_size_factors",
                        xla_step_size_factors)
    case, start = REJECTING_SEGMENTS[name]
    tprep, tcfg, tstate, jprep, jcfg, jstate = port_state(case, start)
    jnext, _ = jx_pdhg._run_segment(
        jprep.bundle, jstate, jnp.asarray(0.0, jnp.float64), jcfg)
    trials = int(jnext.total_number_iterations) - int(
        jstate.total_number_iterations)
    accepted = int(jnext.iteration) - int(jstate.iteration)
    assert trials > accepted  # the segment rejects

    spans.reset_counts()
    rounds, _ = tx_pdhg._segment_core(tprep.bundle, tstate, 0.0, tcfg)
    want, one_by_one = trial_by_trial(tprep.bundle, tstate, tcfg)
    assert one_by_one == trials == spans.COUNTS["steps"]
    assert_same_bits(rounds, want)
    # the state leaves the segment with its counters on the device
    for name, dtype in tx_pdhg.COUNTER_DTYPES.items():
        value = getattr(rounds, name)
        assert value.dim() == 0 and value.dtype == dtype, name
    assert rounds.avg.sum_primal_solutions_count.dtype == torch.int64
    assert rounds.iteration == int(jnext.iteration)
    assert rounds.total_number_iterations == int(
        jnext.total_number_iterations)
    assert rounds.cumulative_kkt_passes == float(
        jnext.cumulative_kkt_passes)
    assert rounds.numerical_error == bool(jnext.numerical_error)
    assert rounds.avg.sum_primal_solutions_count == int(
        jnext.avg.sum_primal_solutions_count)
    # at most one read-back a rejection beyond the first round's
    assert 2 <= spans.COUNTS["read_backs"] <= 1 + (trials - accepted)


@pytest.mark.parametrize("rule", ["adaptive", "constant"])
def test_segment_reads_back_once_a_round(rule, monkeypatch):
    """Counted at the host's tensor methods: a segment, its evaluation
    included, makes exactly the rounds' read-backs, all one .tolist()
    each; a segment with no rejection (the constant rule, or an adaptive
    one that accepts every trial) makes one."""
    policy = jx.ConstantStepsizeParams() if rule == "constant" else None
    tprep, tcfg, tstate, *_ = port_state("random_lp", 81, policy)
    state = tx_pdhg._device_counters(tstate)
    spans.reset_counts()
    with host_reads(monkeypatch) as calls:
        after, _, iteration, reason = tx_pdhg._run_segments(
            tprep.bundle, state, 0.0, tcfg, 1, 81)
    assert reason == 0 and iteration == int(after.iteration)
    assert calls == ["tolist"] * spans.COUNTS["read_backs"]
    trials = after.total_number_iterations - state.total_number_iterations
    accepted = after.iteration - state.iteration
    assert accepted == tx_pdhg.next_eval_iteration(81, tcfg) - 81
    if trials == accepted:
        assert spans.COUNTS["read_backs"] == 1
    else:
        assert spans.COUNTS["read_backs"] <= 1 + trials - accepted
    assert spans.COUNTS["segments"] == spans.COUNTS["evaluations"] == 1
    assert spans.COUNTS["loads"] == spans.COUNTS["unloads"] == 1
    assert spans.COUNTS["replays"] == 0  # the CPU runs them eagerly


def test_mirror_prox_segment_reads_nothing_back(monkeypatch):
    """The iterations read nothing back: a segment's one read-back is
    its evaluation's (the reason and the iteration, one .tolist())."""
    _, state, _, tprep, tcfg = mid_solve("pagerank300_l1")
    tstate = tx_mp._device_counters(
        convert.mp_state_from_arrays(state_leaves(state), device="cpu"))
    start = int(tstate.iteration)
    iterations = tx_mp.next_eval_iteration(start, tcfg) - start
    spans.reset_counts()
    with host_reads(monkeypatch) as calls:
        after, _, reason = tx_mp._run_segments(tprep.bundle, tstate, 0.0,
                                               tcfg, 1)
    assert reason == 0
    assert calls == ["tolist"]
    assert spans.COUNTS["read_backs"] == 1
    assert spans.COUNTS["steps"] == iterations
    assert int(after.iteration) == start + iterations


def test_eager_flag_gives_the_same_segment():
    """`_eager` only matters where a graph would run; on the CPU the
    segment is the same either way."""
    tprep, tcfg, tstate, *_ = port_state("pagerank300", 41)
    a, _ = tx_pdhg._segment_core(tprep.bundle, tstate, 0.0, tcfg)
    b, _ = tx_pdhg._segment_core(tprep.bundle, tstate, 0.0, tcfg,
                                 _eager=True)
    assert_same_bits(a, b)


# ---------------------------------------------------------------------------
# Step-size factors on the device
# ---------------------------------------------------------------------------

COUNTS = np.unique(np.concatenate([
    np.arange(0, 3000), np.geomspace(3000, 2 ** 31 - 2, 200).astype(np.int64),
]))


def within_one_ulp(got, want, power):
    """|got - want| within one ulp of the larger of the factor and the
    power it adds to or takes from 1: the two pows differ by at most an
    ulp, which 1 -+ p keeps (an ulp of p, when 1 - p is exact) or rounds
    to an ulp of the factor."""
    return np.all(np.abs(got - want)
                  <= np.spacing(np.maximum(power, np.abs(want))))


def test_pdhg_step_factors_on_the_device_match_the_host():
    params = tx.AdaptiveStepsizeParams(reduction_exponent=0.3,
                                       growth_exponent=0.6)
    shrink, grow = tx_pdhg._step_size_factors(
        torch.as_tensor(COUNTS), params, torch.float64)
    t1 = COUNTS.astype(np.float64) + 1.0
    assert within_one_ulp(shrink.numpy(), 1 - t1 ** -0.3, t1 ** -0.3)
    assert within_one_ulp(grow.numpy(), 1 + t1 ** -0.6, t1 ** -0.6)
    assert shrink.dtype == grow.dtype == torch.float64


def test_mirror_prox_step_factors_on_the_device_match_the_host():
    shrink, grow = tx_mp._step_size_factors(torch.as_tensor(COUNTS),
                                            torch.float64)
    t1 = COUNTS.astype(np.float64) + 1.0
    assert within_one_ulp(shrink.numpy(), 1 - t1 ** -0.3, t1 ** -0.3)
    assert within_one_ulp(grow.numpy(), 1 + t1 ** -0.6, t1 ** -0.6)


# ---------------------------------------------------------------------------
# Which problems are graphed, and where the graphs live
# ---------------------------------------------------------------------------


def fake_problem(op, dtype=torch.float32, objective_matrix=None):
    return types.SimpleNamespace(
        constraint_matrix=op, objective_matrix=objective_matrix,
        objective_vector=torch.zeros(3, dtype=dtype))


def test_graphs_are_chosen_by_type():
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    on_cpu = types.SimpleNamespace(device=CPU)
    card_op = routed.RoutedOp(a=on_card, at=on_card)
    assert graphs.graphable(fake_problem(card_op))
    # not the CPU, not f64, not a QP, not another operator
    assert not graphs.graphable(fake_problem(routed.RoutedOp(on_cpu,
                                                             on_cpu)))
    assert not graphs.graphable(fake_problem(card_op, torch.float64))
    assert not graphs.graphable(fake_problem(card_op,
                                             objective_matrix=card_op))
    csr = linops.build_linop(sp.eye(3), torch.float32, "sparse", "cpu")
    assert not graphs.graphable(fake_problem(csr))
    dense = linops.build_linop(sp.eye(3), torch.float32, "dense", "cpu")
    assert not graphs.graphable(fake_problem(dense))


def test_a_replaced_bundle_starts_with_no_graph():
    tprep, *_ = port_state("pagerank300", 10)
    bundle = tprep.bundle
    bundle.graphs["marker"] = object()
    swapped = dataclasses.replace(bundle, scaled=bundle.scaled)
    assert swapped.graphs == {} and "marker" in bundle.graphs
    bundle.graphs.clear()
