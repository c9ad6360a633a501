"""The fleet's spans and counters (firstorderlp_torch/batch.py) on the CPU,
on small PageRank damping sweeps: a FleetSpec solved by PDHG (adaptive
steps) and by Mirror Prox, and a problem list by PDHG with constant
steps (the per-instance ingest).

- Under torch.profiler (CPU activity) a fleet's ingest and solve show
  folp.ingest.fleet, then folp.solve > folp.dispatch > folp.evaluate /
  folp.trials / folp.read_back, and folp.unscale inside folp.solve; as
  many evaluate and read_back spans as the counters' changes.
- The counters' changes over a call equal its FleetRunStats, and
  COUNTS["lane_steps"] is the lanes times the trials.
- With no profiler collecting, no span makes a record, and the answers
  are bitwise those of a profiled solve.
- generators.pagerank_fleet_spec takes the caller's graph.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import firstorderlp_torch as tx
from firstorderlp_torch import batch, generators, spans

import trial_cases

LANES = 4
NODES = 300
DAMPING = np.linspace(0.7, 0.995, LANES)
FLEET = {"folp.solve", "folp.dispatch", "folp.evaluate", "folp.trials",
         "folp.read_back", "folp.unscale"}
IN_DISPATCH = {"folp.evaluate", "folp.trials", "folp.read_back"}
CASES = ["pdhg-spec", "mirror_prox-spec", "pdhg-constant-list"]


def params_of(case):
    if case.startswith("mirror_prox"):
        p = trial_cases.params()
        fields = {f: getattr(p, f) for f in (
            "l_inf_ruiz_iterations", "l2_norm_rescaling",
            "pock_chambolle_alpha", "primal_importance",
            "scale_invariant_initial_primal_weight", "verbosity",
            "record_iteration_stats", "termination_evaluation_frequency",
            "termination_criteria", "restart_params", "dtype",
            "matrix_format")}
        return tx.MirrorProxParameters(**fields, diagonal_scaling="l2")
    return trial_cases.params(
        "constant" if case.endswith("constant-list") else "adaptive")


def fleet_of(case):
    if case.endswith("-list"):
        return generators.generate_pagerank_lp_fleet(NODES, DAMPING, seed=3)
    return generators.pagerank_fleet_spec(NODES, DAMPING, seed=3)


def ingest_and_solve(case):
    """(outputs, FleetRunStats, the counters' change over the solve)."""
    params, problems = params_of(case), fleet_of(case)
    fleet = batch.prepare_shared_pattern_fleet(params, problems,
                                               device="cpu")
    stats = batch.FleetRunStats()
    before = dict(spans.COUNTS)
    outs = batch.solve_batch_shared_pattern(params, problems, fleet=fleet,
                                            run_stats=stats)
    change = {k: v - before[k] for k, v in spans.COUNTS.items()}
    return outs, stats, change


def profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = fn()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("folp.")]
    return value, events


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("case", CASES)
def test_profiled_fleet_shows_every_span_nested(case):
    spans.reset_counts()
    (outs, _, change), events = profiled(lambda: ingest_and_solve(case))
    assert all(o.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
               for o in outs)
    names = {n for _, _, n in events}
    assert names == FLEET | {"folp.ingest.fleet"}
    of = {n: [e for e in events if e[2] == n] for n in names}
    (solve_span,) = of["folp.solve"]
    (ingest,) = of["folp.ingest.fleet"]
    assert ingest[1] <= solve_span[0]
    for e in of["folp.dispatch"] + of["folp.unscale"]:
        assert inside(e, solve_span), e
    for e in events:
        if e[2] in IN_DISPATCH:
            assert any(inside(e, d) for d in of["folp.dispatch"]), e
    assert len(of["folp.evaluate"]) == change["evaluations"]
    assert len(of["folp.read_back"]) == change["read_backs"]
    # a run of trials a segment at least, one more after each read-back
    # that finds a lane active
    assert change["segments"] <= len(of["folp.trials"]) + 1
    assert len(of["folp.trials"]) <= change["steps"]
    assert spans.COUNTS["fleet_seconds"] > 0
    assert spans.COUNTS["solves"] == 1


@pytest.mark.parametrize("case", CASES)
def test_counts_are_the_calls_run_stats(case):
    outs, stats, change = ingest_and_solve(case)
    assert stats.segments > 1 and stats.trials > stats.segments
    assert change["segments"] == change["evaluations"] == stats.segments
    assert change["steps"] == stats.trials
    assert change["read_backs"] == stats.read_backs
    assert change["lane_steps"] == LANES * stats.trials
    assert change["solves"] == 1
    assert change["fleet_seconds"] == 0  # the ingest came before
    # each lane's own iterations are trials it took
    assert 0 < sum(o.iteration_count for o in outs) <= change["lane_steps"]


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_enters_nothing_and_keeps_the_bits(case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler record made with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        plain, _, _ = ingest_and_solve(case)
    (traced, _, _), events = profiled(lambda: ingest_and_solve(case))
    assert any(e[2] == "folp.solve" for e in events)
    for a, b in zip(plain, traced, strict=True):
        assert a.termination_reason == b.termination_reason
        assert a.iteration_count == b.iteration_count
        np.testing.assert_array_equal(a.primal_solution, b.primal_solution)
        np.testing.assert_array_equal(a.dual_solution, b.dual_solution)


def spec_lanes(spec):
    m, n = spec.base_problem.constraint_matrix.shape
    nnz = sp.csr_matrix(spec.base_problem.constraint_matrix).nnz
    return batch._spec_lanes(spec, torch.float32, torch.device("cpu"),
                             (m, n, nnz))


def test_fleet_spec_takes_the_callers_graph():
    """The same graph handed in gives the spec the default path draws;
    another graph gives each lane the LP generate_pagerank_lp builds on
    it, within f32 rounding."""
    drawn = generators.pagerank_fleet_spec(NODES, DAMPING, seed=5)
    graph = generators.barabasi_albert_graph(NODES, 3, seed=5)
    given = generators.pagerank_fleet_spec(NODES, DAMPING, seed=5,
                                           _adjacency=graph)
    a, b = drawn.base_problem.constraint_matrix, \
        given.base_problem.constraint_matrix
    assert (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0
    np.testing.assert_array_equal(drawn.base_problem.right_hand_side,
                                  given.base_problem.right_hand_side)
    for x, y in zip(spec_lanes(drawn)[:2], spec_lanes(given)[:2]):
        if isinstance(x, dict):
            for key in x:
                assert torch.equal(x[key], y[key]), key
        else:
            assert torch.equal(x, y)

    other = generators.barabasi_albert_graph(NODES, 3, seed=6)
    spec = generators.pagerank_fleet_spec(NODES, DAMPING, seed=5,
                                          _adjacency=other)
    v, vectors, _ = spec_lanes(spec)
    for lane, d in enumerate(DAMPING):
        lp = generators.generate_pagerank_lp(NODES, damping_factor=float(d),
                                             _adjacency=other)
        want = sp.csr_matrix(lp.constraint_matrix)
        want.sum_duplicates()
        np.testing.assert_allclose(v[:, lane].numpy(), want.data,
                                   rtol=1e-6, atol=1e-7)
        # (1 - d)/n as 1/n - d/n in f32: the rounding of the terms
        np.testing.assert_allclose(vectors["b"][:, lane].numpy(),
                                   lp.right_hand_side, rtol=1e-6,
                                   atol=2.0**-22 / NODES)
    assert (sp.csr_matrix(spec.base_problem.constraint_matrix)
            != sp.csr_matrix(a)).nnz > 0


@pytest.mark.cuda
def test_fleet_spans_on_the_card():
    """On the card: the fleet's spans are function-scoped records with no
    device-side range of their own, and the counters are the call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    params, spec = params_of("pdhg-spec"), fleet_of("pdhg-spec")
    spans.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fleet = batch.prepare_shared_pattern_fleet(params, spec,
                                                   device="cuda")
        stats = batch.FleetRunStats()
        outs = batch.solve_batch_shared_pattern(params, spec, fleet=fleet,
                                                run_stats=stats)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("folp.")]
    assert {e.name() for e in events} == FLEET | {"folp.ingest.fleet"}
    assert all(e.device_type() == torch.autograd.DeviceType.CPU
               for e in events)
    assert all(o.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
               for o in outs)
    assert spans.COUNTS["steps"] == stats.trials
    assert spans.COUNTS["lane_steps"] == LANES * stats.trials
    assert spans.COUNTS["read_backs"] == stats.read_backs
