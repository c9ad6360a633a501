"""The port's spans and counters (firstorderlp_torch/spans.py) on the CPU,
on the 1,000-node PageRank LP of tests/trial_cases.py: PDHG with
adaptive and constant steps, and Mirror Prox.

- With no profiler collecting, no span makes a profiler record (the
  record types patched to raise), and a solve's answers are bitwise
  those of a profiled one.
- Under torch.profiler (CPU activity) a solve shows every span of the
  host loop and of the ingest, nested solve > dispatch > evaluate /
  trials / read_back / load / unload, and the spans of evaluate and
  read_back as many as the counters' changes.
- Every solver runs the one host loop (models/common.solve): the same
  sequence of dispatch, finalize and unscale spans, and the same
  counters moved.
- prepare_problem adds its host seconds to the ingest counters.
- Every span name in the program starts with `folp.` and none reads as
  a CUDA runtime call (lpbench/tracing.py counts those by name).

On the card (`-m cuda`): the segment graphs' capture is a span and adds
to `capture_seconds`, and no span leaves a device-side record.
"""

import ast
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import firstorderlp_torch as tx
from firstorderlp_torch import spans
from firstorderlp_torch.models import mirror_prox, pdhg

import trial_cases

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "firstorderlp_torch")
SOLVERS = ["pdhg-adaptive", "pdhg-constant", "mirror_prox"]
LOOP = {"folp.solve", "folp.dispatch", "folp.load", "folp.unload",
        "folp.evaluate", "folp.trials", "folp.read_back",
        "folp.finalize", "folp.unscale"}
INGEST = {"folp.ingest.rescale", "folp.ingest.to_device",
          "folp.ingest.step_size"}
IN_DISPATCH = {"folp.load", "folp.unload", "folp.evaluate",
               "folp.trials"}


def solver_of(name):
    """(module, parameters) of a solver case."""
    if name == "mirror_prox":
        p = trial_cases.params()
        fields = {f: getattr(p, f) for f in (
            "l_inf_ruiz_iterations", "l2_norm_rescaling",
            "pock_chambolle_alpha", "primal_importance",
            "scale_invariant_initial_primal_weight", "verbosity",
            "record_iteration_stats", "termination_evaluation_frequency",
            "termination_criteria", "restart_params", "dtype",
            "matrix_format")}
        return mirror_prox, tx.MirrorProxParameters(
            **fields, diagonal_scaling="l2")
    return pdhg, trial_cases.params(name.split("-")[1])


@pytest.fixture(scope="module")
def problem():
    return trial_cases.PROBLEMS["pagerank"]()


def solve(name, problem, device="cpu"):
    module, params = solver_of(name)
    prepared = module.prepare_problem(params, problem, device=device)
    return module.optimize(params, problem, prepared=prepared)


def profiled(fn):
    """(fn's value, the profiler's records as (start, end, name, device
    type))."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = fn()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               e.device_type())
              for e in prof.profiler.kineto_results.events()]
    return value, events


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("name", SOLVERS)
def test_no_profiler_enters_nothing_and_keeps_the_bits(name, problem,
                                                        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler record made with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        assert spans.span("folp.solve") is spans.span("folp.trials")
        plain = solve(name, problem)
    traced, events = profiled(lambda: solve(name, problem))
    assert any(e[2] == "folp.solve" for e in events)
    assert plain.termination_reason == traced.termination_reason
    assert plain.iteration_count == traced.iteration_count
    assert np.array_equal(plain.primal_solution, traced.primal_solution)
    assert np.array_equal(plain.dual_solution, traced.dual_solution)


@pytest.mark.parametrize("name", SOLVERS)
def test_profiled_solve_shows_every_span_nested(name, problem):
    spans.reset_counts()
    out, events = profiled(lambda: solve(name, problem))
    assert out.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    folp = [e[:3] for e in events if e[2].startswith("folp.")]
    names = {n for _, _, n in folp}
    assert names == LOOP | INGEST
    of = {n: [e for e in folp if e[2] == n] for n in names}
    (solve_span,) = of["folp.solve"]
    for e in of["folp.dispatch"] + of["folp.finalize"] + of[
            "folp.unscale"]:
        assert inside(e, solve_span), e
    for e in folp:
        if e[2] in IN_DISPATCH:
            assert any(inside(e, d) for d in of["folp.dispatch"]), e
        if e[2] == "folp.read_back":
            assert any(inside(e, d) for d in of["folp.dispatch"]
                       + of["folp.finalize"]), e
        if e[2].startswith("folp.ingest."):
            assert not inside(e, solve_span), e
    # a read-back in a dispatch at least once a segment, one in the
    # final statistics
    assert len(of["folp.evaluate"]) == spans.COUNTS["evaluations"]
    assert len(of["folp.read_back"]) == spans.COUNTS["read_backs"]
    assert len(of["folp.trials"]) >= spans.COUNTS["segments"] - 1
    assert len(of["folp.dispatch"]) == len(of["folp.load"]) == len(
        of["folp.unload"]) == spans.COUNTS["loads"]
    assert sum(1 for e in of["folp.read_back"]
               if any(inside(e, f) for f in of["folp.finalize"])) == 1
    assert spans.COUNTS["solves"] == 1


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("name", SOLVERS)
def test_every_solver_runs_the_one_host_loop(name, recorded, problem):
    """models/common.solve drives every solver alike. Inside folp.solve:
    a dispatch each time round, a finalize after each dispatch whose
    statistics are kept (every one with record_iteration_stats, else
    the last), then the unscale. A solve moves the same counters
    whichever solver ran: one evaluation a segment, one load and one
    unload a dispatch, a read-back at least once a segment and once a
    finalize (exactly so for Mirror Prox, whose segments read back once)."""
    module, params = solver_of(name)
    params = dataclasses.replace(params, record_iteration_stats=recorded,
                                 evaluations_per_dispatch=2)
    prepared = module.prepare_problem(params, problem, device="cpu")
    spans.reset_counts()
    out, events = profiled(
        lambda: module.optimize(params, problem, prepared=prepared))
    assert out.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    (solve_span,) = [e for e in events if e[2] == "folp.solve"]
    loop = sorted(e for e in events if e[2] in (
        "folp.dispatch", "folp.finalize", "folp.unscale"))
    assert all(inside(e, solve_span) for e in loop)
    seen = [e[2] for e in loop]
    dispatches = seen.count("folp.dispatch")
    want = []
    for i in range(dispatches):
        want.append("folp.dispatch")
        if recorded or i == dispatches - 1:
            want.append("folp.finalize")
    assert seen == want + ["folp.unscale"]
    assert len(out.iteration_stats) == seen.count("folp.finalize")
    c = spans.COUNTS
    assert {k for k, v in c.items() if v} == {
        "solves", "segments", "evaluations", "steps", "read_backs",
        "loads", "unloads"}
    assert c["solves"] == 1
    assert c["loads"] == c["unloads"] == dispatches
    assert c["evaluations"] == c["segments"] <= 2 * dispatches
    finalizes = seen.count("folp.finalize")
    if module is mirror_prox:
        assert c["read_backs"] == c["segments"] + finalizes
    assert c["read_backs"] >= c["segments"] + finalizes


@pytest.mark.parametrize("name", SOLVERS)
def test_prepare_problem_times_its_ingest(name, problem):
    module, params = solver_of(name)
    spans.reset_counts()
    module.prepare_problem(params, problem, device="cpu")
    for key in ("rescale_seconds", "to_device_seconds",
                "step_size_seconds"):
        assert spans.COUNTS[key] > 0, key
    assert spans.COUNTS["capture_seconds"] == 0  # no graph on the CPU


def test_one_counter_table():
    assert spans.COUNTS is spans.COUNTS
    assert spans.reset_counts is spans.reset_counts
    assert "masked_steps" not in spans.COUNTS
    spans.COUNTS["steps"] = 3
    spans.reset_counts()
    assert set(spans.COUNTS.values()) == {0}


def test_timed_adds_its_seconds_under_its_last_name():
    spans.reset_counts()
    with spans.timed("folp.ingest.rescale"):
        pass
    first = spans.COUNTS["rescale_seconds"]
    with pytest.raises(ValueError):
        with spans.timed("folp.ingest.rescale"):
            raise ValueError
    assert spans.COUNTS["rescale_seconds"] > first > 0
    with pytest.raises(KeyError):
        with spans.timed("folp.nothing"):
            pass


def span_names():
    """Every literal name passed to span() or timed() in the package."""
    found = {}
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(
                        node.func, "attr", getattr(node.func, "id", None))
                        in ("span", "timed") and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    found.setdefault(node.args[0].value, set()).add(
                        os.path.relpath(path, PACKAGE))
    return found


def test_span_names_are_the_documented_ones():
    names = span_names()
    assert set(names) == LOOP | INGEST | {"folp.capture",
                                          "folp.ingest.fleet"}
    runtime = re.compile(r"^cu(da)?[A-Z]")
    for name in names:
        assert name.startswith("folp.") and not runtime.match(name)
        assert name in spans.__doc__, name
    # the solvers share their host loop and ingest, name their own
    # dispatch's spans alike, and share the runner's
    for name in ("folp.solve", "folp.finalize", "folp.unscale",
                 "folp.ingest.rescale", "folp.ingest.to_device"):
        assert "models/common.py" in names[name], name
        assert not {"models/pdhg.py", "models/mirror_prox.py"} & names[name]
    for name in ("folp.dispatch", "folp.unload", "folp.read_back",
                 "folp.ingest.step_size"):
        assert {"models/pdhg.py", "models/mirror_prox.py"} <= names[name]
    for name in ("folp.load", "folp.evaluate", "folp.trials"):
        assert "ops/graphs.py" in names[name]
    # the fleets' host loop and ingest (tests/test_torch_batch_spans.py)
    for name in ("folp.solve", "folp.dispatch", "folp.evaluate",
                 "folp.trials", "folp.read_back", "folp.unscale",
                 "folp.ingest.fleet"):
        assert "batch.py" in names[name], name


@pytest.mark.cuda
def test_capture_is_a_span_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spans.reset_counts()
    out, events = profiled(lambda: solve(
        "pdhg-adaptive", trial_cases.PROBLEMS["pagerank"](), "cuda"))
    assert out.termination_reason.name == "TERMINATION_REASON_OPTIMAL"
    captures = [e for e in events if e[2] == "folp.capture"]
    assert len(captures) == spans.COUNTS["captures"] == 1
    assert spans.COUNTS["capture_seconds"] > 0
    # function-scoped records: no device-side range of their own, which
    # a union of the device's records would count as busy time
    assert not [e for e in events if e[2].startswith("folp.")
                and e[3] != torch.autograd.DeviceType.CPU]
    assert {"folp.evaluate", "folp.trials"} <= {e[2] for e in events}
