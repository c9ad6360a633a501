"""The damping-sweep cell (pagerank-sweep-128x100k.pdhg) on the CPU at 8
lanes of 1,500 nodes, the harness's look for a chip skipped: a sound run
is correct, and each fault of the fleet's path turns `correct` false on
the limit named; the entry's fleet against the reference's LPs; the
fleet roofline's count by hand; the per-layer readers on a program
without the fleet's counters; and the reference path's imports."""

import dataclasses
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from firstorderlp_torch import batch

from lpbench import harness, lanes_roofline, pagerank, registry
from lpbench.tests.small import SMALL

CELL = "pagerank-sweep-128x100k.pdhg"
LANES = 8
SMALL_FLEET = {"config": {**SMALL["config"], "lanes": LANES}}
SEED = 2**31 + 77
PDHG_ITERATES = ("current_primal_solution", "current_dual_solution",
                 "current_dual_product", "delta_primal", "delta_dual")
READERS = ("lanes_roofline.fleet", "launches_per_trial.fleet",
           "frozen_lane_share.fleet")


def _config():
    spec = registry.cell(CELL)
    return ({**registry.config(spec["config"]), **SMALL_FLEET["config"]},
            registry.traffic(spec["traffic"]))


def _run(traffic=None, trace=0):
    overrides = {**SMALL_FLEET, "traffic": traffic or {}}
    return harness.run_cell(CELL, SEED, 0.2, trace, "cpu", time.time(),
                            overrides=overrides)


def _limit_failed(result, name):
    check = result["checks"][name]
    return not result["correct"] and check["value"] > check["limit"]


def _alter(monkeypatch, change):
    """Every fleet's answers passed through change(outputs)."""
    solve = batch.solve_batch_shared_pattern

    def altered(*args, **kwargs):
        return change(solve(*args, **kwargs))
    monkeypatch.setattr(batch, "solve_batch_shared_pattern", altered)


def test_sound_run_is_correct():
    result, details = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] == LANES * details["solves"]
    assert result["failed"] == 0
    assert details["answers_judged"] == LANES
    assert details["window_bits_as_warm_solve"]
    assert "primal_l1_error" in result["checks"]
    assert set(result["metrics"]) == {"iters_per_s", "setup_s"}


def test_traced_run_reads_the_frozen_lane_share():
    """On the CPU the trace has no device time: the two device readers
    are left out, the counter's share is read."""
    result, _ = _run(trace=1)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"frozen_lane_share.fleet"}
    assert 0 < result["metrics"]["frozen_lane_share.fleet"]["value"] < 100


def test_lane_step_that_keeps_its_iterates(monkeypatch):
    step = batch.pdhg_lane_step

    def unchanged(problem, state, *args, **kwargs):
        new = step(problem, state, *args, **kwargs)
        return dataclasses.replace(
            new, **{f: getattr(state, f) for f in PDHG_ITERATES})
    monkeypatch.setattr(batch, "pdhg_lane_step", unchanged)
    result, _ = _run({"iteration_limit": 200})
    assert not result["correct"]
    assert result["checks"]["not_optimal"]["value"] > 0


def test_two_lanes_answers_swapped(monkeypatch):
    def swapped(outs):
        outs[0].primal_solution, outs[-1].primal_solution = (
            outs[-1].primal_solution, outs[0].primal_solution)
        return outs
    _alter(monkeypatch, swapped)
    result, _ = _run()
    assert _limit_failed(result, "primal_l1_error")


def test_a_lanes_answer_left_out(monkeypatch):
    _alter(monkeypatch, lambda outs: outs[:-1])
    result, _ = _run()
    assert _limit_failed(result, "answers_missing")


def test_uniform_answer_in_one_lane(monkeypatch):
    """x = 1/n, y = 0 in one lane: the mass row holds, the shape is
    wrong."""
    def uniform(outs):
        outs[3].primal_solution[:] = 1.0 / outs[3].primal_solution.size
        outs[3].dual_solution[:] = 0.0
        return outs
    _alter(monkeypatch, uniform)
    result, _ = _run()
    assert _limit_failed(result, "primal_l1_error")


@pytest.fixture(scope="module")
def session():
    config, traffic = _config()
    generator = registry.generator(config["generator"])
    sweep = generator.make(config, SEED)
    entry = registry.entry(traffic["entry"])
    return entry.Session(config, traffic, sweep, "cpu",
                         harness.Spans(lambda: None))


def test_two_solves_of_one_prepared_fleet_same_bits(session):
    a, b = session.solve(), session.solve()
    assert a["lane_iterations"] == b["lane_iterations"]
    for (i, s, x, y), (j, t, u, v) in zip(a["answers"], b["answers"],
                                          strict=True):
        assert (i, s) == (j, t)
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)
    assert sorted(i for i, *_ in a["answers"]) == list(range(LANES))


def test_lanes_are_the_reference_lps_in_f32(session):
    """Lane j of the spec holds damping order[j]'s LP, as
    lpbench/pagerank.pagerank_lp builds it in f64, within f32
    rounding."""
    config, _ = _config()
    sweep = session.sweep
    base = session.spec.base_problem.constraint_matrix
    nnz = sp.csr_matrix(base).nnz
    v, vectors, _ = batch._spec_lanes(session.spec, torch.float32,
                                      torch.device("cpu"),
                                      (*sweep.shape, nnz))
    n = config["num_nodes"]
    for lane, k in enumerate(sweep.order):
        d = float(sweep.dampings[k])
        want = pagerank.pagerank_lp(n, config["approx_num_edges"], d,
                                    config["graph_seed"])
        own = sweep.lp(int(k))
        assert own.damping_factor == d
        assert (own.constraint_matrix != want.constraint_matrix).nnz == 0
        np.testing.assert_array_equal(own.right_hand_side,
                                      want.right_hand_side)
        np.testing.assert_allclose(v[:, lane].numpy(),
                                   want.constraint_matrix.data,
                                   rtol=1e-6, atol=1e-7)
        # (1 - d)/n as 1/n - d/n in f32: the rounding of the terms
        np.testing.assert_allclose(vectors["b"][:, lane].numpy(),
                                   want.right_hand_side, rtol=1e-6,
                                   atol=2.0**-22 / n)


def test_seed_permutes_the_lanes_only():
    config, _ = _config()
    generator = registry.generator(config["generator"])
    a, b = generator.make(config, 2**32 + 1), generator.make(config, 7)
    np.testing.assert_array_equal(a.dampings, b.dampings)
    np.testing.assert_array_equal(a.dampings,
                                  np.linspace(0.7, 0.995, LANES))
    assert sorted(a.order) == sorted(b.order) == list(range(LANES))
    assert list(a.order) != list(b.order)
    assert (a.adjacency != b.adjacency).nnz == 0


def test_fleet_bytes_hand_count():
    # A 2 x 3 with 4 entries, two lanes of 3 and 5 passes. The pattern
    # once a pass of the longest lane: A's 3 row pointers, A''s 4, 4 + 4
    # column indices (int32). Each lane's pass: 4 + 4 values, x, A x =
    # 3 + 2, y, A'y = 2 + 3 (f32).
    a = sp.csr_matrix(np.array([[1.0, 0, 2], [0, 3, 4]]))
    m, n = a.shape
    pattern = 4 * (3 + 4 + 4 + 4)
    lane = 4 * (4 + 4 + 5 + 5)
    assert lanes_roofline.pattern_bytes(m, n, a.nnz) == pattern
    assert lanes_roofline.lane_pass_bytes(m, n, a.nnz) == lane
    assert lanes_roofline.fleet_bytes(m, n, a.nnz, [3.0, 5.0]) == (
        pattern * 5 + lane * 8)
    assert lanes_roofline.fleet_bytes(m, n, a.nnz, []) == 0


def _record(counts, kind="NVIDIA H100 80GB HBM3"):
    solve = {"iterations": 300, "kkt_passes": 340.0,
             "lane_kkt_passes": [100.0, 240.0], "counts": counts}
    return {"solves": [solve, dict(solve)], "shape": (1501, 1500, 11982),
            "device_kind": kind, "spans": {},
            "trace": {"busy_s": 0.5, "window_s": 1.0,
                      "host_runtime_calls": 50000}}


def test_readers_on_a_program_with_the_counters():
    record = _record({"steps": 250, "lane_steps": 500})
    read = {name: registry.metric(name).read(record) for name in READERS}
    assert read["launches_per_trial.fleet"] == 50000 / 500
    assert read["frozen_lane_share.fleet"] == pytest.approx(40.0)
    want = 2 * lanes_roofline.fleet_bytes(1501, 1500, 11982,
                                          [100.0, 240.0])
    assert read["lanes_roofline.fleet"] == pytest.approx(
        100.0 * want / 3.35e12 / 0.5)


@pytest.mark.parametrize("counts", [{}, {"steps": 0, "solves": 1}])
def test_readers_on_a_program_without_the_counters(counts):
    """The parent's program: no counters, or a fleet that counts none."""
    record = _record(counts)
    assert registry.metric("launches_per_trial.fleet").read(record) is None
    assert registry.metric("frozen_lane_share.fleet").read(record) is None
    assert registry.metric("lanes_roofline.fleet").read(record) > 0
    assert registry.metric("lanes_roofline.fleet").read(
        _record(counts, "cpu")) is None


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=registry.REPO, capture_output=True, text=True, check=True,
        timeout=300)
    return set(out.stdout.splitlines()[-1].split())


def test_the_sweeps_reference_imports_neither_the_port_nor_jax():
    tops = _loaded(
        "from lpbench import registry\n"
        "import lpbench.reference.judge, lpbench.reference.kkt\n"
        "g = registry.generator('pagerank_sweep')\n"
        "c = {**registry.config('pagerank-sweep-128x100k'),\n"
        "     'num_nodes': 300, 'approx_num_edges': 900, 'lanes': 3}\n"
        "s = g.make(c, 5)\n"
        "x = g.solution(c, s.lp(2), 'cpu')\n"
        "assert abs(x.sum() - 1) < 1e-9\n")
    assert "lpbench" in tops
    assert not tops & {"firstorderlp_torch", *harness.FORBIDDEN}


def test_the_fleet_run_imports_no_jax():
    tops = _loaded(
        "from lpbench import harness, registry, tracing, lanes_roofline\n"
        "registry.entry('fleet_solve')\n"
        "for m in registry.per_layer('" + CELL + "'):\n"
        "    registry.metric(m['name'])\n")
    assert "firstorderlp_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    """At the small size on the card: correct, the window's answers the
    warm solve's bits, and a traced run reads all three metrics."""
    overrides = {**SMALL_FLEET, "traffic": {}}
    result, details = harness.run_cell(CELL, SEED, 0.5, 0, cuda_device,
                                       time.time(), overrides=overrides)
    assert result["correct"], result["checks"]
    assert details["window_bits_as_warm_solve"]
    result, _ = harness.run_cell(CELL, SEED, 0.5, 1, cuda_device,
                                 time.time(), overrides=overrides)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == set(READERS)
    assert 0 < result["metrics"]["lanes_roofline.fleet"]["value"] <= 105
