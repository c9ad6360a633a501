"""A run of each cell, the harness's look for a chip skipped (the CPU
path of the port at a small size), with the timed path broken
underneath: `correct` comes out false for each fault the cell can
have. (No cell has an exchange between chips or a batch: each solves
one LP on one card.)"""

import dataclasses
import time

import pytest

from firstorderlp_torch.models import mirror_prox, pdhg

from lpbench import harness, pagerank, registry
from lpbench.reference import pagerank as reference
from lpbench.tests.small import SMALL

CELLS = ["pagerank-1m.pdhg", "pagerank-1m.mirror-prox"]
PDHG_ITERATES = ("current_primal_solution", "current_dual_solution",
                 "current_dual_product", "delta_primal", "delta_dual")


def _run(cell, traffic=None):
    overrides = {"config": SMALL["config"], "traffic": traffic or {}}
    result, _ = harness.run_cell(cell, 2**31 + 77, 0.2, 0, "cpu",
                                 time.time(), overrides=overrides)
    return result


def _keep(fields, step):
    """`step` as a step that returns its state's iterates unchanged (the
    counters move on)."""
    def unchanged(problem, state, *args, **kwargs):
        new = step(problem, state, *args, **kwargs)
        return dataclasses.replace(
            new, **{f: getattr(state, f) for f in fields})
    return unchanged


def _alter(monkeypatch, change):
    """Every answer the solvers produce passed through change(out)."""
    for module in (pdhg, mirror_prox):
        unscale = module.unscaled_saddle_point_output

        def altered(*args, _unscale=unscale, **kwargs):
            out = _unscale(*args, **kwargs)
            change(out)
            return out
        monkeypatch.setattr(module, "unscaled_saddle_point_output", altered)


def _limit_failed(result, name):
    check = result["checks"][name]
    return not result["correct"] and check["value"] > check["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "primal_l1_error" in result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(pdhg, "_take_step_adaptive",
                        _keep(PDHG_ITERATES, pdhg._take_step_adaptive))
    monkeypatch.setattr(mirror_prox, "_take_step",
                        _keep(("current_primal", "current_dual"),
                              mirror_prox._take_step))
    result = _run(cell, {"iteration_limit": 200})
    assert not result["correct"]
    assert result["checks"]["not_optimal"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    def shift(out):
        out.primal_solution[0] += 1e-2
    _alter(monkeypatch, shift)
    result = _run(cell)
    assert _limit_failed(result, "rel_primal_residual")


@pytest.mark.parametrize("cell", CELLS)
def test_uniform_answer_of_the_right_mass(cell, monkeypatch):
    """x = 1/n, y = 0: the mass row holds, the shape is wrong."""
    def uniform(out):
        out.primal_solution[:] = 1.0 / out.primal_solution.size
        out.dual_solution[:] = 0.0
    _alter(monkeypatch, uniform)
    assert _limit_failed(_run(cell), "primal_l1_error")


@pytest.mark.parametrize("cell", CELLS)
def test_another_lps_answer_of_the_right_mass(cell, monkeypatch):
    """Each answer replaced by the exact answer of the LP on the same
    graph at damping 0.95: a mixed-up or stale answer."""
    config = {**registry.config(registry.cell(cell)["config"]),
              **SMALL["config"]}
    other = pagerank.pagerank_lp(config["num_nodes"],
                                 config["approx_num_edges"], 0.95,
                                 config["graph_seed"])
    x_other = reference.solution(other, 0.95)
    assert abs(x_other.sum() - 1.0) < 1e-9

    def mixed_up(out):
        out.primal_solution[:] = x_other
    _alter(monkeypatch, mixed_up)
    assert _limit_failed(_run(cell), "primal_l1_error")

