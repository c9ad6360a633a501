"""The harness finds every part BENCHMARK.json names by its name, and
refuses a name it does not carry."""

import json
import os
import re

import pytest

from lpbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    spec = registry.cell(cell)
    config = registry.config(spec["config"])
    traffic = registry.traffic(spec["traffic"])
    assert registry.generator(config["generator"]).make
    assert registry.entry(traffic["entry"]).Session
    assert registry.end_to_end(cell)
    assert any(m["name"] == "setup_s" for m in registry.end_to_end(cell))
    assert registry.per_layer(cell)
    assert traffic["residual_limit"] >= traffic["tolerance"]
    assert 0 < traffic["l1_error_limit"] < 1


@pytest.mark.parametrize("spec", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_metric_finds_its_reader(spec):
    reader = registry.metric(spec["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
        spec["layer"], spec["unit"], spec["moves"])
    assert callable(reader.read)


@pytest.mark.parametrize("kind,name", [
    ("cell", "no-such-cell"), ("config", "no-such-config"),
    ("traffic", "no-such-traffic"), ("metric", "no_such_metric"),
    ("generator", "no_such_generator"), ("entry", "no_such_entry"),
    ("config", "../BENCHMARK"), ("metric", "a/b")])
def test_unknown_names_are_refused(kind, name):
    with pytest.raises(registry.UnknownName):
        getattr(registry, kind)(name)


def test_configs_match_benchmark_json():
    for spec in BENCH["configs"]:
        with open(os.path.join(registry.REPO, spec["file"])) as f:
            config = json.load(f)
        assert config["name"] == spec["name"]
        assert config["source"] == spec["source"]
        assert config["reduced"] == spec["reduced"]
        assert spec["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_names_units_and_shape_of_benchmark_json():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    cells_runs = 2 + 14 * 24
    allowance = cells_runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert allowance <= 43200
