"""Finds the benchmark's parts by name: a cell in BENCHMARK.json, its
configuration in configs/<name>.json, its traffic in
traffic/<name>.json, and the code of a generator, an entry and a
per-layer metric in generators/, entries/ and metrics/<name>.py. A
later cell adds files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class UnknownName(KeyError):
    """A name that no file or entry of the benchmark carries."""


def _path(kind: str, name: str, suffix: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise UnknownName(f"not a {kind} name: {name!r}")
    path = os.path.join(HERE, kind, name + suffix)
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind[:-1] if kind.endswith('s') else kind}"
                          f" named {name!r} ({os.path.relpath(path, REPO)})")
    return path


def benchmark(path: str = os.path.join(REPO, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    for entry in (bench or benchmark())["workloads"]:
        if entry["name"] == name:
            return entry
    raise UnknownName(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str):
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"lpbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(name: str):
    return _module("generators", name)


def entry(name: str):
    return _module("entries", name)


def metric(name: str):
    return _module("metrics", name)


def per_layer(name: str, bench: dict | None = None) -> list:
    """The per-layer metrics BENCHMARK.json reports in cell `name`: those
    that list it, and those that list no cells and move an end-to-end
    metric the cell reports."""
    bench = bench or benchmark()
    reports = {m["name"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in reports]


def end_to_end(name: str, bench: dict | None = None) -> list:
    bench = bench or benchmark()
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]
