"""Runs one cell once: set-up (inputs from the seed, the program's
ingest, one warm solve), the measured window, then the reference's
judgement of every answer of the window.

The last line of standard output is the result:
{"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
"checks"}; the lines before it on standard output carry what the run
counted, and the last lines of standard error each number judged
beside its limit. With --trace 0 the metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a torch.profiler
trace of the window.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time

from lpbench import registry
from lpbench.reference import judge

FORBIDDEN = ("jax", "jaxlib", "flax", "firstorderlp_tpu")


def forbidden_modules(modules=None) -> list:
    """Modules loaded whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _parser():
    p = argparse.ArgumentParser(prog="lpbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


class Spans:
    """Host-clock spans of the set-up's steps, each ended by a device
    synchronize."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = time.perf_counter() - t0


def _card_line() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _rounding(solves, verdict) -> dict:
    """The most by which the reference's f64 residual exceeds the
    solver's own f32 reading of it, over the answers of `solves`."""
    worst = {}
    for s in solves:
        for (index, status, x, y), reported in zip(s["answers"],
                                                   s["reported"]):
            res = verdict["residuals"].get(
                (int(index), judge.digest(status, x, y)), {})
            for name, value in res.items():
                if name in reported:
                    worst[name] = max(worst.get(name, -float("inf")),
                                      value - reported[name])
    return worst


def run_cell(name, seed, seconds, trace, device, t_start, bench=None,
             overrides=None):
    """Runs cell `name` on `device` and returns (result, details).
    `overrides`: {"config": {...}, "traffic": {...}} merged over the
    cell's files (the tests' small sizes)."""
    import torch

    from lpbench import roofline
    from lpbench import tracing

    bench = bench or registry.benchmark()
    cell = registry.cell(name, bench)
    overrides = overrides or {}
    config = {**registry.config(cell["config"]),
              **overrides.get("config", {})}
    traffic = {**registry.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    e2e = registry.end_to_end(name, bench)
    layers = registry.per_layer(name, bench)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans(sync)
    from firstorderlp_torch import compile_meter

    generator = registry.generator(config["generator"])
    with spans("generate_s"):
        instance = generator.make(config, seed)
    entry = registry.entry(traffic["entry"])
    session = entry.Session(config, traffic, instance, device, spans)
    first = session.first
    solves = []
    sync()
    with tracing.profiled(bool(trace)) as traced:
        # the window opens once the profiler, when on, has started
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        ends = []
        while True:
            with torch.profiler.record_function(tracing.SOLVE):
                solves.append(session.solve())
            sync()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        wall = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    session_lp_of, expected = session.lp_of, session.expected
    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program's state
    # is freed
    t_judge = time.perf_counter()
    solution_of = None
    if hasattr(generator, "solution"):
        known = {}

        def solution_of(index):
            if index not in known:
                known[index] = generator.solution(
                    config, session_lp_of(index), device)
            return known[index]
    verdict = judge.judge([s["answers"] for s in solves], expected,
                          session_lp_of, float(traffic["residual_limit"]),
                          solution_of, float(traffic["l1_error_limit"]))
    judge_s = time.perf_counter() - t_judge
    first_digests = {judge.digest(st, x, y)
                     for _, st, x, y in first["answers"]}
    window_digests = {judge.digest(st, x, y)
                      for s in solves for _, st, x, y in s["answers"]}

    iterations = sum(s["iterations"] for s in solves)
    m, n = instance.shape
    nnz = instance.constraint_matrix.nnz
    kind_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
                  "count": 1, "memory_peak_bytes": int(memory_peak)}
    record = {
        "spans": spans.seconds, "solves": solves,
        "shape": (m, n, nnz), "device_kind": kind_name,
        "trace": traced.get("summary"),
    }
    metrics = {}
    if trace:
        summary = traced["summary"]
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        for spec in layers:
            value = registry.metric(spec["name"]).read(record)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        for spec in e2e:  # setup_s, and the window's iterations a second
            value = setup_s if spec["name"] == "setup_s" else (
                iterations / wall)
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result = {
        "correct": judge.passed(verdict["checks"]),
        "attempted": verdict["attempted"],
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": device_rec,
    }
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = verdict["checks"]
    details = {
        "workload": name, "seed": seed, "seconds": seconds, "trace": trace,
        "card": _card_line() if cuda else None,
        "solves": len(solves), "window_s": wall, "setup_s": setup_s,
        "iterations": [s["iterations"] for s in solves],
        "solve_s": [b - a for a, b in zip([0.0] + ends, ends)],
        "kkt_passes": [s["kkt_passes"] for s in solves],
        "first_solve_iterations": first["iterations"],
        "spans_s": spans.seconds,
        "compile_s": compile_meter.backend_compile_seconds(),
        "library_load_s": compile_meter.compile_seconds()
        - compile_meter.backend_compile_seconds(),
        "distinct_answers": len(window_digests),
        "window_bits_as_warm_solve": window_digests <= first_digests,
        "answers_judged": len(verdict["residuals"]), "judge_s": judge_s,
        "f64_minus_solver_reading": _rounding(solves[:1], verdict),
        "m": m, "n": n, "nnz": nnz,
        "window_bytes": roofline.pass_bytes(m, n, nnz)
        * sum(s["kkt_passes"] for s in solves),
    }
    if trace:
        details["host_runtime_calls"] = summary["host_runtime_calls"]
    return result, details


def main(argv, t_start) -> int:
    args = _parser().parse_args(argv)
    bench = registry.benchmark()
    try:
        cell = registry.cell(args.workload, bench)
    except registry.UnknownName as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, details = run_cell(args.workload, args.seed, args.seconds,
                               args.trace, "cuda", t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(details), flush=True)
    for key, check in result["checks"].items():
        print(f"{key} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
