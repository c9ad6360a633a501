"""The traced window split by the program's own spans (the `folp.` ranges
of firstorderlp_torch/spans.py), and a run of a cell that reports it.

`split(events)` reduces torch.profiler's records, with one sort and one
sweep, to each span name's

- count: the spans of that name that start in the window;
- device_s: the union of the device intervals (kernels, copies, sets)
  whose launch lies inside a span of that name, the innermost `folp.`
  span at the launch: the launching runtime call, matched by its
  correlation id, or else the operator the interval is linked to
  (`linked_correlation_id`);
- idle_s: the window's idle gaps (between the device's busy intervals)
  whose middle lies inside that innermost span; idle_within_s: those
  whose middle lies inside a span of that name at any depth;
- runtime_calls: the CUDA runtime and driver calls that start inside it;
- host_s: the host seconds of the spans counted;
- top_ops: the device operations that took most of its device seconds
  (summed by name, not as a union);

and the device seconds no launch matched, and the idle seconds outside
every `folp.solve` and outside every `folp.` span. The gaps and the
busy intervals are those of lpbench/tracing.summarize, which this module
leaves as it is.

    python3 lpbench/span_split.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

runs the cell as lpbench/run.py does, on one CUDA device, and prints
one JSON line: the result, the run's counts, the program's counters at
the end of set-up and their change over the window, and with --trace 1
the split with its closure against busy and idle time and the
readings it gives (device ms an evaluation and a trial, idle ms a
dispatched segment and a solve's own host work).
"""

from __future__ import annotations

import time

T_START = time.time()

import collections  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of this folder, as lpbench/run.py
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    os.environ.pop("FOLP_TILE_ALIGNED", None)

PREFIX = "folp."
SOLVE = "folp.solve"
DISPATCH = "folp.dispatch"
TOP_OPS = 5


def _kind(e) -> str:
    return str(e.activity_type()) if hasattr(e, "activity_type") else ""


def _chain(stack, t):
    """The spans of the sweep's stack that cover t, outermost first."""
    while stack and stack[-1][1] < t:
        stack.pop()
    return [s for s in stack if s[1] >= t]


def split(events) -> dict:
    import torch

    from lpbench import tracing

    window = None
    device, spans, runtime = [], [], []
    runtime_at, op_at = {}, {}
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        kind = _kind(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if ("annotation" not in kind and not name.startswith(PREFIX)
                    and name not in (tracing.WINDOW, tracing.SOLVE)):
                device.append((start, end, e.correlation_id(),
                               e.linked_correlation_id(), name))
        elif name == tracing.WINDOW:
            window = (start, end)
        elif name.startswith(PREFIX):
            spans.append((start, end, name))
        elif kind in tracing.RUNTIME_KINDS or tracing._RUNTIME.match(name):
            runtime.append(start)
            runtime_at[e.correlation_id()] = start
        elif e.correlation_id() > 0:
            op_at[e.correlation_id()] = start
    if window is None:
        raise RuntimeError("the trace holds no window")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), c, lc, n)
              for s, e, c, lc, n in device if e > w0 and s < w1]
    busy = tracing._union((s, e) for s, e, *_ in device)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    # one sweep over every point to place: (time, what, payload)
    points = []
    unmatched = []
    for s, e, corr, linked, name in device:
        at = runtime_at.get(corr) if corr > 0 else None
        if at is None and linked > 0:
            at = op_at.get(linked)
        if at is None:
            unmatched.append((s, e))
        else:
            points.append((at, 0, (s, e, name)))
    points += [(t, 1, None) for t in runtime if w0 <= t < w1]
    points += [((g0 + g1) // 2, 2, g1 - g0) for g0, g1 in gaps]
    points.sort(key=lambda p: (p[0], p[1]))
    spans.sort(key=lambda s: (s[0], -s[1]))

    intervals = collections.defaultdict(list)
    ops = collections.defaultdict(collections.Counter)
    calls = collections.Counter()
    idle = collections.Counter()
    within = collections.Counter()
    outside_solve = outside_spans = 0
    stack, k = [], 0
    for t, what, payload in points:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        chain = _chain(stack, t)
        inner = chain[-1][2] if chain else None
        if what == 0:
            intervals[inner].append(payload[:2])
            ops[inner][payload[2][:tracing.NAME_CHARS]] += (payload[1]
                                                           - payload[0])
        elif what == 1:
            calls[inner] += 1
        else:
            idle[inner] += payload
            for name in {s[2] for s in chain}:
                within[name] += payload
            if inner is None:
                outside_spans += payload
            if not any(s[2] == SOLVE for s in chain):
                outside_solve += payload
    counts = collections.Counter(n for s, _, n in spans if w0 <= s < w1)
    host = collections.Counter()
    for s, e, n in spans:
        if w0 <= s < w1:
            host[n] += e - s
    names = sorted((set(counts) | set(intervals) | set(idle)
                    | set(calls)) - {None})

    def seconds(ivs):
        return sum(e - s for s, e in tracing._union(ivs)) / 1e9

    return {
        "by_span": {n: {"count": counts[n],
                        "device_s": seconds(intervals[n]),
                        "idle_s": idle[n] / 1e9,
                        "idle_within_s": within[n] / 1e9,
                        "runtime_calls": calls[n],
                        "host_s": host[n] / 1e9,
                        "top_ops": [[op, ns / 1e9] for op, ns in
                                    ops[n].most_common(TOP_OPS)]}
                    for n in names},
        "device_outside_spans_s": seconds(intervals[None]),
        "unmatched_device_s": seconds(unmatched),
        "idle_outside_solve_s": outside_solve / 1e9,
        "idle_outside_spans_s": outside_spans / 1e9,
    }


def closure(summary: dict, parts: dict) -> dict:
    """How the split adds up: device seconds by span (those launched
    outside every span included) plus the unmatched ones against the
    busy seconds, idle by span plus idle outside the spans against the
    window's idle seconds."""
    by = parts["by_span"].values()
    device = (sum(v["device_s"] for v in by)
              + parts["device_outside_spans_s"]
              + parts["unmatched_device_s"])
    idle = sum(v["idle_s"] for v in by) + parts["idle_outside_spans_s"]
    window_idle = summary["window_s"] - summary["busy_s"]
    return {
        "device_s": device, "busy_s": summary["busy_s"],
        "device_over_busy": device / summary["busy_s"],
        "unmatched_share": parts["unmatched_device_s"] / summary["busy_s"],
        "idle_s": idle, "window_idle_s": window_idle,
        "idle_over_window_idle": idle / window_idle if window_idle else None,
    }


def readings(parts: dict, window_counts: dict, setup_counts: dict) -> dict:
    """What the split gives a solve's layers: device ms an evaluation
    (over the folp.evaluate spans) and a trial (over the window's
    steps), idle ms a dispatched segment (inside folp.dispatch) and a
    solve's own host work (inside folp.solve, outside folp.dispatch),
    and the ingest's host seconds (the counters at the end of set-up).
    A reading whose spans or counts are missing is left out."""
    by = parts["by_span"]
    out = {}

    def put(name, value, count):
        if value is not None and count:
            out[name] = 1000.0 * value / count

    get = (lambda n, key: by[n][key] if n in by else None)
    put("eval_device_ms", get("folp.evaluate", "device_s"),
        get("folp.evaluate", "count"))
    put("trial_device_ms", get("folp.trials", "device_s"),
        window_counts.get("steps"))
    put("dispatch_idle_ms", get(DISPATCH, "idle_within_s"),
        window_counts.get("segments"))
    if SOLVE in by:
        put("solve_host_idle_ms",
            by[SOLVE]["idle_within_s"] - (get(DISPATCH, "idle_within_s")
                                          or 0.0),
            window_counts.get("solves"))
    for key in ("rescale_seconds", "to_device_seconds",
                "step_size_seconds", "capture_seconds"):
        if setup_counts.get(key):
            out[key] = setup_counts[key]
    return out


def _counts():
    try:
        from firstorderlp_torch.spans import COUNTS
    except ImportError:
        return {}
    return dict(COUNTS)


@contextlib.contextmanager
def _split_window(tracing, seen):
    """tracing.profiled and tracing.summarize as the harness calls them,
    the program's counters taken as the window opens and closes and the
    summary given the split."""
    profiled, summarize = tracing.profiled, tracing.summarize

    def summarize_split(events):
        events = list(events)
        out = summarize(events)
        seen["split"] = split(events)
        return out

    @contextlib.contextmanager
    def profiled_counted(enabled):
        with profiled(enabled) as out:
            seen["setup"] = _counts()
            yield out
            seen["window_end"] = _counts()

    tracing.profiled, tracing.summarize = profiled_counted, summarize_split
    try:
        yield
    finally:
        tracing.profiled, tracing.summarize = profiled, summarize


def main(argv) -> int:
    import argparse
    import json

    import torch

    from lpbench import harness, tracing

    p = argparse.ArgumentParser(prog="lpbench/span_split.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seen = {}
    with _split_window(tracing, seen):
        result, details = harness.run_cell(
            args.workload, args.seed, args.seconds, args.trace, "cuda",
            T_START)
    setup = seen.get("setup", {})
    end = seen.get("window_end", {})
    window = {k: end[k] - setup.get(k, 0) for k in end}
    line = {
        "workload": args.workload, "seed": args.seed, "trace": args.trace,
        "card": details["card"], "correct": result["correct"],
        "metrics": result["metrics"], "setup_s": details["setup_s"],
        "window_s": details["window_s"], "solves": details["solves"],
        "iterations": sum(details["iterations"]),
        "spans_s": details["spans_s"], "compile_s": details["compile_s"],
        "library_load_s": details["library_load_s"],
        "window_bits_as_warm_solve": details["window_bits_as_warm_solve"],
        "counts_setup": setup, "counts_window": window,
    }
    if "split" in seen:
        summary = {"busy_s": result["device"]["busy_s"],
                   "window_s": result["device"]["window_s"]}
        line["spans"] = seen["split"]
        line["closure"] = closure(summary, seen["split"])
        line["readings"] = readings(seen["split"], window, setup)
        line["breakdown"] = result.get("breakdown")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
