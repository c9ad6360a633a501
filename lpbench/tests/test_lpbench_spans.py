"""lpbench/span_split.py on synthetic profiler records: a device interval
is credited to the innermost `folp.` span around its launch, a gap by
its middle, the split closes against busy and idle time, and the
program's spans leave lpbench/tracing.summarize's device and call
counts, and the six accepted per-layer metrics' readings, as they were.
The new reader (metrics/rescale_s.lp.py) reads the program's counter
and gives None without it."""

import sys

import pytest
import torch

from lpbench import registry, span_split, tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
ACCEPTED = ["ingest_s.lp", "first_solve_s.lp", "host_calls_per_iter.lp",
            "idle_share.lp", "device_ms_per_iter.lp", "spmv_roofline.lp"]


class Ev:
    def __init__(self, name, start, end, device=False, kind="cpu_op",
                 corr=0, linked=0):
        self._v = (name, start, end - start, CUDA if device else CPU, kind,
                   corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def runtime(name, at, corr):
    return Ev(name, at, at + 4, kind="cuda_runtime", corr=corr)


def kernel(name, start, end, corr, linked=0):
    return Ev(name, start, end, device=True, kind="kernel", corr=corr,
              linked=linked)


# the program's spans: function-scoped host records, with no device-side
# range of their own
SPANS = [
    Ev("folp.solve", 100, 900),
    Ev("folp.dispatch", 150, 700),
    Ev("folp.evaluate", 160, 300),
    Ev("folp.trials", 320, 600),
    Ev("folp.read_back", 610, 695),
    Ev("folp.finalize", 720, 800),
    Ev("folp.read_back", 730, 790),
]
BASE = [
    Ev(tracing.WINDOW, 0, 1000, kind="user_annotation"),
    Ev(tracing.SOLVE, 95, 905, kind="user_annotation"),
    runtime("cudaLaunchKernel", 50, 4),
    runtime("cudaGraphLaunch", 170, 1),
    runtime("cudaGraphLaunch", 330, 2),
    Ev("aten::add", 400, 410, corr=7),
    runtime("cudaMemcpyAsync", 615, 3),
    runtime("cudaMemcpyAsync", 735, 5),
    kernel("setup_kernel", 60, 90, 4),
    kernel("eval_kernel", 180, 280, 1),
    kernel("trial_kernel", 340, 590, 2),
    kernel("trial_kernel", 350, 400, 2),  # overlaps: counted once
    kernel("Memcpy DtoH", 620, 640, 3),
    kernel("Memcpy DtoH", 740, 760, 5),
    kernel("add_kernel", 850, 870, 98, linked=7),  # by its operator
    kernel("lost_kernel", 950, 980, 99),  # matches nothing
]


def test_device_by_innermost_span_and_gaps_by_their_middle():
    parts = span_split.split(BASE + SPANS)
    by = parts["by_span"]
    assert by["folp.evaluate"] == {"count": 1, "device_s": 100e-9,
                                   "idle_s": 0.0, "idle_within_s": 0.0,
                                   "runtime_calls": 1, "host_s": 140e-9,
                                   "top_ops": [["eval_kernel", 100e-9]]}
    # the trial's two intervals as their union, the add by its operator
    assert by["folp.trials"]["device_s"] == pytest.approx(270e-9)
    assert by["folp.trials"]["count"] == 1
    # by name the overlapping intervals add up
    assert by["folp.trials"]["top_ops"] == [["trial_kernel", 300e-9],
                                            ["add_kernel", 20e-9]]
    assert by["folp.read_back"]["host_s"] == pytest.approx(145e-9)
    assert by["folp.read_back"]["count"] == 2
    assert by["folp.read_back"]["device_s"] == pytest.approx(40e-9)
    assert by["folp.read_back"]["runtime_calls"] == 2
    # gap 280-340 (middle 310) and 590-620 (605): in the dispatch, no
    # deeper span; 640-740 (690): in the read-back
    assert by["folp.dispatch"]["idle_s"] == pytest.approx(90e-9)
    assert by["folp.read_back"]["idle_s"] == pytest.approx(100e-9)
    assert by["folp.dispatch"]["idle_within_s"] == pytest.approx(190e-9)
    # 90-180 (135) and 760-850 (805): the solve's own
    assert by["folp.solve"]["idle_s"] == pytest.approx(180e-9)
    assert by["folp.solve"]["idle_within_s"] == pytest.approx(370e-9)
    assert by["folp.finalize"]["idle_s"] == 0.0
    assert parts["unmatched_device_s"] == pytest.approx(30e-9)
    assert parts["device_outside_spans_s"] == pytest.approx(30e-9)
    # 0-60, 870-950 and 980-1000: outside every span and every solve
    assert parts["idle_outside_spans_s"] == pytest.approx(160e-9)
    assert parts["idle_outside_solve_s"] == pytest.approx(160e-9)


def test_split_closes_against_busy_and_idle_time():
    summary = tracing.summarize(BASE + SPANS)
    parts = span_split.split(BASE + SPANS)
    close = span_split.closure(summary, parts)
    assert close["device_over_busy"] == pytest.approx(1.0)
    assert close["idle_over_window_idle"] == pytest.approx(1.0)
    assert close["unmatched_share"] == pytest.approx(30 / 470)


def test_readings_of_the_split():
    parts = span_split.split(BASE + SPANS)
    got = span_split.readings(
        parts, {"steps": 10, "segments": 2, "solves": 1},
        {"rescale_seconds": 20.5, "capture_seconds": 0.0})
    assert got["eval_device_ms"] == pytest.approx(1e-4)
    assert got["trial_device_ms"] == pytest.approx(270e-9 * 1e3 / 10)
    assert got["dispatch_idle_ms"] == pytest.approx(190e-9 * 1e3 / 2)
    assert got["solve_host_idle_ms"] == pytest.approx(180e-9 * 1e3)
    assert got["rescale_seconds"] == 20.5
    assert "capture_seconds" not in got
    # no spans in the trace, no counts: nothing to read
    assert span_split.readings(span_split.split(BASE), {}, {}) == {}


@pytest.mark.parametrize("key", ["busy_s", "window_s",
                                 "host_runtime_calls", "device_ops"])
def test_spans_leave_the_summary_as_it_was(key):
    assert tracing.summarize(BASE + SPANS)[key] == tracing.summarize(
        BASE)[key]


def test_spans_only_rename_the_idle_gaps():
    def total(s):
        return sum(v for _, v in s["idle_gaps"])

    with_spans, without = tracing.summarize(BASE + SPANS), tracing.summarize(
        BASE)
    assert total(with_spans) == pytest.approx(total(without))
    assert {n for n, _ in with_spans["idle_gaps"]} & {
        "folp.dispatch", "folp.solve", "folp.read_back"}


@pytest.mark.parametrize("name", ACCEPTED)
def test_accepted_metrics_read_the_same(name):
    def record(events):
        return {"spans": {"ingest_s.lp": 30.0, "first_solve_s.lp": 1.3},
                "solves": [{"iterations": 520, "kkt_passes": 1100.0}],
                "shape": (1000001, 1000000, 7999982),
                "device_kind": "NVIDIA H100 80GB HBM3",
                "trace": tracing.summarize(events)}

    metric = registry.metric(name)
    assert metric.read(record(BASE + SPANS)) == metric.read(record(BASE))


def test_rescale_reader(monkeypatch):
    from firstorderlp_torch import spans

    metric = registry.metric("rescale_s.lp")
    monkeypatch.setitem(spans.COUNTS, "rescale_seconds", 21.5)
    assert metric.read({}) == 21.5
    monkeypatch.setitem(spans.COUNTS, "rescale_seconds", 0.0)
    assert metric.read({}) is None
    # a program without the counter
    monkeypatch.setitem(sys.modules, "firstorderlp_torch.spans", None)
    assert metric.read({}) is None


def test_a_device_side_range_of_a_span_is_not_device_work():
    """Should a span come with a device-side range (a user annotation
    does), the split does not count it."""
    ranged = SPANS + [Ev("folp.trials", 340, 590, device=True,
                         kind="gpu_user_annotation")]
    assert span_split.split(BASE + ranged) == span_split.split(
        BASE + SPANS)


def test_split_needs_the_window():
    with pytest.raises(RuntimeError):
        span_split.split(SPANS)
