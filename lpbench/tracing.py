"""The traced run's records: torch.profiler over the window, reduced to
the device's busy seconds (the union of its kernel and copy intervals),
the window's length, the host's CUDA runtime and driver calls, the
device operations that took most time, and the idle gaps by what the
host was doing (the innermost host operation under each gap's middle).
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import re

import torch

WINDOW = "lpbench.window"
SOLVE = "lpbench.solve"
# the host's calls into CUDA: by the profiler's kind of record, or by name
# (cudaLaunchKernel, cudaGraphLaunch, cuLaunchKernel, ...)
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this many characters


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a dict that holds, once the block has ended and when
    `enabled`, the reduced trace under "summary"."""
    out = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    out["summary"] = summarize(prof.profiler.kineto_results.events())


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def summarize(events) -> dict:
    window = None
    device, host = [], []
    runtime = []
    for e in events:
        name = e.name()
        # the record's kind where this version of torch tells it
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; not the annotations' device spans
            if "annotation" not in kind and name not in (WINDOW, SOLVE):
                device.append((start, end, name))
        elif name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, name))
            if kind in RUNTIME_KINDS or _RUNTIME.match(name):
                runtime.append(start)
    if window is None:
        raise RuntimeError("the trace holds no window")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    busy = _union((s, e) for s, e, _ in device)
    busy_ns = sum(e - s for s, e in busy)
    by_op = collections.Counter()
    for s, e, n in device:
        by_op[n[:NAME_CHARS]] += e - s
    runtime_calls = sum(1 for s in runtime if w0 <= s < w1)
    # gaps between device intervals inside the window, by host op
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # the innermost host op under each gap's middle: of the ops that
    # cover it, the one that started last (a sweep over the middles)
    host.sort()
    by_host = collections.Counter()
    heap, k = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            s, e, n = host[k]
            heapq.heappush(heap, (-s, e, n))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        by_host[heap[0][2][:NAME_CHARS] if heap else "(no host op)"] += (
            g1 - g0)
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "host_runtime_calls": runtime_calls,
        "device_ops": [[n, ns / 1e9] for n, ns in by_op.most_common(TOP)],
        "idle_gaps": [[n, ns / 1e9] for n, ns in by_host.most_common(TOP)],
    }
