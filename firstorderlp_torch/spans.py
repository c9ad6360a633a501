"""The port's own measurement: counters of what the solvers did, counted
at the host, and named spans on torch.profiler's clock.

`span(name)` records a host range named `name` only while a profiler is
collecting (one started by the caller, or the solvers'
`profiler_trace_dir`), so its ranges share the profiler's clock with
the device's kernels and copies; with no profiler it costs one check
and enters nothing. The range is a function-scoped record
(torch._C._profiler._RecordFunctionFast), not a user annotation
(torch.profiler.record_function): the profiler gives a user annotation
a second, device-side range over the kernels launched inside it, which
a reading of the device's busy time from its records would count as
device work. `timed(name)` is a span that also adds its host-clock
seconds to COUNTS[<last part of the name>_seconds]: for the cold paths
only (ingest, graph capture).

Spans wrap host calls, never the functions a CUDA graph captures. Every
name starts with `folp.`:

- folp.solve: a solve's loop (`optimize` once the problem is prepared,
  or a fleet's whole solve, batch._solve_fleet); its argument `solve`
  is the solve's number (COUNTS["solves"]), in a trace that records
  shapes;
- folp.dispatch: one dispatch of segments (`_run_segments`, or a
  fleet's `evaluations_per_dispatch` segments and its read-back of the
  lanes' reasons);
- folp.load, folp.unload: the state into and out of the segments'
  buffers (ops/graphs.SegmentRunner), the evaluation's result copied out
  with the unload;
- folp.evaluate: one evaluation (a graph replay, or eager; a fleet's
  evaluation of every lane);
- folp.trials: a run of steps with no read-back between them (a PDHG
  round of trials, a Mirror Prox segment's iterations, a fleet's lane
  steps up to its next read-back);
- folp.read_back: a host wait on a segment's values (in a fleet also
  the "any lane active" flag of a trial and a dispatch's reasons);
- folp.finalize: the host's statistics after a dispatch (bound
  estimates, the evaluation's scalars, `to_host_stats`);
- folp.unscale: the answer unscaled and copied to the host (a fleet's
  answers, every lane's, batch._outputs);
- folp.ingest.rescale, folp.ingest.to_device, folp.ingest.step_size:
  `prepare_problem`'s host rescaling, device copy, and step size with
  the primal weight and the initial state;
- folp.ingest.fleet: a fleet's whole ingest
  (batch.prepare_shared_pattern_fleet);
- folp.capture: the capture of a solver's segment graphs, warm-up
  included.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

# Counted at the host: segments, evaluations, steps (trials or
# iterations) launched, read-backs (every host wait on a segment's
# values, the evaluations' included), graph replays of steps and of
# evaluations, loads into and unloads out of the buffers, captures,
# solves, the lanes a fleet's trials compute (B a trial, ended lanes
# included), the fleet's trials that ran as the fused lane trial
# (batch.fused_lane_step), and the seconds of the timed spans (capture
# warm-up included).
COUNTS: Dict[str, float] = {
    "segments": 0,
    "evaluations": 0,
    "steps": 0,
    "read_backs": 0,
    "replays": 0,
    "eval_replays": 0,
    "loads": 0,
    "unloads": 0,
    "captures": 0,
    "solves": 0,
    "lane_steps": 0,
    "fused_lane_trials": 0,
    "capture_seconds": 0.0,
    "rescale_seconds": 0.0,
    "to_device_seconds": 0.0,
    "step_size_seconds": 0.0,
    "fleet_seconds": 0.0,
}

_collecting = torch._C._autograd._profiler_enabled
_NOTHING = contextlib.nullcontext()


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def span(name: str, args: Optional[dict] = None):
    """A context: a profiler record named `name`, with `args` as its
    keyword values, while a profiler is collecting; else nothing."""
    if _collecting():
        if args is None:
            return torch._C._profiler._RecordFunctionFast(name)
        return torch._C._profiler._RecordFunctionFast(name, (), args)
    return _NOTHING


@contextlib.contextmanager
def timed(name: str):
    """span(name), its host-clock seconds added to
    COUNTS[<last part of name>_seconds]."""
    key = name.rsplit(".", 1)[-1] + "_seconds"
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        COUNTS[key] += time.perf_counter() - t0
