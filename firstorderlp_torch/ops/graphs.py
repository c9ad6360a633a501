"""CUDA graphs of the solvers' segments: the port's counterpart of the
JAX package's `jit` + `lax.while_loop` over a dispatch of segments
(`_run_segments` there).

A segment is one evaluation (termination check and restart) and the
steps up to the next evaluation iteration. `SegmentGraphs` captures both
on one set of static buffers: the state's tensors, and two extra 0-d
buffers, the elapsed time the evaluation reads and the segment's first
iteration, which the evaluation writes and the step reads. Each graph
ends by copying its new values into the buffers it read, so replays
chain on the current stream with no host work between them, and the
state stays in the buffers for a whole dispatch: it is loaded once and
copied back out once (`SegmentRunner`).

Which bundles are replayed is decided by type, in `graphable`: the f32
kernel operator (`RoutedOp`) on a CUDA device and an LP, for the scaled
copy (the step) and the original copy (the evaluation's statistics).
Everything else runs the same evaluation and steps eagerly, on the same
kind of buffers (`StaticState`). A capture that fails raises; nothing
falls back to the eager path.

A graph belongs to the tensors it captured: it is cached on the device
bundle (`DeviceScaledQp.graphs`), which a bundle made by
`dataclasses.replace` (refine's shifted sub-solves) does not share.
Each replay credits the launches the capture recorded to
`ops/routed.LAUNCHES`, so the launch counts stay those of the eager
path, plus one evaluation and one step that a capture's warm-up runs
(real launches, on buffers that the first `load` overwrites).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import spans
from . import routed


def graphable(problem) -> bool:
    """Whether `problem` (a DeviceQp) runs inside a CUDA graph: its
    constraint operator is a RoutedOp on a CUDA device, it is an LP and
    its precision is f32 (the fused trial's condition,
    models/pdhg._fused). The CPU, CsrOp and DenseOp (f64),
    QPs and ShardedRoutedOp (meshes, process groups) run eagerly."""
    op = problem.constraint_matrix
    return (
        isinstance(op, routed.RoutedOp)
        and op.a.device.type == "cuda"
        and problem.objective_matrix is None
        and problem.objective_vector.dtype == torch.float32
    )


def bundle_graphable(bundle) -> bool:
    """Whether a solver's segments on `bundle` (a DeviceScaledQp) are
    replayed: the step's copy and the evaluation's copy both graphable."""
    return graphable(bundle.scaled) and graphable(bundle.original)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    """ops/routed.LAUNCHES less `before`, the kernels that moved only."""
    return {k: routed.LAUNCHES[k] - n for k, n in before.items()
            if routed.LAUNCHES[k] != n}


def _leaves(value) -> list:
    """The tensors of a value, through nested dataclasses and tuples."""
    if isinstance(value, torch.Tensor):
        return [value]
    if dataclasses.is_dataclass(value):
        return [t for f in dataclasses.fields(value)
                for t in _leaves(getattr(value, f.name))]
    if isinstance(value, tuple):
        return [t for v in value for t in _leaves(v)]
    raise TypeError(f"a graphed segment carries tensors only, got {value!r}")


def _rebuild(value, tensors):
    """`value` with its tensors taken in order from the iterator."""
    if isinstance(value, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(value):
        return dataclasses.replace(value, **{
            f.name: _rebuild(getattr(value, f.name), tensors)
            for f in dataclasses.fields(value)
        })
    return type(value)(*(_rebuild(v, tensors) for v in value))


class StaticState:
    """A state's tensors and the extra buffers as static tensors, and
    the evaluation and the step applied to them in place: the part of
    the graphs that runs the same on any device (the capture and its
    warm-up call `apply`).

    `evaluate(state, *extras) -> (state, result)` and
    `step(state, *extras) -> state` read the state and the extras and
    return new tensors; `apply` copies the new state into the buffers.
    A new tensor must have its buffer's dtype and must not be another
    field's buffer (sequential copies would read it overwritten). The
    evaluation's result is kept; its tensors that are buffers are
    cloned, since a later step changes the buffers."""

    def __init__(self, state, extras: Sequence[torch.Tensor]):
        self.buffers = [t.clone() for t in _leaves(state)]
        self.extras = [e.clone() for e in extras]
        self.state = _rebuild(state, iter(self.buffers))

    def apply(self, fn: Callable, evaluation: bool = False):
        out = fn(self.state, *self.extras)
        new, result = out if evaluation else (out, None)
        ids = {id(b) for b in self.buffers}
        for buf, t in zip(self.buffers, _leaves(new)):
            if t is buf:
                continue
            if id(t) in ids or t.dtype != buf.dtype:
                raise RuntimeError(
                    "a graphed segment must return new tensors of its "
                    "fields' types")
            buf.copy_(t)
        if result is None:
            return None
        return _rebuild(result, iter([
            t.clone() if id(t) in ids else t for t in _leaves(result)
        ]))

    def load(self, state) -> None:
        """Copies `state`'s tensors into the buffers."""
        for buf, t in zip(self.buffers, _leaves(state)):
            buf.copy_(t)

    def unload(self):
        """The state copied out of the buffers."""
        return _rebuild(self.state, iter([t.clone() for t in self.buffers]))


class SegmentGraphs:
    """A solver's evaluation and step (see StaticState) captured once as
    two CUDA graphs on one StaticState. The warm-up (one evaluation, one
    step) runs on a side stream, then the captures; the buffers hold
    nothing of use until `load`. `result` is the evaluation graph's
    output, rewritten by each evaluation replay."""

    def __init__(self, evaluate: Callable, step: Callable, state,
                 extras: Sequence[torch.Tensor]):
        with spans.timed("folp.capture"):
            self.static = StaticState(state, extras)
            device = self.static.buffers[0].device
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            before = dict(routed.LAUNCHES)
            with torch.cuda.stream(side):
                # kernels loaded, pool primed
                self.static.apply(evaluate, evaluation=True)
                self.static.apply(step)
            torch.cuda.current_stream(device).wait_stream(side)
            # the warm-up's launches are real and stay counted
            self.warmup_launches = _delta(before)
            self.eval_graph, self.eval_launches, self.result = (
                self._capture(side, evaluate, evaluation=True))
            self.step_graph, self.step_launches, _ = self._capture(side,
                                                                   step)
        spans.COUNTS["captures"] += 1

    def _capture(self, side, fn, evaluation=False):
        before = dict(routed.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self.static.apply(fn, evaluation)
        finally:
            # the capture recorded launches, it made none
            launches = _delta(before)
            routed.LAUNCHES.update(before)
        return graph, launches, out

    @staticmethod
    def _replay(graph, launches, times: int) -> None:
        for _ in range(times):
            graph.replay()
        for key, count in launches.items():
            routed.LAUNCHES[key] += count * times

    def evaluate(self):
        """One evaluation on the current stream; its result (the graph's
        output tensors)."""
        self._replay(self.eval_graph, self.eval_launches, 1)
        spans.COUNTS["eval_replays"] += 1
        return self.result

    def steps(self, times: int) -> None:
        """`times` steps on the current stream."""
        self._replay(self.step_graph, self.step_launches, times)
        spans.COUNTS["replays"] += times


def cached(bundle, key, make: Callable[[], SegmentGraphs]) -> SegmentGraphs:
    """The bundle's graphs under `key`, captured by `make` the first
    time."""
    graphs = bundle.graphs.get(key)
    if graphs is None:
        graphs = bundle.graphs[key] = make()
    return graphs


class SegmentRunner:
    """One dispatch's segments on one state: the state is loaded into
    the static buffers once, the evaluation and the steps run on them
    (replayed from the bundle's SegmentGraphs under `key`, or eagerly
    when `graphed` is false), and the state is copied out once by
    `unload`. The extras are the elapsed time (0-d f64, filled by
    `fill_`: a kernel argument, no host transfer) and the segment's
    first iteration (0-d int64, written by the evaluation)."""

    def __init__(self, bundle, key, state, evaluate: Callable,
                 step: Callable, elapsed_time: float, graphed: bool):
        device = _leaves(state)[0].device
        extras = (torch.zeros((), dtype=torch.float64, device=device),
                  torch.zeros((), dtype=torch.int64, device=device))
        self._evaluate, self._step = evaluate, step
        self.graphs: Optional[SegmentGraphs] = None
        if graphed:
            self.graphs = cached(bundle, key, lambda: SegmentGraphs(
                evaluate, step, state, extras))
        with spans.span("folp.load"):
            if self.graphs is not None:
                self.static = self.graphs.static
                self.static.load(state)
            else:
                self.static = StaticState(state, extras)
            self.static.extras[0].fill_(float(elapsed_time))
        spans.COUNTS["loads"] += 1

    @property
    def state(self):
        """The state on the buffers (no copy: the next evaluation or step
        changes them)."""
        return self.static.state

    @property
    def start(self) -> torch.Tensor:
        """The segment's first iteration, as the last evaluation left
        it."""
        return self.static.extras[1]

    def evaluate(self):
        spans.COUNTS["evaluations"] += 1
        with spans.span("folp.evaluate"):
            if self.graphs is not None:
                return self.graphs.evaluate()
            return self.static.apply(self._evaluate, evaluation=True)

    def steps(self, times: int) -> None:
        spans.COUNTS["steps"] += times
        with spans.span("folp.trials"):
            if self.graphs is not None:
                self.graphs.steps(times)
                return
            for _ in range(times):
                self.static.apply(self._step)

    def detach(self, result):
        """`result` copied off the evaluation graph's output tensors,
        which a later evaluation replay rewrites; an eager result as it
        is."""
        if self.graphs is None:
            return result
        return _rebuild(result, iter([t.clone() for t in _leaves(result)]))

    def unload(self):
        spans.COUNTS["unloads"] += 1
        return self.static.unload()
