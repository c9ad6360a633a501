"""CUDA graphs of the solvers' steps: the port's counterpart of the JAX
package's `jit` + `lax.while_loop` over a segment's step trials.

A `StepGraph` captures one step (a masked PDHG trial, or one Mirror
Prox iteration) on static buffers: the state's fields that the step
reads or writes. The graph ends by copying the step's new values into
the buffers it read, so replays chain on the current stream with no
host work between them. The solvers load a segment's state into the
buffers, replay the graph as many times as the segment's trials, and
take the state back out as copies (models/pdhg._run_trials,
models/mirror_prox._run_iterations).

Which problems are replayed is decided by type, in `graphable`: the f32
kernel operator (`RoutedOp`) on a CUDA device and an LP. Everything
else runs the same steps eagerly. A capture that fails raises; nothing
falls back to the eager steps.

A graph belongs to the tensors it captured: it is cached on the device
bundle (`DeviceScaledQp.graphs`), which a bundle made by
`dataclasses.replace` (refine's shifted sub-solves) does not share.
Each replay credits the launches the capture recorded to
`ops/routed.LAUNCHES`, so the launch counts stay those of the eager
steps, plus the one step a capture's warm-up runs (real launches, on
buffers that the first `load` overwrites).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Sequence

import torch

from . import routed

# What the solvers' segments did, counted at the host: segments that
# ran steps, steps (trials or iterations) launched, read-backs the step
# loops made (the evaluations' own are not counted), graph replays,
# captures and the seconds the captures took (warm-up included).
COUNTS: Dict[str, float] = {
    "segments": 0,
    "steps": 0,
    "read_backs": 0,
    "replays": 0,
    "captures": 0,
    "capture_seconds": 0.0,
}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def graphable(problem) -> bool:
    """Whether the steps of `problem` (a DeviceQp) are replayed from a
    CUDA graph: its constraint operator is a RoutedOp on a CUDA device,
    it is an LP and its working precision is f32 (the fused trial's
    condition in models/pdhg._take_step_adaptive). The CPU, CsrOp and
    DenseOp (f64), QPs and ShardedRoutedOp (meshes, process groups) run
    the same steps eagerly."""
    op = problem.constraint_matrix
    return (
        isinstance(op, routed.RoutedOp)
        and op.a.device.type == "cuda"
        and problem.objective_matrix is None
        and problem.objective_vector.dtype == torch.float32
    )


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    """ops/routed.LAUNCHES less `before`, the kernels that moved only."""
    return {k: routed.LAUNCHES[k] - n for k, n in before.items()
            if routed.LAUNCHES[k] != n}


def _leaves(value) -> list:
    """The tensors of a field's value, through nested dataclasses."""
    if isinstance(value, torch.Tensor):
        return [value]
    if dataclasses.is_dataclass(value):
        return [t for f in dataclasses.fields(value)
                for t in _leaves(getattr(value, f.name))]
    raise TypeError(f"a graphed step carries tensors only, got {value!r}")


def _rebuild(value, tensors):
    """`value` with its tensors taken in order from the iterator."""
    if isinstance(value, torch.Tensor):
        return next(tensors)
    return dataclasses.replace(value, **{
        f.name: _rebuild(getattr(value, f.name), tensors)
        for f in dataclasses.fields(value)
    })


class StepGraph:
    """`step(state, *consts) -> state` captured once as a CUDA graph.

    `fields` names the state's fields the step reads or writes (their
    values: tensors, or dataclasses of tensors); the step must read no
    other field. `consts` are tensors the step reads and never writes
    (a segment's first iteration). The warm-up runs on a side stream,
    then the capture; the buffers hold nothing of use until `load`."""

    def __init__(self, step: Callable, state, fields: Sequence[str],
                 consts: Sequence[torch.Tensor] = ()):
        t0 = time.perf_counter()
        self._fields = tuple(fields)
        self._static = [t.clone() for t in self._state_leaves(state)]
        self._consts = [c.clone() for c in consts]
        device = self._static[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        before = dict(routed.LAUNCHES)
        with torch.cuda.stream(side):
            # kernels loaded, pool primed
            self._step_into_buffers(step, state)
        torch.cuda.current_stream(device).wait_stream(side)
        # the warm-up's launches are real and stay counted
        self.warmup_launches = _delta(before)
        before = dict(routed.LAUNCHES)
        self._graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self._graph, stream=side):
                self._step_into_buffers(step, state)
        finally:
            # the capture recorded launches, it made none
            self.launches = _delta(before)
            routed.LAUNCHES.update(before)
        self.capture_seconds = time.perf_counter() - t0
        COUNTS["captures"] += 1
        COUNTS["capture_seconds"] += self.capture_seconds

    def _state_leaves(self, state) -> list:
        return [t for name in self._fields
                for t in _leaves(getattr(state, name))]

    def _over(self, state, tensors):
        it = iter(tensors)
        return dataclasses.replace(state, **{
            name: _rebuild(getattr(state, name), it)
            for name in self._fields
        })

    def _step_into_buffers(self, step, state) -> None:
        new = step(self._over(state, self._static), *self._consts)
        out = self._state_leaves(new)
        buffers = {id(b) for b in self._static}
        for buf, t in zip(self._static, out):
            if t is buf:
                continue
            if id(t) in buffers or t.dtype != buf.dtype:
                raise RuntimeError(
                    "a graphed step must return new tensors of its "
                    "fields' types")
            buf.copy_(t)

    def load(self, state, *consts) -> None:
        """Copies `state`'s fields and the constants into the buffers."""
        for buf, t in zip(self._static, self._state_leaves(state)):
            buf.copy_(t)
        for buf, t in zip(self._consts, consts):
            buf.copy_(t)

    def replay(self, times: int) -> None:
        """`times` steps on the current stream, their launches credited
        to ops/routed.LAUNCHES."""
        for _ in range(times):
            self._graph.replay()
        for key, count in self.launches.items():
            routed.LAUNCHES[key] += count * times
        COUNTS["replays"] += times

    def view(self, state):
        """`state` with the graphed fields on the buffers (no copy: the
        next replay changes them)."""
        return self._over(state, self._static)

    def unload(self, state):
        """`state` with the graphed fields copied out of the buffers."""
        return self._over(state, [t.clone() for t in self._static])


def cached(bundle, key, make: Callable[[], StepGraph]) -> StepGraph:
    """The bundle's graph under `key`, captured by `make` the first
    time."""
    graph = bundle.graphs.get(key)
    if graph is None:
        graph = bundle.graphs[key] = make()
    return graph
