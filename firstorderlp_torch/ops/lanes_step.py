"""The fleet's PDHG lane trial as four kernels: LF1a
``lane_primal_step`` and LF1b ``lane_trial_epilogue``
(``csrc/lanes_step.cu``) around L1 with the dual step
(``lanes_dual_step``) and L1' with the step-control sums
(``lanes_rmv_stats``), the epilogue variants of the lane product
(``csrc/lanes_spmv.cu``).

The fleet counterpart of the main path's F1a, B3, B4, F1b
(``ops/pdhg_step.py``), with each lane's step size, primal weight and
counters as (B,) vectors and every lane vector (dim, B). The JAX package
has no Pallas kernel here: it vmaps ``_segment_core``
(``firstorderlp_tpu/batch.py:162``) and XLA fuses the trial.
``batch.fused_lane_step`` composes them for a shared-pattern f32 LP
fleet on CUDA (``batch._fused_lanes``).

Each wrapper takes the plain PyTorch version beside it (``*_plain``)
only when its tensors are on the CPU; for CUDA tensors it launches its
kernel or raises. The plain versions are the eager trial's own
operations (``batch.pdhg_lane_step``), with one change of contract:
the step-control sums (sum (y+ - y)^2, sum dx (A'y+ - A'y), sum dx^2 a
lane) are added in f64 and rounded once to f32, where the eager trial
adds in f32. Every launch adds one to its entry in ``ops/lanes.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import torch

from . import kernels_build
from .lanes import (LAUNCHES, LanesHalf, LanesOp, _current_stream,
                    _launch_for, lanes_spmv)
from .pdhg_step import TrialFields, pow_route, step_size_factors

# Items whose f64 terms one ticket's last drawer adds up (csrc/
# lanes_spmv.cu kGroupItems).
GROUP_ITEMS = 64
# The products keep four warps' f64 sums of every lane in shared memory
# (4 warps x 2 sums x B doubles, 32 KB at 512 lanes, under the 48 KB a
# launch may take without asking); fleets of more lanes keep the eager
# trial.
MAX_LANES = 512


def eval_iteration_plain(iteration, frequency: int, limit: int):
    """Per lane: is `iteration` an evaluation iteration (every
    `frequency`-th, the one after `limit`, the first ten)."""
    return ((torch.remainder(iteration - 1, frequency) == 0)
            | (iteration == limit + 1) | (iteration <= 10))


def lane_active_plain(reason, numerical_error, iteration, start,
                      frequency: int, limit: int):
    """Per lane: does the next trial run (batch._lane_active): reason 0,
    no numerical error, and the segment's start or not an evaluation
    iteration."""
    return ((reason == 0) & ~numerical_error
            & ((iteration == start)
               | ~eval_iteration_plain(iteration, frequency, limit)))


def _f64_sum(terms: torch.Tensor) -> torch.Tensor:
    """Each lane's sum of the f32 terms (dim, B), in f64, rounded once."""
    return terms.double().sum(dim=0).to(terms.dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def lane_primal_step_plain(x, c, aty, lower, upper, step, weight, reason,
                           numerical_error, iteration, start, frequency: int,
                           limit: int):
    """(x+, z, active): x+ = clamp(x - (step / weight) (c - aty), lower,
    upper) and z = x+ + (x+ - x) per lane, and each lane's mask."""
    next_x = torch.clamp(x - (step / weight) * (c - aty), lower, upper)
    z = next_x + (next_x - x)
    active = lane_active_plain(reason, numerical_error, iteration, start,
                               frequency, limit)
    return next_x, z, active


def lanes_dual_step_plain(half: LanesHalf, vals, z, y, b, is_equality, step,
                          weight):
    """(y+, dy2): y+ = proj(y + (weight step) (b - A z)) (proj: >= 0 off
    the equality rows), and each lane's sum of (y+ - y)^2."""
    cand = y + (weight * step) * (b - lanes_spmv(half, vals, z))
    y_next = torch.where(is_equality, cand, torch.clamp_min(cand, 0.0))
    dy = y_next - y
    return y_next, _f64_sum(dy * dy)


def lanes_rmv_stats_plain(half: LanesHalf, vals_t, y_next, x_next, x, aty):
    """(A'y+, interaction sum, dx2): each lane's sum dx (A'y+ - A'y) and
    sum dx^2, dx = x+ - x."""
    aty_next = lanes_spmv(half, vals_t, y_next)
    dx = x_next - x
    return aty_next, _f64_sum(dx * (aty_next - aty)), _f64_sum(dx * dx)


def lane_verdict_plain(dy2, interaction, dx2, active, step, weight, total,
                       reduction_exponent: float, growth_exponent: float):
    """(take, new step size, numerical error) per lane from the sums:
    movement, |interaction|, the step-size limit, the accept test and
    the adaptive rule's new step (batch.pdhg_lane_step; `total` the
    trials before this one)."""
    interaction = torch.abs(interaction)
    movement = 0.5 * weight * dx2 + (0.5 / weight) * dy2
    numerical_error = movement == 0.0
    step_size_limit = torch.where(
        interaction > 0,
        movement / torch.where(interaction > 0, interaction, 1.0),
        torch.inf,
    )
    accept = (step <= step_size_limit) & ~numerical_error
    shrink, grow = step_size_factors(total + 1, reduction_exponent,
                                     growth_exponent, step.dtype)
    new_step = torch.where(
        numerical_error, step,
        torch.minimum(shrink * step_size_limit, grow * step))
    return active & accept, new_step, numerical_error


def lane_trial_epilogue_plain(f: TrialFields, x_next, y_next, aty_next,
                              active, take, new_step, new_error, reason,
                              start, frequency: int, limit: int):
    """(fields, any_active): the state after the trial, and whether any
    lane runs the next one (an int32 0-d tensor). Where a lane takes its
    step (`take`) the trial's point, its moves, A'y+ and the average's
    sums (+= x+ step, y+ step with the step size at entry), counts and
    weights; where it is active the new step size and flag, total and
    kkt (+1)."""
    step = f.step_size

    def where(a, b):
        return torch.where(take, a, b)

    new = dataclasses.replace(
        f,
        x=where(x_next, f.x),
        y=where(y_next, f.y),
        delta_x=where(x_next - f.x, f.delta_x),
        delta_y=where(y_next - f.y, f.delta_y),
        aty=where(aty_next, f.aty),
        sum_x=where(f.sum_x + x_next * step, f.sum_x),
        sum_y=where(f.sum_y + y_next * step, f.sum_y),
        count_x=where(f.count_x + 1, f.count_x),
        count_y=where(f.count_y + 1, f.count_y),
        weight_x=where(f.weight_x + step, f.weight_x),
        weight_y=where(f.weight_y + step, f.weight_y),
        iteration=where(f.iteration + 1, f.iteration),
        total=torch.where(active, f.total + 1, f.total),
        kkt=torch.where(active, f.kkt + 1.0, f.kkt),
        step_size=torch.where(active, new_step, step),
        numerical_error=torch.where(active, new_error, f.numerical_error),
    )
    running = lane_active_plain(reason, new.numerical_error, new.iteration,
                                start, frequency, limit)
    return new, running.any().to(torch.int32)


# ---------------------------------------------------------------------------
# The trial's scratch, allocated once per fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LaneTrialWorkspace:
    """What every trial on one pattern at one lane count reuses: LF1a's
    x+ and z, y+ and A'y+, the (B,) mask and verdict, each product's f64
    terms (an item's, a group's) and tickets, and its rounded sums."""

    x_next: torch.Tensor  # (n, B)
    z: torch.Tensor  # (n, B)
    y_next: torch.Tensor  # (m, B)
    aty_next: torch.Tensor  # (n, B)
    active: torch.Tensor  # (B,) bool
    take: torch.Tensor  # (B,) bool
    new_step: torch.Tensor  # (B,) f32
    new_error: torch.Tensor  # (B,) bool
    dual: Dict[str, torch.Tensor]  # partials, groups, tickets, sums
    stats: Dict[str, torch.Tensor]


def _terms(half: LanesHalf, parts: int, lanes: int, device):
    groups = -(-half.nitems // GROUP_ITEMS)
    f64 = dict(dtype=torch.float64, device=device)
    return {
        "partials": torch.empty((max(half.nitems, 1), parts, lanes), **f64),
        "groups": torch.empty((max(groups, 1), parts, lanes), **f64),
        "tickets": torch.zeros(groups + 1, dtype=torch.int32,
                               device=device),
        "sums": torch.empty((parts, lanes), dtype=torch.float32,
                            device=device),
        "count": groups,
    }


def trial_workspace(op: LanesOp) -> LaneTrialWorkspace:
    """The workspace of `op`'s pattern at its lane count, made at the
    first trial and kept with the pattern (the scaled and the original
    operators share it: their kernels run on one stream)."""
    lanes = op.lanes
    got = op.pattern.workspaces.get(lanes)
    if got is not None:
        return got
    m, n = op.shape
    device = op.vals.device

    def plane(rows, dtype=torch.float32):
        return torch.empty((rows, lanes), dtype=dtype, device=device)

    def word(dtype):
        return torch.empty(lanes, dtype=dtype, device=device)

    got = op.pattern.workspaces[lanes] = LaneTrialWorkspace(
        x_next=plane(n), z=plane(n), y_next=plane(m), aty_next=plane(n),
        active=word(torch.bool), take=word(torch.bool),
        new_step=word(torch.float32), new_error=word(torch.bool),
        dual=_terms(op.pattern.fwd, 1, lanes, device),
        stats=_terms(op.pattern.bwd, 2, lanes, device),
    )
    return got


def fusable(op, lanes: int) -> bool:
    """Whether the four kernels take a trial on `op` at `lanes` lanes:
    an L1 operator with work items in both orientations, at most
    MAX_LANES lanes."""
    return (isinstance(op, LanesOp) and op.pattern.fwd.nitems > 0
            and op.pattern.bwd.nitems > 0 and 0 < lanes <= MAX_LANES)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _LanePrimalArgs(ctypes.Structure):
    """csrc/lanes_step.cu's LanePrimalArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "c", "aty", "lower", "upper", "step", "weight", "reason",
        "numerical_error", "iteration", "start", "x_next", "z",
        "active")] + [
        ("frequency", ctypes.c_longlong),
        ("limit", ctypes.c_longlong),
        ("size", ctypes.c_longlong),
        ("lanes", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


_EPILOGUE_POINTERS = (
    "x_next", "y_next", "aty_next", "active", "take", "new_step",
    "new_error", "x", "y", "delta_x", "delta_y", "aty", "sum_x", "sum_y",
    "count_x", "count_y", "weight_x", "weight_y", "step",
    "numerical_error", "total", "iteration", "kkt", "reason", "start",
    "x_out", "y_out", "delta_x_out", "delta_y_out", "aty_out", "sum_x_out",
    "sum_y_out", "count_x_out", "count_y_out", "weight_x_out",
    "weight_y_out", "step_out", "numerical_error_out", "total_out",
    "iteration_out", "kkt_out", "any_active")


class _LaneEpilogueArgs(ctypes.Structure):
    """csrc/lanes_step.cu's LaneEpilogueArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in _EPILOGUE_POINTERS] + [
        ("frequency", ctypes.c_longlong),
        ("limit", ctypes.c_longlong),
        ("primal_size", ctypes.c_longlong),
        ("dual_size", ctypes.c_longlong),
        ("lanes", ctypes.c_int),
        ("vec", ctypes.c_int),
    ]


class _LaneStepArgs(ctypes.Structure):
    """csrc/lanes_spmv.cu's LaneStepArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "y", "b", "is_eq", "x_next", "x", "aty", "dy2", "active", "total",
        "step", "weight", "out", "partials", "group_partials",
        "group_tickets", "sums", "take", "new_step", "new_error")] + [
        ("shrink_exponent", ctypes.c_float),
        ("grow_exponent", ctypes.c_float),
        ("shrink_route", ctypes.c_int),
        ("grow_route", ctypes.c_int),
        ("eq_row", ctypes.c_int),
        ("eq_lane", ctypes.c_int),
        ("groups", ctypes.c_int),
    ]


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; False when every one is on
    one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"the lane trial's tensors lie on {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    return False


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vec(lanes: int, *tensors) -> int:
    """4 lanes a thread where B is a multiple of 4 and every plane is
    16-byte aligned, else 1 (the scalar variant)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if aligned and lanes % 4 == 0 else 1


def _launch(lib: str, label: str, *args) -> None:
    err = kernels_build.kernel_function(lib)(*args)
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    LAUNCHES[label] += 1


def lane_primal_step(ws, x, c, aty, lower, upper, step, weight, reason,
                     numerical_error, iteration, start, frequency: int,
                     limit: int):
    """LF1a: lane_primal_step_plain's contract; on CUDA one launch into
    the workspace `ws` (x+, z and the mask)."""
    planes = (x, c, aty, lower, upper)
    scalars = (step, weight, reason, numerical_error, iteration, start)
    if _on_cpu(*planes, *scalars):
        return lane_primal_step_plain(x, c, aty, lower, upper, step, weight,
                                      reason, numerical_error, iteration,
                                      start, frequency, limit)
    n, lanes = x.shape
    for name, t in zip(("x", "c", "aty", "lower", "upper"), planes):
        _check(name, t, torch.float32, (n, lanes))
    for name, t, dtype in (("step", step, torch.float32),
                           ("weight", weight, torch.float32),
                           ("reason", reason, torch.int32),
                           ("numerical_error", numerical_error, torch.bool),
                           ("iteration", iteration, torch.int64),
                           ("start", start, torch.int64)):
        _check(name, t, dtype, (lanes,))
    if frequency <= 0:
        raise ValueError(f"evaluation frequency {frequency} must be positive")
    outs = (ws.x_next, ws.z)
    args = _LanePrimalArgs(
        *(t.data_ptr() for t in (*planes, *scalars, *outs, ws.active)),
        frequency, limit, n * lanes, lanes,
        _vec(lanes, *planes, step, weight, *outs))
    _launch("lane_primal_step", "lane_primal_step", ctypes.addressof(args),
            _current_stream(x.device.index))
    return ws.x_next, ws.z, ws.active


def _eq_strides(is_equality: torch.Tensor, m: int, lanes: int):
    if is_equality.dtype != torch.bool or is_equality.dim() != 2 or (
            is_equality.shape[0] != m
            or is_equality.shape[1] not in (1, lanes)):
        raise ValueError(f"is_equality must be bool (m, 1) or (m, B), got "
                         f"{is_equality.dtype} {tuple(is_equality.shape)}")
    lane_stride = is_equality.stride(1) if is_equality.shape[1] > 1 else 0
    return is_equality.stride(0), lane_stride


def _product(lib: str, half: LanesHalf, vals, x, step_args, aligned_with,
             label: str) -> None:
    lanes = x.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (vals, x, *aligned_with))
    launch = _launch_for(half, torch.float32, lanes, aligned, None)
    _launch(lib, label, launch.address, vals.data_ptr(), x.data_ptr(),
            ctypes.addressof(step_args), _current_stream(x.device.index))


def _step_args(terms, out, **pointers) -> _LaneStepArgs:
    fields = dict(out=out.data_ptr(), partials=terms["partials"].data_ptr(),
                  group_partials=terms["groups"].data_ptr(),
                  group_tickets=terms["tickets"].data_ptr(),
                  sums=terms["sums"].data_ptr(), groups=terms["count"])
    fields.update(pointers)
    return _LaneStepArgs(**fields)


def _check_product(half: LanesHalf, vals, x, planes, scalars):
    lanes = x.shape[1]
    _check("vals", vals, torch.float32, (half.nnz, lanes))
    _check("x", x, torch.float32, (half.num_cols, lanes))
    for name, t in planes:
        _check(name, t, torch.float32, (half.num_rows, lanes))
    for name, t, dtype in scalars:
        _check(name, t, dtype, (lanes,))
    if not 0 < lanes <= MAX_LANES:
        raise ValueError(f"the lane trial takes 1 to {MAX_LANES} lanes, "
                         f"got {lanes}")


def lanes_dual_step(ws, half: LanesHalf, vals, z, y, b, is_equality, step,
                    weight):
    """L1 with the dual step: lanes_dual_step_plain's contract; on CUDA
    one launch into the workspace (y+ and dy2, rounded once from its f64
    sum)."""
    if _on_cpu(vals, z, y, b, is_equality, step, weight):
        return lanes_dual_step_plain(half, vals, z, y, b, is_equality, step,
                                     weight)
    lanes = z.shape[1]
    _check_product(half, vals, z, (("y", y), ("b", b)),
                   (("step", step, torch.float32),
                    ("weight", weight, torch.float32)))
    eq_row, eq_lane = _eq_strides(is_equality, half.num_rows, lanes)
    terms = ws.dual
    args = _step_args(
        terms, ws.y_next, y=y.data_ptr(), b=b.data_ptr(),
        is_eq=is_equality.data_ptr(), step=step.data_ptr(),
        weight=weight.data_ptr(), eq_row=eq_row, eq_lane=eq_lane)
    _product("lanes_dual_step", half, vals, z, args, (y, b, ws.y_next),
             f"lanes_spmv:{half.label}+dual")
    return ws.y_next, terms["sums"][0]


def lanes_rmv_stats(ws, half: LanesHalf, vals_t, y_next, x_next, x, aty,
                    dy2, active, step, weight, total,
                    reduction_exponent: float, growth_exponent: float):
    """L1' with the step-control sums and the verdict: (A'y+, take, new
    step size, numerical error), lanes_rmv_stats_plain then
    lane_verdict_plain; on CUDA one launch into the workspace."""
    if _on_cpu(vals_t, y_next, x_next, x, aty, dy2, active, step, weight,
               total):
        aty_next, interaction, dx2 = lanes_rmv_stats_plain(
            half, vals_t, y_next, x_next, x, aty)
        return (aty_next, *lane_verdict_plain(
            dy2, interaction, dx2, active, step, weight, total,
            reduction_exponent, growth_exponent))
    _check_product(half, vals_t, y_next,
                   (("x_next", x_next), ("x", x), ("aty", aty)),
                   (("dy2", dy2, torch.float32),
                    ("active", active, torch.bool),
                    ("step", step, torch.float32),
                    ("weight", weight, torch.float32),
                    ("total", total, torch.int64)))
    shrink, grow = -float(reduction_exponent), -float(growth_exponent)
    args = _step_args(
        ws.stats, ws.aty_next, x_next=x_next.data_ptr(), x=x.data_ptr(),
        aty=aty.data_ptr(), dy2=dy2.data_ptr(), active=active.data_ptr(),
        total=total.data_ptr(), step=step.data_ptr(),
        weight=weight.data_ptr(), take=ws.take.data_ptr(),
        new_step=ws.new_step.data_ptr(), new_error=ws.new_error.data_ptr(),
        shrink_exponent=shrink, grow_exponent=grow,
        shrink_route=pow_route(shrink), grow_route=pow_route(grow))
    _product("lanes_rmv_stats", half, vals_t, y_next, args,
             (x_next, x, aty, ws.aty_next), f"lanes_spmv:{half.label}+stats")
    return ws.aty_next, ws.take, ws.new_step, ws.new_error


def lane_trial_epilogue(f: TrialFields, x_next, y_next, aty_next, active,
                        take, new_step, new_error, reason, start,
                        frequency: int, limit: int):
    """LF1b: lane_trial_epilogue_plain's contract; on CUDA one launch
    into new tensors (every plane its own, 16-byte aligned)."""
    fields = [getattr(f, fl.name) for fl in dataclasses.fields(f)]
    verdict = (take, new_step, new_error)
    if _on_cpu(*fields, x_next, y_next, aty_next, active, reason, start,
               *verdict):
        return lane_trial_epilogue_plain(
            f, x_next, y_next, aty_next, active, take, new_step, new_error,
            reason, start, frequency, limit)
    n, lanes = f.x.shape
    m = f.y.shape[0]
    for name, t, rows in (("x", f.x, n), ("y", f.y, m),
                          ("delta_x", f.delta_x, n),
                          ("delta_y", f.delta_y, m), ("aty", f.aty, n),
                          ("sum_x", f.sum_x, n), ("sum_y", f.sum_y, m),
                          ("x_next", x_next, n), ("y_next", y_next, m),
                          ("aty_next", aty_next, n)):
        _check(name, t, torch.float32, (rows, lanes))
    for name, t, dtype in (
            ("count_x", f.count_x, torch.int64),
            ("count_y", f.count_y, torch.int64),
            ("weight_x", f.weight_x, torch.float32),
            ("weight_y", f.weight_y, torch.float32),
            ("step_size", f.step_size, torch.float32),
            ("numerical_error", f.numerical_error, torch.bool),
            ("total", f.total, torch.int64),
            ("iteration", f.iteration, torch.int64),
            ("kkt", f.kkt, torch.float64), ("active", active, torch.bool),
            ("reason", reason, torch.int32), ("start", start, torch.int64),
            *((name, t, dtype) for name, t, dtype in zip(
                ("take", "new_step", "new_error"), verdict,
                (torch.bool, torch.float32, torch.bool)))):
        _check(name, t, dtype, (lanes,))
    device = f.x.device

    def new(rows, dtype=torch.float32):
        return torch.empty((rows, lanes), dtype=dtype, device=device)

    def word(dtype):
        return torch.empty(lanes, dtype=dtype, device=device)

    out = TrialFields(
        x=new(n), y=new(m), delta_x=new(n), delta_y=new(m), aty=new(n),
        sum_x=new(n), sum_y=new(m), count_x=word(torch.int64),
        count_y=word(torch.int64), weight_x=word(torch.float32),
        weight_y=word(torch.float32), step_size=word(torch.float32),
        primal_weight=f.primal_weight, numerical_error=word(torch.bool),
        total=word(torch.int64), iteration=word(torch.int64),
        kkt=word(torch.float64))
    any_active = torch.empty((), dtype=torch.int32, device=device)
    pointers = dict(
        x_next=x_next, y_next=y_next, aty_next=aty_next, active=active,
        take=take, new_step=new_step, new_error=new_error, x=f.x, y=f.y,
        delta_x=f.delta_x, delta_y=f.delta_y, aty=f.aty, sum_x=f.sum_x,
        sum_y=f.sum_y, count_x=f.count_x, count_y=f.count_y,
        weight_x=f.weight_x, weight_y=f.weight_y, step=f.step_size,
        numerical_error=f.numerical_error, total=f.total,
        iteration=f.iteration, kkt=f.kkt, reason=reason, start=start,
        x_out=out.x, y_out=out.y, delta_x_out=out.delta_x,
        delta_y_out=out.delta_y, aty_out=out.aty, sum_x_out=out.sum_x,
        sum_y_out=out.sum_y, count_x_out=out.count_x,
        count_y_out=out.count_y, weight_x_out=out.weight_x,
        weight_y_out=out.weight_y, step_out=out.step_size,
        numerical_error_out=out.numerical_error, total_out=out.total,
        iteration_out=out.iteration, kkt_out=out.kkt,
        any_active=any_active)
    planes = (x_next, y_next, aty_next, f.x, f.y, f.delta_x, f.delta_y,
              f.aty, f.sum_x, f.sum_y, f.step_size, out.x, out.y,
              out.delta_x, out.delta_y, out.aty, out.sum_x, out.sum_y)
    args = _LaneEpilogueArgs(
        *(pointers[name].data_ptr() for name in _EPILOGUE_POINTERS),
        frequency, limit, n * lanes, m * lanes, lanes, _vec(lanes, *planes))
    _launch("lane_trial_epilogue", "lane_trial_epilogue",
            ctypes.addressof(args), _current_stream(device.index))
    return out, any_active
