"""PDLP's step trial around the fused dual step, as two kernels: F1a
``primal_step`` before B3 (or B6) and F1b ``trial_epilogue`` after B4
(or B7), ``csrc/pdhg_step.cu``.

The JAX package has no Pallas kernel here: under ``jit`` XLA fuses the
vector work around its routed kernels (``_take_step_adaptive``,
``firstorderlp_tpu/models/pdhg.py:303-410``; ``_take_step_constant``
:412). The port's trial on the f32 kernel operator is F1a, B3, B4 and
F1b, four launches (models/pdhg._fused_trial).

Each wrapper takes the plain PyTorch version beside it only when its
tensors are on the CPU; for CUDA tensors it launches its kernel or
raises, and any other device raises. The plain versions are the eager
trial's own operations, so the kernels give their bits (the source says
how). Every launch adds one to the wrapper's entry in
``ops/routed.LAUNCHES``, so graph replays credit it like B2-B7.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import kernels_build, routed

# csrc/pdhg_step.cu's PowRoute: how PyTorch's CUDA pow(tensor, scalar)
# computes t ** e in f32 for the exponent `e`.
POW_GENERAL, POW_ZERO, POW_ONE, POW_SQRT, POW_RSQRT, POW_RECIP = range(6)
POW_SQUARE, POW_CUBE, POW_INV_SQUARE = 6, 7, 8


def pow_route(exponent: float) -> int:
    """The route of PyTorch's pow(tensor, exponent) on CUDA for an f32
    base: 0 and 1 fill and copy, 0.5, -0.5 and -1 go to sqrt, rsqrt and
    reciprocal (tested on the exponent as given), 2, 3 and -2 to
    products (tested on the exponent rounded to f32), any other to
    powf."""
    special = {0.0: POW_ZERO, 1.0: POW_ONE, 0.5: POW_SQRT,
               -0.5: POW_RSQRT, -1.0: POW_RECIP}
    if exponent in special:
        return special[exponent]
    rounded = float(np.float32(exponent))
    return {2.0: POW_SQUARE, 3.0: POW_CUBE,
            -2.0: POW_INV_SQUARE}.get(rounded, POW_GENERAL)


@dataclasses.dataclass(frozen=True)
class TrialFields:
    """The fields of a PdhgState that a trial reads and writes: the
    iterates, their last moves, A'y, the average's sums, counts and
    weights, the step size, the primal weight, the flag and the
    counters (0-d tensors: bool, int64 and f64 as in the state)."""

    x: torch.Tensor
    y: torch.Tensor
    delta_x: torch.Tensor
    delta_y: torch.Tensor
    aty: torch.Tensor
    sum_x: torch.Tensor
    sum_y: torch.Tensor
    count_x: torch.Tensor
    count_y: torch.Tensor
    weight_x: torch.Tensor
    weight_y: torch.Tensor
    step_size: torch.Tensor
    primal_weight: torch.Tensor
    numerical_error: torch.Tensor
    total: torch.Tensor
    iteration: torch.Tensor
    kkt: torch.Tensor


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def primal_step_plain(x, c, aty, lower, upper, step, weight, reason,
                      numerical_error, iteration, start, frequency: int,
                      limit: int, constant: bool):
    """(x+, z, dx, sigma, active): x+ = clamp(x - (step/weight)(c - aty),
    lower, upper), dx = x+ - x, z = 2 x+ - x (or x+ + (x+ - x) for
    constant steps), sigma = weight step, and the segment's trial mask
    (models/pdhg._trial_active: no termination reason, no numerical
    error, and the segment's first iteration `start` or not an
    evaluation iteration of `frequency` and `limit`)."""
    next_x = torch.clamp(x - (step / weight) * (c - aty), lower, upper)
    dx = next_x - x
    z = next_x + (next_x - x) if constant else 2.0 * next_x - x
    sigma = weight * step
    evaluation = (((iteration - 1) % frequency == 0)
                  | (iteration == limit + 1) | (iteration <= 10))
    active = ((reason == 0) & ~numerical_error
              & ((iteration == start) | ~evaluation))
    return next_x, z, dx, sigma, active


def step_size_factors(total, reduction_exponent: float,
                      growth_exponent: float, dtype):
    """(1 - (total + 1)^-reduction, 1 + (total + 1)^-growth) from the
    0-d int64 tensor `total`, on its device in `dtype`."""
    t1 = total.to(dtype) + 1.0
    return 1 - t1 ** (-reduction_exponent), 1 + t1 ** (-growth_exponent)


def trial_epilogue_plain(f: TrialFields, x_next, dx, y_next, aty_next,
                         dy2, interaction, dx2, active,
                         reduction_exponent: float, growth_exponent: float,
                         constant: bool) -> TrialFields:
    """The fields after the trial. Adaptive steps: movement and
    interaction from B3/B4's sums (dy2, interaction = sum dx (A'y+ - A'y),
    dx2), the accept test and the new step size (reference
    pdhg.jl:649-731); constant steps (`constant`, the sums unused): every
    active trial accepted, the step size and the flag as they were. The
    iterates, their moves, A'y and the average (sums += step x+, step
    y+ with the step size at entry) move where the trial is active and
    accepted; the step size, the flag, `total` and `kkt` where it is
    active."""
    step = f.step_size
    total = f.total + 1
    if constant:
        take = active
    else:
        movement = 0.5 * f.primal_weight * dx2 + (
            0.5 / f.primal_weight) * dy2
        interaction = torch.abs(interaction)
        numerical_error = movement == 0.0
        step_size_limit = torch.where(
            interaction > 0,
            movement / torch.where(interaction > 0, interaction, 1.0),
            torch.inf,
        )
        accept = (step <= step_size_limit) & ~numerical_error
        shrink, grow = step_size_factors(total, reduction_exponent,
                                         growth_exponent, step.dtype)
        new_step_size = torch.where(
            numerical_error, step,
            torch.minimum(shrink * step_size_limit, grow * step))
        take = active & accept

    def where(a, b):
        return torch.where(take, a, b)

    return dataclasses.replace(
        f,
        x=where(x_next, f.x),
        y=where(y_next, f.y),
        delta_x=where(dx, f.delta_x),
        delta_y=where(y_next - f.y, f.delta_y),
        aty=where(aty_next, f.aty),
        sum_x=where(f.sum_x + x_next * step, f.sum_x),
        sum_y=where(f.sum_y + y_next * step, f.sum_y),
        count_x=where(f.count_x + 1, f.count_x),
        count_y=where(f.count_y + 1, f.count_y),
        weight_x=where(f.weight_x + step, f.weight_x),
        weight_y=where(f.weight_y + step, f.weight_y),
        iteration=where(f.iteration + 1, f.iteration),
        total=torch.where(active, total, f.total),
        kkt=torch.where(active, f.kkt + 1.0, f.kkt),
        **({} if constant else dict(
            step_size=torch.where(active, new_step_size, step),
            numerical_error=torch.where(active, numerical_error,
                                        f.numerical_error),
        )),
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _PrimalStepArgs(ctypes.Structure):
    """csrc/pdhg_step.cu's PrimalStepArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "c", "aty", "lower", "upper", "step", "weight", "reason",
        "numerical_error", "iteration", "start", "x_next", "z", "dx",
        "sigma", "active")] + [
        ("frequency", ctypes.c_longlong),
        ("limit", ctypes.c_longlong),
        ("n", ctypes.c_int),
        ("constant", ctypes.c_int),
        ("aligned", ctypes.c_int),
    ]


class _EpilogueArgs(ctypes.Structure):
    """csrc/pdhg_step.cu's EpilogueArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x_next", "dx", "y_next", "aty_next", "dy2", "interaction", "dx2",
        "active", "x", "y", "delta_x", "delta_y", "aty", "sum_x", "sum_y",
        "count_x", "count_y", "weight_x", "weight_y", "step",
        "primal_weight", "numerical_error", "total", "iteration", "kkt",
        "x_out", "y_out", "delta_x_out", "delta_y_out", "aty_out",
        "sum_x_out", "sum_y_out", "counters_out", "scalars_out", "kkt_out",
        "numerical_error_out")] + [
        ("shrink_exponent", ctypes.c_float),
        ("grow_exponent", ctypes.c_float),
        ("shrink_route", ctypes.c_int),
        ("grow_route", ctypes.c_int),
        ("n", ctypes.c_int),
        ("m", ctypes.c_int),
        ("constant", ctypes.c_int),
        ("aligned", ctypes.c_int),
    ]


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; False when every one is on
    one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the trial's tensors lie on {sorted(map(str, devices))}")
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
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned_mask(vectors) -> int:
    """F1a's and F1b's `aligned` argument: bit i set where vectors[i]
    starts at a 16-byte boundary (the kernel reads it 16 bytes at a time
    there, 4 elsewhere)."""
    return sum(1 << i for i, t in enumerate(vectors)
               if t.data_ptr() % 16 == 0)


# F1a's threads a block (csrc/pdhg_step.cu's kPrimalThreads), one
# 16-byte slot a thread: the fastest of the launches timed (PERF.md)
PRIMAL_THREADS = 256


def primal_grid(n: int) -> int:
    """F1a's blocks for n entries: a thread each n // 4 slots, three for
    the n mod 4 tail, one for sigma and the mask."""
    return -(-(n // 4 + 4) // PRIMAL_THREADS)


def primal_layout(n: int):
    """(x+, z, dx, sigma)'s offsets in F1a's output buffer, in floats,
    and the buffer's length: each vector starts at a multiple of 4 floats
    (16 bytes), so the kernels after it read whole 16-byte slots."""
    stride = -(-n // 4) * 4
    return (0, stride, 2 * stride, 3 * stride), 3 * stride + 1


def _launch(lib: str, args: ctypes.Structure, device) -> None:
    fn = kernels_build.kernel_function(lib)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    routed.LAUNCHES[lib] += 1


def primal_step(x, c, aty, lower, upper, step, weight, reason,
                numerical_error, iteration, start, frequency: int,
                limit: int, constant: bool):
    """F1a: primal_step_plain's contract; on CUDA one launch, the three
    vectors in one new tensor (primal_layout: each 16-byte aligned),
    sigma and the mask new 0-d tensors."""
    vectors = (x, c, aty, lower, upper)
    scalars = (step, weight, reason, numerical_error, iteration, start)
    if _on_cpu(*vectors, *scalars):
        return primal_step_plain(x, c, aty, lower, upper, step, weight,
                                 reason, numerical_error, iteration, start,
                                 frequency, limit, constant)
    n = x.shape[0]
    for name, t in zip(("x", "c", "aty", "lower", "upper"), vectors):
        _check(name, t, torch.float32, (n,))
    for name, t, dtype in (("step", step, torch.float32),
                           ("weight", weight, torch.float32),
                           ("reason", reason, torch.int32),
                           ("numerical_error", numerical_error, torch.bool),
                           ("iteration", iteration, torch.int64),
                           ("start", start, torch.int64)):
        _check(name, t, dtype, ())
    if frequency <= 0:
        raise ValueError(f"evaluation frequency {frequency} must be positive")
    (x_at, z_at, dx_at, sigma_at), size = primal_layout(n)
    out = torch.empty(size, dtype=torch.float32, device=x.device)
    active = torch.empty((), dtype=torch.bool, device=x.device)
    x_next, z, dx = (out[a:a + n] for a in (x_at, z_at, dx_at))
    sigma = out[sigma_at]
    args = _PrimalStepArgs(
        *(t.data_ptr() for t in (*vectors, *scalars, x_next, z, dx, sigma,
                                 active)),
        frequency, limit, n, int(constant), aligned_mask(vectors))
    _launch("primal_step", args, x.device)
    return x_next, z, dx, sigma, active


def trial_epilogue(f: TrialFields, x_next, dx, y_next, aty_next, dy2,
                   interaction, dx2, active, reduction_exponent: float,
                   growth_exponent: float, constant: bool) -> TrialFields:
    """F1b: trial_epilogue_plain's contract; on CUDA one launch into new
    tensors (the vectors in one, the counters, the f32 scalars, kkt and
    the flag in four more; constant steps return the step size and the
    flag as they were). With constant steps the sums may be None."""
    fields = [getattr(f, fl.name) for fl in dataclasses.fields(f)]
    new = [x_next, dx, y_next, aty_next, active]
    sums = () if constant else (dy2, interaction, dx2)
    if _on_cpu(*fields, *new, *sums):
        return trial_epilogue_plain(f, x_next, dx, y_next, aty_next, dy2,
                                    interaction, dx2, active,
                                    reduction_exponent, growth_exponent,
                                    constant)
    n, m = f.x.shape[0], f.y.shape[0]
    for name, t, size in (("x", f.x, n), ("y", f.y, m),
                          ("delta_x", f.delta_x, n),
                          ("delta_y", f.delta_y, m), ("aty", f.aty, n),
                          ("sum_x", f.sum_x, n), ("sum_y", f.sum_y, m),
                          ("x_next", x_next, n), ("dx", dx, n),
                          ("y_next", y_next, m),
                          ("aty_next", aty_next, n)):
        _check(name, t, torch.float32, (size,))
    for name, t, dtype in (
            ("count_x", f.count_x, torch.int64),
            ("count_y", f.count_y, torch.int64),
            ("weight_x", f.weight_x, torch.float32),
            ("weight_y", f.weight_y, torch.float32),
            ("step_size", f.step_size, torch.float32),
            ("primal_weight", f.primal_weight, torch.float32),
            ("numerical_error", f.numerical_error, torch.bool),
            ("total", f.total, torch.int64),
            ("iteration", f.iteration, torch.int64),
            ("kkt", f.kkt, torch.float64), ("active", active, torch.bool),
            *((name, t, torch.float32) for name, t in
              zip(("dy2", "interaction", "dx2"), sums))):
        _check(name, t, dtype, ())
    device = f.x.device
    # each output vector at a multiple of 4 floats: 16-byte aligned
    sizes = (n, m, n, m, n, n, m, 3)
    starts = np.cumsum([0, *(-(-s // 4) * 4 for s in sizes[:-1])])
    vec = torch.empty(int(starts[-1]) + 3, dtype=torch.float32,
                      device=device)
    counters = torch.empty(4, dtype=torch.int64, device=device)
    kkt = torch.empty((), dtype=torch.float64, device=device)
    flag = torch.empty((), dtype=torch.bool, device=device)
    x_o, y_o, dx_o, dy_o, aty_o, sx_o, sy_o, scal = (
        vec[a:a + s] for a, s in zip(starts, sizes))

    def ptr(t: Optional[torch.Tensor]) -> int:
        return 0 if t is None else t.data_ptr()

    shrink, grow = -float(reduction_exponent), -float(growth_exponent)
    inputs = (x_next, dx, y_next, aty_next, f.x, f.y, f.delta_x, f.delta_y,
              f.aty, f.sum_x, f.sum_y)
    args = _EpilogueArgs(
        *(ptr(t) for t in (
            x_next, dx, y_next, aty_next,
            *((None,) * 3 if constant else sums), active, *fields, x_o,
            y_o, dx_o, dy_o, aty_o, sx_o, sy_o, counters, scal, kkt, flag)),
        shrink, grow, pow_route(shrink), pow_route(grow), n, m,
        int(constant), aligned_mask(inputs))
    _launch("trial_epilogue", args, device)
    return dataclasses.replace(
        f, x=x_o, y=y_o, delta_x=dx_o, delta_y=dy_o, aty=aty_o, sum_x=sx_o,
        sum_y=sy_o, count_x=counters[2], count_y=counters[3],
        weight_x=scal[1], weight_y=scal[2], total=counters[0],
        iteration=counters[1], kkt=kkt,
        **({} if constant else dict(step_size=scal[0],
                                    numerical_error=flag)))
