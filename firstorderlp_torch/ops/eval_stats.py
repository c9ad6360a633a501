"""An evaluation's statistics and termination check on the original LP in
f32 (models/common.evaluate_unscaled_stats on the kernel operator) as
three kernels around the B2 products, ``csrc/eval_stats.cu``:

- F2d ``stats_point``: the evaluation point and its unscaled copy, and
  max |x| of the original primal;
- F2e ``stats_primal`` (after A x and A'y): the per-variable terms, and
  the primal ray for A ray where infeasibility is detected;
- F2f ``stats_dual`` (after A ray): the per-row terms, then every
  convergence and infeasibility field and the termination reason.

The JAX package has no Pallas kernel here: under ``jit`` XLA fuses its
``evaluate_unscaled_stats`` (``firstorderlp_tpu/models/common.py:50``)
and the evaluation point inline in ``_eval_block``. The port ran the same
arithmetic as about 200 PyTorch kernels an evaluation.

The contract, fixed by the plain versions below: every sum is
accumulated in f64 over f32 terms and rounded once to f32, and the
four-part l2 norms add their f64 parts before that rounding (the
previous release summed each part in f32); maxima and the elementwise
work are the eager statistics' own operations; the finalize rounds each
step once in the eager order, against the f32 values PyTorch gives the
criteria's Python floats. The kernels add in one fixed order with no
floating-point atomics, the plain versions in torch.sum's: two orders
whose longest chains are D1 and D2 give f64 sums within (D1 + D2)
2^-53 sum|t| of each other, so the f32 results agree bar one ulp at odds
of about (D1 + D2) 2^-29 sum|t| / |S|, a difference that repeats at every
run on that input.

The three take their grid from the card (``stats_grid``, ``point_grid``:
a thread a 16-byte slot, at most one wave of the device's occupancy
query; a vector that does not start on 16 bytes is read 4 bytes at a
time) and load every 0-d input at entry. F2d lays each of its outputs
on 16 bytes (``point_layout``), so F2e and F2f read the point whole, and
takes its one maximum as an integer maximum of bits in a word of the
device (exact in any order); F2e and F2f lay their blocks' partials out
value-major (``partial_index``).

Each wrapper takes the plain version only when its tensors are on the
CPU; for CUDA tensors it launches its kernel or raises, and any other
device raises. Every launch adds one to the wrapper's entry in
``ops/routed.LAUNCHES``. A device's three kernels share one set of
tickets, so one device's evaluations run on one stream at a time.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import kernels_build
from .pdhg_step import _check, _launch, _on_cpu

THREADS = 256  # kStatsThreads
SLOT_FLOATS = 4  # kSlotFloats: a thread takes 16-byte slots
CHUNK_FLOATS = THREADS * SLOT_FLOATS  # kChunkFloats: an F2d block's chunk
SLOTS = 2  # kStatsSlots: slots a thread loads at once
REACH = 8  # kReach: partials a lane of the last block loads at once

# stats_primal's totals (csrc/eval_stats.cu's PrimalTotal): f64 sums,
# then maxima, then flags (0 or 1)
PRIMAL_SUMS = ("cx", "xx", "lower2", "upper2", "rc_violation2",
               "contribution", "ray_c", "contribution_h")
PRIMAL_MAXIMA = ("bound_max", "rc_max", "rc_violation_max",
                 "ray_bound_max", "rc_h_max", "rc_violation_h_max")
PRIMAL_FLAGS = ("non_finite", "needs_infinite", "needs_infinite_h")
PRIMAL_TOTALS = PRIMAL_SUMS + PRIMAL_MAXIMA + PRIMAL_FLAGS
# stats_dual's (DualTotal)
DUAL_SUMS = ("eq2", "ineq2", "sign2", "by", "yy")
DUAL_MAXIMA = ("row_max", "sign_max", "y_max", "ray_row_max")
DUAL_TOTALS = DUAL_SUMS + DUAL_MAXIMA
P = {name: i for i, name in enumerate(PRIMAL_TOTALS)}
D = {name: i for i, name in enumerate(DUAL_TOTALS)}


class Point(NamedTuple):
    """stats_point's results: the scaled evaluation point (None where it
    is not asked for), the original point, max |primal|."""

    scaled_primal: Optional[torch.Tensor]
    scaled_dual: Optional[torch.Tensor]
    primal: torch.Tensor
    dual: torch.Tensor
    primal_norm: torch.Tensor


class Average(NamedTuple):
    """The weighted average stats_point reads (saddle_point.
    SolutionWeightedAverage's fields) and the state's flag."""

    sum_x: torch.Tensor
    sum_y: torch.Tensor
    count_x: torch.Tensor
    count_y: torch.Tensor
    weight_x: torch.Tensor
    weight_y: torch.Tensor
    numerical_error: torch.Tensor


class Scalars(NamedTuple):
    """The finalize's inputs besides the totals: the original objective
    constant and norm cache (0-d f32), and the state's numerical-error
    flag, iteration, KKT passes and elapsed seconds, each a 0-d tensor
    (bool, int64, f64, f64) or a host number."""

    objective_constant: torch.Tensor
    norm_c_inf: torch.Tensor
    norm_b_inf: torch.Tensor
    norm_c_2: torch.Tensor
    norm_b_2: torch.Tensor
    numerical_error: object
    iteration: object
    kkt_passes: object
    elapsed: object


@dataclasses.dataclass(frozen=True)
class Criteria:
    """A TerminationCriteria as the finalize reads it: the Python floats
    (PyTorch rounds each to f32 against an f32 tensor; the kernel gets
    those f32 values), eps_abs / eps_rel in f64 with Julia's 0/0 = NaN,
    the norm, and the limits. `ray`: infeasibility is detected (not both
    tolerances 0)."""

    eps_ratio: float
    abs_tol: float
    rel_tol: float
    eps_primal_infeasible: float
    eps_dual_infeasible: float
    l_inf: bool
    iteration_limit: int
    kkt_limit: float
    time_limit: float
    ray: bool


def criteria_of(criteria) -> Criteria:
    """The Criteria of a termination.TerminationCriteria."""
    with np.errstate(divide="ignore", invalid="ignore"):
        eps_ratio = float(np.float64(criteria.eps_optimal_absolute)
                          / np.float64(criteria.eps_optimal_relative))
    return Criteria(
        eps_ratio=eps_ratio,
        abs_tol=float(criteria.eps_optimal_absolute),
        rel_tol=float(criteria.eps_optimal_relative),
        eps_primal_infeasible=float(criteria.eps_primal_infeasible),
        eps_dual_infeasible=float(criteria.eps_dual_infeasible),
        l_inf=criteria.optimality_norm.value == "l_inf",
        iteration_limit=int(criteria.iteration_limit),
        kkt_limit=float(criteria.kkt_matrix_pass_limit),
        time_limit=float(criteria.time_sec_limit),
        ray=not (criteria.eps_primal_infeasible == 0.0
                 and criteria.eps_dual_infeasible == 0.0),
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _linf(v: torch.Tensor) -> torch.Tensor:
    """max |v|, 0 for an empty vector (NaN where v holds one)."""
    if v.shape[0] == 0:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.amax(torch.abs(v))


def _sum64(v: torch.Tensor) -> torch.Tensor:
    """The f64 sum of f32 terms."""
    return torch.sum(v, dtype=torch.float64)


def stats_point_plain(x, y, variable_rescaling, constraint_rescaling,
                      average: Optional[Average] = None) -> Point:
    """F2d's contract: the point (the average where `average` has one
    and no numerical error, else (x, y); models/common.evaluation_point),
    divided by the rescaling, and max |primal|. The scaled point is
    None without an average."""
    scaled_x = scaled_y = None
    if average is not None:
        a = average
        has_avg = ~a.numerical_error & (a.count_x > 0) & (a.count_y > 0)
        x = scaled_x = torch.where(
            has_avg, a.sum_x / torch.where(a.weight_x > 0, a.weight_x, 1.0),
            x)
        y = scaled_y = torch.where(
            has_avg, a.sum_y / torch.where(a.weight_y > 0, a.weight_y, 1.0),
            y)
    primal = x / variable_rescaling
    return Point(scaled_x, scaled_y, primal, y / constraint_rescaling,
                 _linf(primal))


def _reduced_costs(g, lower, upper):
    """(rc, the contribution's terms, needs an infinite bound) of the
    primal gradient g (iteration_stats.reduced_costs_from_primal_gradient
    and reduced_costs_dual_objective_contribution)."""
    rc = torch.where(torch.isfinite(torch.where(g > 0.0, lower, upper)),
                     g, 0.0)
    bound = torch.where(rc > 0.0, lower, upper)
    active = rc != 0.0
    safe = torch.where(active & torch.isfinite(bound), bound, 0.0)
    terms = safe * torch.where(active, rc, 0.0)
    return rc, terms, active & ~torch.isfinite(bound)


def primal_terms(primal, aty, objective, lower, upper, primal_norm,
                 ray: bool):
    """F2e's elementwise work: (the ray or None, {sum: its f32 terms},
    {maximum or flag: its 0-d value}); the ray's entries absent without
    it."""
    x, c = primal, objective
    lo = torch.clamp_min(lower - x, 0.0)
    up = torch.clamp_min(x - upper, 0.0)
    g = c - aty
    rc, terms, needs = _reduced_costs(g, lower, upper)
    violation = g - rc
    sums = {"cx": c * x, "xx": x * x, "lower2": lo * lo, "upper2": up * up,
            "rc_violation2": violation * violation, "contribution": terms}
    other = {
        "bound_max": torch.maximum(_linf(lo), _linf(up)),
        "rc_max": _linf(rc), "rc_violation_max": _linf(violation),
        "non_finite": torch.any(~torch.isfinite(x)),
        "needs_infinite": torch.any(needs),
    }
    if not ray:
        return None, sums, other
    ray_out = torch.where(
        primal_norm == 0.0, x,
        x / torch.where(primal_norm == 0, 1.0, primal_norm))
    hom_lb = torch.where(torch.isfinite(lower), 0.0, -torch.inf).to(x.dtype)
    hom_ub = torch.where(torch.isfinite(upper), 0.0, torch.inf).to(x.dtype)
    gh = -aty
    rc_h, terms_h, needs_h = _reduced_costs(gh, lower, upper)
    sums.update({"ray_c": c * ray_out, "contribution_h": terms_h})
    other.update({
        "ray_bound_max": torch.maximum(
            _linf(torch.clamp_min(hom_lb - ray_out, 0.0)),
            _linf(torch.clamp_min(ray_out - hom_ub, 0.0))),
        "rc_h_max": _linf(rc_h), "rc_violation_h_max": _linf(gh - rc_h),
        "needs_infinite_h": torch.any(needs_h),
    })
    return ray_out, sums, other


def totals_from_terms(names, sums, other, like) -> torch.Tensor:
    """The f64 totals in `names`' order: each sum's terms added in f64,
    each maximum and flag as it is; 0 for a name in neither."""
    zero = torch.zeros((), dtype=torch.float64, device=like.device)
    out = []
    for name in names:
        if name in sums:
            out.append(_sum64(sums[name]))
        elif name in other:
            out.append(other[name].to(torch.float64))
        else:
            out.append(zero)
    return torch.stack(out)


def stats_primal_plain(primal, aty, objective, lower, upper, primal_norm,
                       ray: bool):
    """F2e's contract: (the ray or None, the f64 totals (PRIMAL_TOTALS,))
    over the variables; the ray's entries of the totals 0 without it."""
    ray_out, sums, other = primal_terms(primal, aty, objective, lower,
                                        upper, primal_norm, ray)
    return ray_out, totals_from_terms(PRIMAL_TOTALS, sums, other, primal)


def dual_terms(dual, ax, aray, rhs, is_equality):
    """F2f's elementwise work over the rows: ({sum: its f32 terms},
    {maximum: its 0-d value}); aray None: no ray (its maximum 0)."""
    y, b, eq = dual, rhs, is_equality
    r = b - ax
    eq_v = torch.where(eq, r, 0.0)
    ineq_v = torch.where(eq, 0.0, torch.clamp_min(r, 0.0))
    sign = torch.where(eq, 0.0, torch.clamp_min(-y, 0.0))
    sums = {"eq2": eq_v * eq_v, "ineq2": ineq_v * ineq_v,
            "sign2": sign * sign, "by": b * y, "yy": y * y}
    other = {
        "row_max": torch.maximum(_linf(eq_v), _linf(ineq_v)),
        "sign_max": _linf(sign), "y_max": _linf(y),
    }
    if aray is not None:
        ra = -aray
        other["ray_row_max"] = torch.maximum(
            _linf(torch.where(eq, ra, 0.0)),
            _linf(torch.where(eq, 0.0, torch.clamp_min(ra, 0.0))))
    return sums, other


def stats_dual_totals_plain(dual, ax, aray, rhs, is_equality):
    """F2f's totals (DUAL_TOTALS,) over the rows; aray None: no ray."""
    sums, other = dual_terms(dual, ax, aray, rhs, is_equality)
    return totals_from_terms(DUAL_TOTALS, sums, other, dual)


def stats_finalize_plain(primal_totals, dual_totals, primal_norm,
                         scalars: Scalars, criteria: Criteria):
    """The finalize's contract: (conv (16,), infeas (5,), reason int32)
    from the totals, as iteration_stats.compute_convergence_information,
    compute_infeasibility_information and termination.
    check_termination_criteria compose them in models/common.
    evaluate_unscaled_stats, with the numerical-error override. Each step
    rounds once in that order; the sums are rounded to f32 once (a
    four-part l2 norm after adding its f64 parts)."""
    p, d = primal_totals, dual_totals
    f32 = torch.float32
    s = scalars

    def pf(name):
        return p[P[name]].to(f32)

    def df(name):
        return d[D[name]].to(f32)

    const = s.objective_constant
    # x'Qx of an LP: sum(x * 0), NaN where some x is not finite
    qx_dot_x = torch.where(p[P["non_finite"]] != 0, torch.nan,
                           0.0).to(f32)
    linf_pr = torch.maximum(df("row_max"), pf("bound_max"))
    l2_pr = torch.sqrt((d[D["eq2"]] + d[D["ineq2"]] + p[P["lower2"]]
                        + p[P["upper2"]]).to(f32))
    pobj = const + pf("cx") + 0.5 * qx_dot_x
    linf_dr = torch.maximum(df("sign_max"), pf("rc_violation_max"))
    l2_dr = torch.sqrt((d[D["sign2"]] + p[P["rc_violation2"]]).to(f32))
    by = df("by")
    contribution = torch.where(p[P["needs_infinite"]] != 0, -torch.inf,
                               pf("contribution"))
    dobj = by + const - 0.5 * qx_dot_x + contribution
    gap = torch.abs(pobj - dobj)
    abs_obj = torch.abs(pobj) + torch.abs(dobj)
    eps_ratio = criteria.eps_ratio
    conv = [
        pobj, dobj, torch.where(linf_dr == 0.0, dobj, -torch.inf),
        linf_pr, l2_pr, linf_dr, l2_dr,
        linf_pr / (eps_ratio + s.norm_b_inf),
        l2_pr / (eps_ratio + s.norm_b_2),
        linf_dr / (eps_ratio + s.norm_c_inf),
        l2_dr / (eps_ratio + s.norm_c_2),
        gap / (eps_ratio + abs_obj),
        primal_norm, torch.sqrt(pf("xx")), df("y_max"),
        torch.sqrt(df("yy")),
    ]
    zero = torch.zeros((), dtype=f32, device=p.device)
    infeas = [zero] * 5
    if criteria.ray:
        linf_h = torch.maximum(df("sign_max"), pf("rc_violation_h_max"))
        contribution_h = torch.where(p[P["needs_infinite_h"]] != 0,
                                     -torch.inf, pf("contribution_h"))
        dobj_h = by + zero - 0.5 * zero + contribution_h
        scale = torch.maximum(df("y_max"), pf("rc_h_max"))
        safe = torch.where(scale == 0, 1.0, scale)
        linf_dual_res = torch.sqrt(linf_h ** 2)
        infeas = [
            torch.maximum(df("ray_row_max"), pf("ray_bound_max")),
            pf("ray_c"), zero,
            torch.where(scale == 0.0, 0.0, linf_dual_res / safe),
            torch.where(scale == 0.0, 0.0, dobj_h / safe),
        ]
    mpri, prlo, prqn, mdri, dro = infeas
    if criteria.l_inf:
        primal_err, primal_base = linf_pr, s.norm_b_inf
        dual_err, dual_base = linf_dr, s.norm_c_inf
    else:
        primal_err, primal_base = l2_pr, s.norm_b_2
        dual_err, dual_base = l2_dr, s.norm_c_2
    abs_tol, rel_tol = criteria.abs_tol, criteria.rel_tol
    neg = -prlo
    conditions = [
        (1, (dual_err < abs_tol + rel_tol * dual_base)
         & (primal_err < abs_tol + rel_tol * primal_base)
         & (gap < abs_tol + rel_tol * abs_obj)),
        (2, (dro > 0.0) & (mdri / dro <= criteria.eps_primal_infeasible)),
        (3, (prlo < 0.0) & (mpri / neg <= criteria.eps_dual_infeasible)
         & (prqn / neg <= criteria.eps_dual_infeasible)),
        (5, torch.as_tensor(s.iteration) >= criteria.iteration_limit),
        (6, torch.as_tensor(s.kkt_passes) >= criteria.kkt_limit),
        (4, torch.as_tensor(s.elapsed) >= criteria.time_limit),
        (7, torch.as_tensor(s.numerical_error)),
    ]
    reason = torch.zeros((), dtype=torch.int32, device=p.device)
    for code, cond in reversed(conditions):
        reason = torch.where(cond.to(p.device), code, reason).to(
            torch.int32)
    return torch.stack(conv), torch.stack(infeas), reason


def stats_dual_plain(dual, ax, aray, rhs, is_equality, primal_totals,
                     primal_norm, scalars: Scalars, criteria: Criteria):
    """F2f's contract: (dual totals, conv, infeas, reason)."""
    totals = stats_dual_totals_plain(dual, ax, aray, rhs, is_equality)
    return (totals, *stats_finalize_plain(primal_totals, totals,
                                          primal_norm, scalars, criteria))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _PointArgs(ctypes.Structure):
    """csrc/eval_stats.cu's PointArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "y", "sum_x", "sum_y", "count_x", "count_y", "weight_x",
        "weight_y", "numerical_error", "variable_rescaling",
        "constraint_rescaling", "scaled_x", "scaled_y", "primal", "dual",
        "primal_norm", "norm_word", "ticket")] + [
        ("n", ctypes.c_int), ("m", ctypes.c_int), ("blocks", ctypes.c_int)]


class _PrimalArgs(ctypes.Structure):
    """csrc/eval_stats.cu's PrimalArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "primal", "aty", "objective", "lower", "upper", "primal_norm",
        "ray", "partials", "totals", "ticket")] + [
        ("n", ctypes.c_int), ("blocks", ctypes.c_int)]


class _DualArgs(ctypes.Structure):
    """csrc/eval_stats.cu's DualArgs, passed by address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "dual", "ax", "aray", "rhs", "is_equality", "primal_totals",
        "primal_norm", "objective_constant", "norm_c_inf", "norm_b_inf",
        "norm_c_2", "norm_b_2", "numerical_error", "iteration",
        "kkt_passes", "elapsed", "partials", "totals", "conv", "infeas",
        "reason", "ticket")] + [
        ("iteration_value", ctypes.c_longlong),
        ("iteration_limit", ctypes.c_longlong),
        ("kkt_value", ctypes.c_double),
        ("kkt_limit", ctypes.c_double),
        ("elapsed_value", ctypes.c_double),
        ("time_limit", ctypes.c_double),
        ("eps_ratio", ctypes.c_float),
        ("abs_tol", ctypes.c_float),
        ("rel_tol", ctypes.c_float),
        ("eps_primal_infeasible", ctypes.c_float),
        ("eps_dual_infeasible", ctypes.c_float),
        ("numerical_error_value", ctypes.c_int),
        ("l_inf", ctypes.c_int),
        ("m", ctypes.c_int),
        ("blocks", ctypes.c_int),
    ]


# One ticket a kernel a device, and F2d's word of max |primal| bits
# (int32, each back at zero after each launch).
_TICKETS: Dict[torch.device, torch.Tensor] = {}
TICKET = {"stats_point": 0, "stats_primal": 1, "stats_dual": 2,
          "point_norm": 3}


def tickets(device: torch.device) -> torch.Tensor:
    """The device's tickets: made (zeroed) by the first launch there, a
    capture's eager warm-up or an eager evaluation."""
    out = _TICKETS.get(device)
    if out is None:
        out = _TICKETS[device] = torch.zeros(len(TICKET), dtype=torch.int32,
                                             device=device)
    return out


def stats_grid(items: int, sms: int, depth: int) -> int:
    """F2e's or F2f's blocks over `items` entries on a card of `sms` SMs
    that each hold `depth` of its blocks at once (stats_wave): a thread a
    16-byte slot, at most one wave, at least one block."""
    slots = -(-items // SLOT_FLOATS)
    return max(1, min(sms * depth, -(-slots // THREADS)))


def point_chunks(items: int) -> int:
    """F2d's chunks over a part of `items` entries (point_chunks): THREADS
    16-byte slots each."""
    return -(-items // CHUNK_FLOATS)


def point_grid(n: int, m: int, sms: int, depth: int) -> int:
    """F2d's blocks over x's n and y's m entries on a card of `sms` SMs
    that each hold `depth` of its blocks at once: a block a chunk (x's
    chunks, then y's), at most one wave, at least one block."""
    return max(1, min(sms * depth, point_chunks(n) + point_chunks(m)))


def point_layout(n: int, m: int, scaled: bool):
    """(scaled x, scaled y, primal, dual, norm)'s offsets in F2d's output
    buffer, in floats (the scaled ones None where `scaled` is not set),
    and the buffer's length: each part starts at a multiple of 4 floats
    (16 bytes), so the kernels after F2d read whole 16-byte slots."""
    at, offsets = 0, []
    for size in ((n, m) if scaled else ()) + (n, m):
        offsets.append(at)
        at += -(-size // SLOT_FLOATS) * SLOT_FLOATS
    if not scaled:
        offsets = [None, None] + offsets
    return (*offsets, at), at + 1


def partial_index(k: int, b: int, blocks: int) -> int:
    """Where value k of block b lies in the partials of F2e's or F2f's
    launch of `blocks` blocks (csrc partial_index): value-major."""
    return k * blocks + b


# (device index, kernel) -> (SMs, blocks an SM holds)
_WAVE: dict = {}
# folp_stats_occupancy's kernel argument
OCCUPANCY = {"stats_primal": 0, "stats_dual": 1, "stats_point": 2}


def stats_wave(device, kernel: str) -> tuple:
    """(SMs, blocks of `kernel` (a key of OCCUPANCY) an SM holds at once)
    of the CUDA `device`: its multiprocessor count and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once per device
    and kernel, and cached. Raises when the query fails."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, kernel)
    if key not in _WAVE:
        query = kernels_build.library(kernel).folp_stats_occupancy
        query.argtypes = [ctypes.c_int, ctypes.c_void_p]
        query.restype = ctypes.c_int
        count = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = query(OCCUPANCY[kernel], ctypes.byref(count))
        if err != 0 or count.value < 1:
            raise RuntimeError(f"{kernel} occupancy query failed: CUDA "
                               f"error {err}, {count.value} blocks")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _WAVE[key] = (sms, count.value)
    return _WAVE[key]


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _ticket(device, name: str) -> int:
    t = tickets(device)
    return t.data_ptr() + 4 * TICKET[name]


def stats_point(x, y, variable_rescaling, constraint_rescaling,
                average: Optional[Average] = None) -> Point:
    """F2d: stats_point_plain's contract; on CUDA one launch into one new
    tensor (point_layout: each part on 16 bytes)."""
    vectors = (x, y, variable_rescaling, constraint_rescaling)
    avg = () if average is None else tuple(average)
    if _on_cpu(*vectors, *avg):
        return stats_point_plain(x, y, variable_rescaling,
                                 constraint_rescaling, average)
    n, m = x.shape[0], y.shape[0]
    for name, t, size in (("x", x, n), ("y", y, m),
                          ("variable_rescaling", variable_rescaling, n),
                          ("constraint_rescaling", constraint_rescaling, m)):
        _check(name, t, torch.float32, (size,))
    if average is not None:
        for name, t, dtype, shape in (
                ("sum_x", average.sum_x, torch.float32, (n,)),
                ("sum_y", average.sum_y, torch.float32, (m,)),
                ("count_x", average.count_x, torch.int64, ()),
                ("count_y", average.count_y, torch.int64, ()),
                ("weight_x", average.weight_x, torch.float32, ()),
                ("weight_y", average.weight_y, torch.float32, ()),
                ("numerical_error", average.numerical_error, torch.bool,
                 ())):
            _check(name, t, dtype, shape)
    device = x.device
    (sx, sy, px, dy, at), size = point_layout(n, m, average is not None)
    out = torch.empty(size, dtype=torch.float32, device=device)
    scaled_x = scaled_y = None
    if average is not None:
        scaled_x, scaled_y = out[sx:sx + n], out[sy:sy + m]
    primal, dual, norm = out[px:px + n], out[dy:dy + m], out[at]
    args = _PointArgs(
        *(_ptr(t) for t in (x, y, *(avg or (None,) * 7),
                            variable_rescaling, constraint_rescaling,
                            scaled_x, scaled_y, primal, dual, norm)),
        _ticket(device, "point_norm"), _ticket(device, "stats_point"), n, m,
        point_grid(n, m, *stats_wave(device, "stats_point")))
    _launch("stats_point", args, device)
    return Point(scaled_x, scaled_y, primal, dual, norm)


def stats_primal(primal, aty, objective, lower, upper, primal_norm,
                 ray: bool):
    """F2e: stats_primal_plain's contract; on CUDA one launch, the ray
    and the totals in new tensors."""
    vectors = (primal, aty, objective, lower, upper)
    if _on_cpu(*vectors, primal_norm):
        return stats_primal_plain(primal, aty, objective, lower, upper,
                                  primal_norm, ray)
    n = primal.shape[0]
    for name, t in zip(("primal", "aty", "objective", "lower", "upper"),
                       vectors):
        _check(name, t, torch.float32, (n,))
    _check("primal_norm", primal_norm, torch.float32, ())
    device = primal.device
    k = len(PRIMAL_TOTALS)
    grid = stats_grid(n, *stats_wave(device, "stats_primal"))
    scratch = torch.empty((grid + 1) * k, dtype=torch.float64,
                          device=device)
    totals, partials = scratch[:k], scratch[k:]
    ray_out = (torch.empty(n, dtype=torch.float32, device=device) if ray
               else None)
    args = _PrimalArgs(
        *(_ptr(t) for t in (*vectors, primal_norm, ray_out, partials,
                            totals)),
        _ticket(device, "stats_primal"), n, grid)
    _launch("stats_primal", args, device)
    return ray_out, totals


def _host_or_ptr(value, dtype, name):
    """(pointer, host value) of a 0-d tensor of `dtype` or a host
    number."""
    if isinstance(value, torch.Tensor):
        _check(name, value, dtype, ())
        return value.data_ptr(), 0
    return 0, value


def stats_dual(dual, ax, aray, rhs, is_equality, primal_totals,
               primal_norm, scalars: Scalars, criteria: Criteria):
    """F2f with the finalize: stats_dual_plain's contract; on CUDA one
    launch, (dual totals, conv (16,), infeas (5,), reason) new tensors.
    `aray` must be given exactly when criteria.ray."""
    if (aray is not None) != criteria.ray:
        raise ValueError("A ray is given exactly when infeasibility is "
                         "detected")
    vectors = (dual, ax, rhs, is_equality,
               *(() if aray is None else (aray,)))
    tensors = [v for v in scalars if isinstance(v, torch.Tensor)]
    if _on_cpu(*vectors, primal_totals, primal_norm, *tensors):
        return stats_dual_plain(dual, ax, aray, rhs, is_equality,
                                primal_totals, primal_norm, scalars,
                                criteria)
    m = dual.shape[0]
    for name, t in (("dual", dual), ("ax", ax), ("rhs", rhs),
                    *(() if aray is None else (("aray", aray),))):
        _check(name, t, torch.float32, (m,))
    _check("is_equality", is_equality, torch.bool, (m,))
    _check("primal_totals", primal_totals, torch.float64,
           (len(PRIMAL_TOTALS),))
    _check("primal_norm", primal_norm, torch.float32, ())
    for name in ("objective_constant", "norm_c_inf", "norm_b_inf",
                 "norm_c_2", "norm_b_2"):
        _check(name, getattr(scalars, name), torch.float32, ())
    flag_ptr, flag = _host_or_ptr(scalars.numerical_error, torch.bool,
                                  "numerical_error")
    it_ptr, iteration = _host_or_ptr(scalars.iteration, torch.int64,
                                     "iteration")
    kkt_ptr, kkt = _host_or_ptr(scalars.kkt_passes, torch.float64,
                                "kkt_passes")
    el_ptr, elapsed = _host_or_ptr(scalars.elapsed, torch.float64,
                                   "elapsed")
    device = dual.device
    k = len(DUAL_TOTALS)
    grid = stats_grid(m, *stats_wave(device, "stats_dual"))
    scratch = torch.empty((grid + 1) * k, dtype=torch.float64,
                          device=device)
    totals, partials = scratch[:k], scratch[k:]
    fields = torch.empty(16 + 5, dtype=torch.float32, device=device)
    reason = torch.empty((), dtype=torch.int32, device=device)

    def f32(v: float) -> float:
        with np.errstate(over="ignore"):
            return float(np.float32(v))

    args = _DualArgs(
        *(_ptr(t) for t in (dual, ax, aray, rhs, is_equality, primal_totals,
                            primal_norm, *scalars[:5])),
        flag_ptr, it_ptr, kkt_ptr, el_ptr,
        *(_ptr(t) for t in (partials, totals, fields[:16], fields[16:],
                            reason)),
        _ticket(device, "stats_dual"),
        int(iteration), criteria.iteration_limit, float(kkt),
        criteria.kkt_limit, float(elapsed), criteria.time_limit,
        f32(criteria.eps_ratio), f32(criteria.abs_tol),
        f32(criteria.rel_tol), f32(criteria.eps_primal_infeasible),
        f32(criteria.eps_dual_infeasible), int(bool(flag)),
        int(criteria.l_inf), m, grid)
    _launch("stats_dual", args, device)
    return totals, fields[:16], fields[16:], reason
