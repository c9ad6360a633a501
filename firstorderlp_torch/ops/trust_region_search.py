"""The f32 exact trust-region solve (trust_region._exact_trust_region)
as kernels of ``csrc/trust_region_search.cu``: F2b, the prologue (F2a)
and the knot search (the 31-level bisection, SEARCH_BITS levels a
trip), and F2c ``tr_solution``, the solution and its value sums.

F2b has two paths, chosen by the row's length alone (search_plan):

- ``tr_search``, one launch, a thread-block cluster a row: for a row
  whose knots the cluster's shared memory holds (up to 16 x 27,264 =
  436,224 entries, 8 x 27,264 on a card without 16-block clusters):
  the main path at 100k nodes, the fleets, every smaller call;
- the whole-card path (WHOLE_CARD) for a longer row (the 1M-node LP's
  rows of 2,000,001): ``tr_knots`` over one wave of the card works out
  each entry's knot once and keeps each warp's live knots (finite,
  > 0) in a device list, then SEARCH_TRIPS launches of ``tr_trip`` each
  test K points over the lists, fold the knots that left the bracket
  into base sums and compact the rest, so the lists shrink every trip.
  The launches read nothing back, so a CUDA graph captures them.

The JAX package has no Pallas kernel here: under ``jit`` XLA fuses its
trust region (``firstorderlp_tpu/trust_region.py:42``
``solve_bound_constrained_trust_region``, :112 ``_t_star_bisect``,
vmapped over the batch at :401). The port ran the same arithmetic as
about 620 PyTorch kernels a solve of the restart scheme's three rows.

The contract, fixed by the plain versions below: every per-row sum is
accumulated in f64 and rounded once to f32 (S(t), H(t), the totals and
the value sums); the elementwise work rounds each operation once in the
order written here; a knot below zero, or -0, is +0. The kernels add in
one fixed order with no floating-point atomics (F2c's row sums and the
whole-card path's: each block's into a scratch slot, the row's last
block, behind an integer ticket, adding the slots in block order), and
the plain versions in torch.sum's.
The terms of a sum are of one sign, so an order whose longest chain of
additions is D lands within D 2^-53 |S| of the exact sum S; two orders
round to different f32 values only where an f32 rounding midpoint
(these lie at least 2^-24 |S| apart) falls between their f64 results,
at odds of at most about (D1 + D2) 2^-29 a sum, about 2e-6 where
D1 + D2 is 2^10. So the kernels give these bits, bar a one-ulp
difference at those odds that comes from the order of addition and
repeats at every run on that input.

A row is a block row of the kernels' grid (its y index), so a call of
more than MAX_ROWS rows runs as several launches of at most MAX_ROWS rows
each, in order on the caller's stream (``row_chunks``): a row's t*,
solution and sums are its own, so they have the bits one launch would
give. The plain versions take the same chunks.

Each wrapper takes the plain version only when its tensors are on the
CPU; for CUDA tensors it launches its kernel or raises, and any other
device raises. Every launch adds one to its kernel's entry in
``ops/routed.LAUNCHES`` (the whole-card path: ``tr_knots`` once a call,
``tr_trip`` once a trip).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import kernels_build, routed
from .pdhg_step import _on_cpu

KNOT_TRIPS = 31  # bisection trips on the float bits of t
MAX_CLUSTER = 8  # blocks a row: the portable cluster size
WIDE_CLUSTER = 16  # tr_search's non-portable size, where the card runs it
# Dynamic shared memory a tr_search block may stage (tau, a) in: 227 KB
# less room for the kernel's static arrays (about 7 KB: the warps' and
# the cluster's blocks' 2K sums of a trip) and a margin.
STAGE_BYTES = 227 * 1024 - 14 * 1024
# A block count that fills the card's 132 SMs about twice over.
TARGET_BLOCKS = 264
# tr_search's bisection levels a trip (K = 2^SEARCH_BITS - 1 test points),
# its trips and its threads a block: csrc/trust_region_search.cu's
# kSearchBits and kSearchThreads.
SEARCH_BITS = 3
SEARCH_TRIPS = -(-KNOT_TRIPS // SEARCH_BITS)
SEARCH_THREADS = 512
# tr_solution's threads a block (csrc kSolutionThreads)
SOLUTION_THREADS = 256
# The whole-card path's threads a block (csrc kSweepThreads), its warps,
# the sums a block sends a trip (kSweepValues: S and H at each of the K
# points, then the fold's S and H) and a row's search state between its
# launches (kSweepRowDoubles, two copies a row)
SWEEP_THREADS = 256
SWEEP_WARPS = SWEEP_THREADS // 32
SWEEP_VALUES = 16
SWEEP_ROW_DOUBLES = 8
MAX_ROWS = 65535  # rows a launch: the grid's y extent


class Prologue(NamedTuple):
    """The knots of a batch of rows ((B, N) each) and the rows' totals
    ((B,) each): S at the last finite knot, H beyond it (the components
    that never meet a bound), the largest finite knot, and g = 0."""

    direction: torch.Tensor
    tau: torch.Tensor
    a: torch.Tensor
    finite: torch.Tensor
    s_total: torch.Tensor
    h_infinite: torch.Tensor
    tau_max: torch.Tensor
    g_zero: torch.Tensor


def _sum64(v: torch.Tensor) -> torch.Tensor:
    """Row sums of f32 terms accumulated in f64, rounded once to f32."""
    return torch.sum(v, dim=-1, dtype=torch.float64).to(torch.float32)


def _direction(c, g, lower, upper, weight):
    """0 for a component at a bound the objective pushes outward, else
    -g / w (reference trust_region_utils.jl:95-102)."""
    frozen = ((c >= upper) & (g <= 0.0)) | ((c <= lower) & (g >= 0.0))
    return torch.where(frozen, 0.0, -g / weight)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def tr_prologue_plain(c, g, lower, upper, weight) -> Prologue:
    """F2a's contract: c, g (B, N); the bounds and weights (N,) or
    (B, N)."""
    direction = _direction(c, g, lower, upper, weight)
    tau = torch.where(
        direction > 0,
        (upper - c) / torch.where(direction > 0, direction, 1.0),
        torch.where(
            direction < 0,
            (lower - c) / torch.where(direction < 0, direction, 1.0),
            0.0,
        ),
    )
    tau = torch.where(tau <= 0.0, 0.0, tau)  # -0 and below to +0, NaN kept
    a = weight * direction * direction
    finite = torch.isfinite(tau)
    return Prologue(
        direction=direction, tau=tau, a=a, finite=finite,
        s_total=_sum64(torch.where(finite, a * tau * tau, 0.0)),
        h_infinite=_sum64(torch.where(finite, 0.0, a)),
        tau_max=_row_max(torch.where(finite, tau, 0.0)),
        g_zero=~torch.any(g * g != 0.0, dim=-1),
    )


def _row_max(v: torch.Tensor) -> torch.Tensor:
    """Row maxima of values >= +0, +0 for an empty row."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.amax(v, dim=-1)


def _r2_parts(p: Prologue, t):
    """(S(t), H(t)) per row: the clamped part over the finite knots at
    or below t, the still-moving part over the rest."""
    clamped = p.finite & (p.tau <= t[:, None])
    return (_sum64(torch.where(clamped, p.a * p.tau * p.tau, 0.0)),
            _sum64(torch.where(clamped, 0.0, p.a)))


def tr_search_plain(p: Prologue, radius) -> torch.Tensor:
    """F2b's contract: t* (B,) for radii (B,). 31 trips of bisection on
    the float bits of t in [0, bits(tau_max)] isolate the largest t with
    r^2(t) = S + t^2 H below r^2 (the JAX package's _t_star_bisect);
    t* solves S + t^2 H = r^2 on that segment, or beyond the last
    finite knot, and is 0 for a radius <= 0 or g = 0."""
    target_r2 = radius * radius
    lo = torch.zeros_like(p.tau_max, dtype=torch.int32)
    hi = p.tau_max.contiguous().view(torch.int32)
    for _ in range(KNOT_TRIPS):
        mid = lo + ((hi - lo + 1) >> 1)
        t = mid.view(torch.float32)
        s, h = _r2_parts(p, t)
        below = s + t * t * h < target_r2
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    low_before, high_before = _r2_parts(p, lo.view(torch.float32))
    return t_star_from(p, radius, low_before, high_before)


def t_star_from(p: Prologue, radius, low_before, high_before):
    """t* from the prologue and (S, H) at the search's last t below r^2:
    the tail of tr_search_plain, which the kernel computes alike."""
    target_r2 = radius * radius
    # Does any finite knot reach r^2?  r^2 at the last finite knot is
    # s_total + tau_max^2 h_infinite.
    any_hit = (p.s_total + p.tau_max * p.tau_max * p.h_infinite
               >= target_r2)
    t_interior = torch.sqrt(
        torch.clamp_min(target_r2 - low_before, 0.0)
        / torch.where(high_before > 0, high_before, 1.0)
    )
    # No finite knot reaches r^2: the unbounded components keep moving,
    # or every bound is met first (t = tau_max, reference l.175-181).
    t_beyond = torch.where(
        p.h_infinite > 0,
        torch.sqrt(
            torch.clamp_min(target_r2 - p.s_total, 0.0)
            / torch.where(p.h_infinite > 0, p.h_infinite, 1.0)
        ),
        p.tau_max,
    )
    t_star = torch.where(any_hit, t_interior, t_beyond)
    # Zero radius or zero objective: stay at the center (reference
    # l.88-91).
    return torch.where((radius <= 0.0) | p.g_zero, 0.0, t_star)


def tr_solution_plain(c, g, lower, upper, weight, t_star, split: int):
    """F2c's contract: (solution (B, N), parts (B, 2), value (B,)):
    solution = clamp(c + t* d, l, u); parts the sums of g (solution - c)
    over the columns [0, split) and [split, N); value over all."""
    direction = _direction(c, g, lower, upper, weight)
    solution = torch.clamp(c + t_star[:, None] * direction, lower, upper)
    terms = g * (solution - c)
    parts = torch.stack([_sum64(terms[:, :split]),
                         _sum64(terms[:, split:])], dim=-1)
    return solution, parts, _sum64(terms)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_INPUTS = ("c", "g", "lower", "upper", "weight")


class _TrustRegionArgs(ctypes.Structure):
    """csrc/trust_region_search.cu's TrustRegionArgs, passed by
    address."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "c", "g", "lower", "upper", "weight", "radius", "t_star",
        "solution", "sums", "partials", "tickets", "knots", "counts",
        "search")] + [
            (name, ctypes.c_int) for name in (
                *(f"{v}_{k}_stride" for v in _INPUTS
                  for k in ("row", "col")),
                "rows", "n", "split", "blocks")]


class SearchPlan(NamedTuple):
    cluster: int  # blocks a row's cluster; 0: the whole-card path
    smem_bytes: int  # a block's staged slice


# a row too long for a cluster to stage: tr_knots, then the trips
WHOLE_CARD = SearchPlan(0, 0)


def _one_wave(rows: int, n: int, sms: int, depth: int, threads: int) -> int:
    """Blocks a row of a grid of `threads`-thread blocks on a card of
    `sms` SMs that each hold `depth` of them at once: one wave over all
    rows, at most one block a `threads`-slot run of the row's ceil(n / 4)
    16-byte slots, at least one."""
    wanted = -(-depth * sms // max(rows, 1))
    slots = -(-n // 4)
    return max(1, min(wanted, -(-slots // threads)))


def solution_blocks(rows: int, n: int, sms: int, depth: int) -> int:
    """tr_solution's blocks a row (`depth` from solution_wave): one
    wave of SOLUTION_THREADS-thread blocks."""
    return _one_wave(rows, n, sms, depth, SOLUTION_THREADS)


def sweep_blocks(rows: int, n: int, sms: int, depth: int) -> int:
    """The whole-card path's blocks a row (`depth` from sweep_wave): one
    wave of SWEEP_THREADS-thread blocks."""
    return _one_wave(rows, n, sms, depth, SWEEP_THREADS)


def search_plan(rows: int, n: int,
                max_cluster: int = MAX_CLUSTER) -> SearchPlan:
    """F2b's launch for `rows` rows of `n` entries with clusters of at
    most `max_cluster` blocks (search_cluster_limit: 16 where the card
    runs them, else 8): tr_search on the fewest blocks a row whose slices
    fit in shared memory (8 bytes an entry), raised to TARGET_BLOCKS
    blocks in all for few rows; WHOLE_CARD for a row longer than
    `max_cluster` slices can stage."""
    need = max(1, -(-8 * n // STAGE_BYTES))
    if need > max_cluster:
        return WHOLE_CARD
    wanted = min(max_cluster, max(1, -(-TARGET_BLOCKS // max(rows, 1))))
    cluster = max(wanted, need)
    return SearchPlan(cluster, 8 * (-(-n // cluster)))


# device index -> {cluster size: clusters co-resident}
_ACTIVE_CLUSTERS: dict = {}


def active_clusters(device) -> dict:
    """{8: a, 16: b}: how many clusters of 8 and of 16 tr_search blocks
    (each block staging STAGE_BYTES) the CUDA `device` runs at once, by
    cudaOccupancyMaxActiveClusters; queried once per device, and cached.
    Raises when the query fails."""
    device = torch.device(device)
    with torch.cuda.device(device):
        key = torch.cuda.current_device()
        if key not in _ACTIVE_CLUSTERS:
            query = kernels_build.library("tr_search").folp_tr_search_clusters
            query.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
            query.restype = ctypes.c_int
            found = {}
            for cluster in (MAX_CLUSTER, WIDE_CLUSTER):
                count = ctypes.c_int(0)
                err = query(cluster, STAGE_BYTES, ctypes.byref(count))
                if err != 0:
                    raise RuntimeError(
                        f"tr_search cluster query ({cluster} blocks) "
                        f"failed: CUDA error {err}")
                found[cluster] = count.value
            _ACTIVE_CLUSTERS[key] = found
    return dict(_ACTIVE_CLUSTERS[key])


def search_cluster_limit(device) -> int:
    """WIDE_CLUSTER where `device` co-schedules a cluster of that many
    tr_search blocks, else MAX_CLUSTER (the portable size)."""
    wide = active_clusters(device)[WIDE_CLUSTER] >= 1
    return WIDE_CLUSTER if wide else MAX_CLUSTER


def device_search_plan(rows: int, n: int, device) -> SearchPlan:
    """search_plan with the CUDA `device`'s cluster limit: tr_search's
    plan on that card."""
    return search_plan(rows, n, search_cluster_limit(device))


def _strided(name: str, t: torch.Tensor, rows: int, n: int):
    """(tensor, row stride, column stride) of an input as it lies: c and
    g (B, N), the bounds and weights (N,) (row stride 0) or (B, N), any
    strides (a transposed view, an expanded vector), never a copy."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() == 1 and name not in ("c", "g"):
        if t.shape[0] != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"({n},) or ({rows}, {n})")
        strides = (0, t.stride(0))
    elif tuple(t.shape) != (rows, n):
        want = f"({rows}, {n})" if name in ("c", "g") else (
            f"({n},) or ({rows}, {n})")
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    else:
        strides = t.stride()
    if max(strides) >= 2 ** 31:
        raise ValueError(f"{name}'s strides {strides} exceed an int")
    return t, *strides


def _args(c, g, lower, upper, weight, radius, t_star, solution, sums,
          split, blocks, partials=None, tickets=None, knots=None,
          counts=None, search=None):
    rows, n = c.shape
    if not 0 < rows <= MAX_ROWS:
        raise ValueError(f"{rows} rows: 1 to {MAX_ROWS} a launch")
    inputs = [_strided(name, t, rows, n) for name, t in zip(
        _INPUTS, (c, g, lower, upper, weight))]
    for name, t in (("radius", radius), ("t_star", t_star)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (rows,)):
            raise ValueError(f"{name} must be float32 ({rows},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if radius is not None:
        radius = radius.contiguous()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    args = _TrustRegionArgs(
        *(ptr(t) for t, _, _ in inputs), ptr(radius), ptr(t_star),
        ptr(solution), ptr(sums), ptr(partials), ptr(tickets), ptr(knots),
        ptr(counts), ptr(search),
        *(stride for _, *strides in inputs for stride in strides),
        rows, n, split, blocks)
    # the tensors the arguments point into, alive until the launch
    return args, (radius, t_star, *(t for t, _, _ in inputs))


def _launch(lib: str, args: ctypes.Structure, device, *extra,
            launches=None) -> None:
    """folp_<lib> on the current stream; adds `launches` ({kernel:
    count}, by default {lib: 1}) to ops/routed.LAUNCHES."""
    fn = kernels_build.kernel_function(lib)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), *extra, stream)
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    for kernel, count in (launches or {lib: 1}).items():
        routed.LAUNCHES[kernel] += count


def _check_call(c, g, lower, upper, weight, per_row) -> None:
    """Raises unless the inputs have a call's shapes and types: c, g (B,
    N), the bounds and weights (N,) or (B, N), each of `per_row` ((name,
    tensor): the radius, t*) float32 (B,). Each launch checks its
    chunk's again."""
    rows, n = c.shape
    for name, t in zip(_INPUTS, (c, g, lower, upper, weight)):
        _strided(name, t, rows, n)
    for name, t in per_row:
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,):
            raise ValueError(f"{name} must be float32 ({rows},), got "
                             f"{t.dtype} {tuple(t.shape)}")


def row_chunks(rows: int, c, g, lower, upper, weight, *per_row):
    """(lo, hi, inputs, per_row) for each launch of a call of `rows` rows,
    in order: the rows [lo, hi), at most MAX_ROWS of them (one chunk of no
    rows for an empty call); `inputs` c, g and the (B, N) bounds and
    weights cut to those rows ((N,) ones whole), and each tensor of
    `per_row` (one entry or row a row: the radius, t*, the outputs) cut
    likewise."""
    for lo in range(0, max(rows, 1), MAX_ROWS):
        hi = min(lo + MAX_ROWS, rows)
        inputs = [t[lo:hi] if t.dim() == 2 else t
                  for t in (c, g, lower, upper, weight)]
        yield lo, hi, inputs, [t[lo:hi] for t in per_row]


def tr_search(c, g, lower, upper, weight, radius,
              plan: Optional[SearchPlan] = None) -> torch.Tensor:
    """F2b (with F2a): tr_search_plain(tr_prologue_plain(...), radius)'s
    contract; on CUDA each row_chunks chunk runs tr_search (one launch)
    or, under WHOLE_CARD, the whole-card path (_sweep), t* a new (B,)
    tensor. `plan` defaults to device_search_plan's for all the rows
    (another cluster size, or WHOLE_CARD, for a test or a timing; a
    cluster must stage the whole row)."""
    rows, n = c.shape
    if _on_cpu(c, g, lower, upper, weight, radius):
        out = [tr_search_plain(tr_prologue_plain(*inputs), r)
               for _, _, inputs, (r,) in row_chunks(rows, c, g, lower, upper,
                                                    weight, radius)]
        return out[0] if len(out) == 1 else torch.cat(out)
    if plan is None:
        plan = device_search_plan(rows, n, c.device)
    elif plan.cluster and plan.cluster * plan.smem_bytes < 8 * n:
        raise ValueError(f"{plan} stages fewer than the row's {n} entries")
    _check_call(c, g, lower, upper, weight, [("radius", radius)])
    t_star = torch.empty(rows, dtype=torch.float32, device=c.device)
    for _, _, inputs, (r, t) in row_chunks(rows, c, g, lower, upper, weight,
                                           radius.contiguous(), t_star):
        if plan == WHOLE_CARD:
            _sweep(inputs, r, t)
            continue
        args, keep = _args(*inputs, r, t, None, None, n, plan.cluster)
        _launch("tr_search", args, c.device, plan.smem_bytes)
        del keep
    return t_star


def _sweep(inputs, radius, t_star, trips: int = SEARCH_TRIPS):
    """The whole-card path on one chunk's rows (`inputs`: c, g, the
    bounds, the weights): tr_knots, then `trips` launches of tr_trip
    (SEARCH_TRIPS write t*; a timing harness may stop earlier), one
    ctypes call. Its scratch comes from the caching allocator (a
    capture's pool inside a CUDA graph): each row's live-knot lists (8
    bytes an entry), the warps' list lengths, which it returns, the
    blocks' sums and the rows' search state; the tickets are the
    device's (solution_tickets)."""
    c = inputs[0]
    rows, n = c.shape
    device = c.device
    blocks = sweep_blocks(rows, n, *sweep_wave(device))
    knots = torch.empty((rows, 8 * -(-n // 4)), dtype=torch.float32,
                        device=device)
    counts = torch.empty((rows, blocks * SWEEP_WARPS), dtype=torch.int32,
                         device=device)
    partials = torch.empty((rows, blocks * SWEEP_VALUES),
                           dtype=torch.float64, device=device)
    search = torch.empty((2, rows, SWEEP_ROW_DOUBLES), dtype=torch.float64,
                         device=device)
    args, keep = _args(*inputs, radius, t_star, None, None, n, blocks,
                       partials, solution_tickets(device), knots, counts,
                       search)
    _launch("tr_sweep", args, device, trips,
            launches={"tr_knots": 1, "tr_trip": trips})
    del keep
    return counts


# (library, device index) -> (SMs, the library's blocks an SM holds);
# device index -> the trust region's tickets (MAX_ROWS int32, zero
# between launches)
_WAVE: dict = {}
_TICKETS: dict = {}


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _wave(lib: str, device) -> tuple:
    """(SMs, blocks of `lib`'s kernels an SM holds at once) of the CUDA
    `device`: its multiprocessor count and folp_<lib>_occupancy
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), queried once per
    device and cached. Raises when the query fails."""
    index = _index(device)
    if (lib, index) not in _WAVE:
        query = getattr(kernels_build.library(lib), f"folp_{lib}_occupancy")
        query.argtypes = [ctypes.c_void_p]
        query.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = query(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"{lib} occupancy query failed: CUDA error "
                               f"{err}, {blocks.value} blocks")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _WAVE[lib, index] = (sms, blocks.value)
    return _WAVE[lib, index]


def solution_wave(device) -> tuple:
    """(SMs, tr_solution blocks an SM holds at once) of the CUDA
    `device`, cached."""
    return _wave("tr_solution", device)


def sweep_wave(device) -> tuple:
    """(SMs, blocks of the whole-card path's kernels an SM holds at once,
    the fewer of tr_knots and tr_trip) of the CUDA `device`, cached."""
    return _wave("tr_sweep", device)


def solution_tickets(device) -> torch.Tensor:
    """The CUDA `device`'s trust-region tickets, one a row, which
    tr_solution and the whole-card path's launches share: made (zeroed)
    by the first launch there (an eager evaluation or a capture's
    warm-up), each set back to zero by the row's last block, so one
    device's trust regions run on one stream at a time."""
    index = _index(device)
    if index not in _TICKETS:
        _TICKETS[index] = torch.zeros(MAX_ROWS, dtype=torch.int32,
                                      device=torch.device("cuda", index))
    return _TICKETS[index]


def tr_solution(c, g, lower, upper, weight, t_star, split: int,
                blocks: Optional[int] = None):
    """F2c: tr_solution_plain's contract; on CUDA a launch for each
    row_chunks chunk, the solution (B, N) and the sums in new tensors.
    `blocks` (blocks a row) defaults to solution_blocks for the card's
    wave and all the rows (the card tests give others: the same bits at
    any grid)."""
    rows, n = c.shape
    if _on_cpu(c, g, lower, upper, weight, t_star):
        out = [tr_solution_plain(*inputs, t, split)
               for _, _, inputs, (t,) in row_chunks(rows, c, g, lower, upper,
                                                    weight, t_star)]
        return out[0] if len(out) == 1 else tuple(
            torch.cat(parts) for parts in zip(*out))
    if not 0 <= split <= n:
        raise ValueError(f"split {split} outside [0, {n}]")
    _check_call(c, g, lower, upper, weight, [("t_star", t_star)])
    if blocks is None:
        blocks = solution_blocks(rows, n, *solution_wave(c.device))
    solution = torch.empty((rows, n), dtype=torch.float32, device=c.device)
    sums = torch.empty((rows, 3), dtype=torch.float32, device=c.device)
    partials = torch.empty((rows, 2 * blocks), dtype=torch.float64,
                           device=c.device)
    for _, _, inputs, (t, x, s, part) in row_chunks(
            rows, c, g, lower, upper, weight, t_star.contiguous(), solution,
            sums, partials):
        args, keep = _args(*inputs, None, t, x, s, split, blocks, part,
                           solution_tickets(c.device))
        _launch("tr_solution", args, c.device)
        del keep
    return solution, sums[:, :2], sums[:, 2]
