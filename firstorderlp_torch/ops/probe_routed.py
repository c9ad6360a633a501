"""Microbenchmarks of the two halves of a routed sparse product: the
expand (a gather from strips of the input) and the reduce (a scatter-add
into strips of the output), the port's counterpart of the JAX package's
``benchmarking/probe_routed.py``.

    python3 -m firstorderlp_torch.ops.probe_routed [nnz]

prints, for each of the two kernels, its time on the card (CUDA events,
median of 100 launches), its device time and the kernels it launches a
call (torch.profiler), each the median of three turns, the bound from
the bytes it must move, the same times of the one PyTorch call that
computes the same, entries per second and the largest error against
numpy; then a chunk gather (``torch.index_select`` of 128-wide rows,
which the JAX package leaves to XLA outside any kernel) and two f64
sanity lines. Every line follows the card's name and power limit as
``nvidia-smi`` gives them. ``compare_kernels --layout probe`` times the
two kernels beside another version of this package and sweeps the
reduce's chunks and warps.

The entries come in groups of 8 x 128 = 1024; a group reads one strip of
``H`` x 128 inputs (expand) or adds into one strip of ``HR`` x 128
outputs (reduce), named by a sorted table. ``probe_expand`` and
``probe_reduce`` launch the CUDA kernels of ``csrc/probe_expand.cu`` and
``csrc/probe_reduce.cu``; each takes its plain PyTorch version beside it
only for tensors on the CPU, and launches its kernel or raises for CUDA
tensors. Each launch adds one to the wrapper's entry in ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from . import kernels_build
from .device import resolve_device

DEFAULT_NNZ = 819_200
H = 32  # rows of an input strip: a strip holds H * 128 = 4096 values
HR = 32  # rows of an output strip
N_STRIPS = 8
GROUP_ROWS = 8  # a group is 8 rows of 128 entries
GROUP_ENTRIES = GROUP_ROWS * 128
TIMING_REPS = 100
TURNS = 3  # turns of in_turns: the spread of a device time between turns
# The host calls that put one record on the device each, as
# torch.profiler names them: kernel launches (runtime and driver API)
# and asynchronous copies and fills.
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
    "cudaMemsetAsync"})

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores

# Blocks of probe_expand aimed at: two for each of the card's 132 SMs.
EXPAND_TARGET_BLOCKS = 2 * 132
# probe_reduce: chunks aimed at (one block each, about one a SM), and
# warps a block, each with its own 20 KB copy of the strip: as many as
# an SM's 227 KB of shared memory holds. Picked by compare_kernels
# --layout probe --sweep on an H100 (PERF.md).
REDUCE_TARGET_CHUNKS = 132
REDUCE_WARPS = 11
MAX_REDUCE_WARPS = 11  # kMaxReduceWarps of csrc/probe_reduce.cu

LAUNCHES: Dict[str, int] = {"probe_expand": 0, "probe_reduce": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def make_probe_inputs(nnz: int = DEFAULT_NNZ, seed: int = 0,
                      with_f64: bool = False) -> Dict[str, np.ndarray]:
    """The probe's arrays, drawn from ``numpy.random.default_rng(seed)``
    in the order the JAX package's probe draws them, so that the same
    seed gives both packages the same arrays. `nnz` is rounded down to
    whole groups. `with_f64` adds the arrays of the f64 sanity lines
    (drawn last)."""
    rng = np.random.default_rng(seed)
    nnz = (int(nnz) // GROUP_ENTRIES) * GROUP_ENTRIES
    ngroups = nnz // GROUP_ENTRIES
    rows = ngroups * GROUP_ROWS
    out = {}
    out["strip_ids"] = np.sort(
        rng.integers(0, N_STRIPS, ngroups)
    ).astype(np.int32)
    out["x_strips"] = rng.normal(size=(N_STRIPS, H, 128)).astype(np.float32)
    out["hi"] = rng.integers(0, H, (rows, 128)).astype(np.int32)
    out["lo"] = rng.integers(0, 128, (rows, 128)).astype(np.int32)
    nchunks = nnz // 128
    out["g2"] = rng.normal(size=(nchunks, 128)).astype(np.float32)
    out["src"] = rng.permutation(nchunks).astype(np.int32)
    out_strip = np.sort(rng.integers(0, N_STRIPS, ngroups))
    meta = np.zeros((ngroups, 2), np.int32)
    meta[:, 0] = out_strip
    if ngroups:
        meta[0, 1] = 1
        meta[1:, 1] = (out_strip[1:] != out_strip[:-1]).astype(np.int32)
    out["meta"] = meta
    out["v"] = rng.normal(size=(rows, 128)).astype(np.float32)
    out["hir"] = rng.integers(0, HR, (rows, 128)).astype(np.int32)
    out["lor"] = rng.integers(0, 128, (rows, 128)).astype(np.int32)
    if with_f64:
        out["a64"] = rng.normal(size=(2048, 2048))
        out["x64"] = rng.normal(size=(2048,))
        out["big64"] = rng.normal(size=(1_000_000,))
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _row_strips(per_group: torch.Tensor) -> torch.Tensor:
    """The strip of every row of entries: a group's, eight times."""
    return per_group.long().repeat_interleave(GROUP_ROWS)[:, None]


def flat_slots(strips, hi, lo, rows_per_strip: int) -> torch.Tensor:
    """(strip * rows_per_strip + hi) * 128 + lo of every entry, int64:
    its place in the flattened strips."""
    return (_row_strips(strips) * rows_per_strip + hi.long()) * 128 + lo.long()


def probe_expand_plain(strip_ids, x_strips, hi, lo) -> torch.Tensor:
    """g[r, l] = x_strips[strip_ids[r // 8], hi[r, l], lo[r, l]] as one
    gather from the flattened strips."""
    flat = flat_slots(strip_ids, hi, lo, x_strips.shape[1])
    return x_strips.reshape(-1)[flat]


def probe_reduce_plain(meta, g, v, hi, lo, n_strips: int,
                       hr: int = HR) -> torch.Tensor:
    """y[meta[r // 8, 0], hi[r, l], lo[r, l]] += g[r, l] * v[r, l] from
    zero, as one index_add_ into the flattened strips; (n_strips, hr,
    128) in the dtype of `g`."""
    flat = flat_slots(meta[:, 0], hi, lo, hr).reshape(-1)
    y = torch.zeros(n_strips * hr * 128, dtype=g.dtype, device=g.device)
    y.index_add_(0, flat, (g * v).reshape(-1))
    return y.reshape(n_strips, hr, 128)


# ---------------------------------------------------------------------------
# The reduce kernel's chunk table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProbeReducePlan:
    """How probe_reduce cuts the groups into blocks. Row c of `chunks`
    is chunk c: [first group, strip, first chunk of the strip, chunks of
    the strip]; the chunk holds the groups up to the next row's first
    group, all of one strip, and a strip that no group names has one
    empty chunk. The last row is [ngroups, n_strips, nchunks, 0].
    `tickets` (one int32 a strip, zero between launches) belong to the
    plan, so its launches run on one stream."""

    chunks: torch.Tensor  # (nchunks + 1, 4) int32
    tickets: torch.Tensor  # (n_strips,) int32
    ngroups: int
    n_strips: int
    warps: int = REDUCE_WARPS  # warps a block

    def __post_init__(self):
        if not 1 <= int(self.warps) <= MAX_REDUCE_WARPS:
            raise ValueError(f"warps must lie in [1, {MAX_REDUCE_WARPS}]")

    @property
    def nchunks(self) -> int:
        return int(self.chunks.shape[0]) - 1


def plan_probe_reduce(meta: torch.Tensor, n_strips: int,
                      target_chunks: int = REDUCE_TARGET_CHUNKS
                      ) -> ProbeReducePlan:
    """Host-side build of the chunk table from `meta` (one transfer to
    the host; build it once for a table that is used again). A strip of
    r groups is cut into ceil(r / cap) chunks of floor or ceil of equal
    shares, cap = ceil(ngroups / target_chunks); a strip of no group is
    one empty chunk. Raises ValueError unless the strips are sorted and
    in range and meta[:, 1] marks exactly the first group of every
    strip."""
    table = meta.detach().cpu().numpy()
    if table.ndim != 2 or table.shape[1] != 2:
        raise ValueError(f"meta has shape {table.shape}, want (ngroups, 2)")
    ngroups = table.shape[0]
    strips = table[:, 0].astype(np.int64)
    first = np.ones(ngroups, dtype=bool)
    first[1:] = strips[1:] != strips[:-1]
    if ngroups and (strips.min() < 0 or strips.max() >= n_strips):
        raise ValueError("meta names a strip outside [0, n_strips)")
    if np.any(np.diff(strips) < 0):
        raise ValueError("meta's strips are not sorted")
    if not np.array_equal(table[:, 1] != 0, first):
        raise ValueError(
            "meta[:, 1] must be 1 at the first group of a strip and 0 "
            "elsewhere"
        )
    cap = max(1, -(-ngroups // max(int(target_chunks), 1)))
    run = np.bincount(strips, minlength=n_strips).astype(np.int64)
    run_start = np.cumsum(run) - run
    pieces = np.maximum(-(-run // cap), 1)
    first_chunk = np.cumsum(pieces) - pieces
    strip_of = np.repeat(np.arange(n_strips, dtype=np.int64), pieces)
    index = np.arange(int(pieces.sum())) - first_chunk[strip_of]
    chunks = np.zeros((len(strip_of) + 1, 4), dtype=np.int64)
    chunks[:-1, 0] = run_start[strip_of] + (
        index * run[strip_of]) // pieces[strip_of]
    chunks[:-1, 1] = strip_of
    chunks[:-1, 2] = first_chunk[strip_of]
    chunks[:-1, 3] = pieces[strip_of]
    chunks[-1, :3] = ngroups, n_strips, len(strip_of)
    return ProbeReducePlan(
        chunks=torch.as_tensor(chunks.astype(np.int32), device=meta.device),
        tickets=torch.zeros(int(n_strips), dtype=torch.int32,
                            device=meta.device),
        ngroups=ngroups,
        n_strips=int(n_strips),
    )


def reduce_scratch_bytes(plan: ProbeReducePlan, hr: int = HR) -> int:
    """Bytes probe_reduce moves beyond its inputs and output: the
    partial strips of the chunks of split strips, each written once and
    read once, and the chunk table."""
    chunks = plan.chunks.cpu().numpy()
    split = int(np.sum(chunks[:-1, 3] > 1))
    return 2 * 4 * hr * 128 * split + 16 * (plan.nchunks + 1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _all_on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name, t, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if device.type != "cuda":
        raise ValueError(f"{name} is not on a CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def probe_expand(strip_ids, x_strips, hi, lo) -> torch.Tensor:
    """g[r, l] = x_strips[strip_ids[r // 8], hi[r, l], lo[r, l]], exact.

    strip_ids: (ngroups,) int32, sorted; x_strips: (n_strips, H, 128)
    f32; hi, lo: (ngroups * 8, 128) int32 with 0 <= hi < H and
    0 <= lo < 128. Plain version for CPU tensors, else the probe_expand
    kernel, which gives 0 for an entry whose strip id, hi or lo is out
    of range (the plain version raises)."""
    if _all_on_cpu(strip_ids, x_strips, hi, lo):
        return probe_expand_plain(strip_ids, x_strips, hi, lo)
    device = x_strips.device
    if x_strips.dim() != 3 or x_strips.shape[2] != 128:
        raise ValueError("x_strips must have shape (n_strips, H, 128)")
    ngroups = int(strip_ids.shape[0])
    rows = ngroups * GROUP_ROWS
    _check("x_strips", x_strips, torch.float32, x_strips.shape, device)
    _check("strip_ids", strip_ids, torch.int32, (ngroups,), device)
    _check("hi", hi, torch.int32, (rows, 128), device)
    _check("lo", lo, torch.int32, (rows, 128), device)
    g = torch.empty(rows, 128, dtype=torch.float32, device=device)
    per_block = max(1, -(-ngroups // EXPAND_TARGET_BLOCKS))
    fn = kernels_build.kernel_function("probe_expand")
    err = fn(
        strip_ids.data_ptr(), x_strips.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), g.data_ptr(), ngroups, int(x_strips.shape[0]),
        int(x_strips.shape[1]), per_block,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"probe_expand launch failed: CUDA error {err}")
    LAUNCHES["probe_expand"] += 1
    return g


def probe_reduce(meta, g, v, hi, lo, n_strips: int, hr: int = HR,
                 plan: Optional[ProbeReducePlan] = None) -> torch.Tensor:
    """y[meta[r // 8, 0], hi[r, l], lo[r, l]] += g[r, l] * v[r, l] from
    zero, in f32 and in one fixed order; (n_strips, hr, 128).

    meta: (ngroups, 2) int32, [strip, first group of its strip], strips
    sorted; g, v: (ngroups * 8, 128) f32; hi, lo: the same shape, int32,
    unsorted; the kernel drops an entry whose hi or lo is out of range
    (the plain version raises). A strip that no group names comes out
    zero. `plan`: the chunk table of `meta` from plan_probe_reduce;
    built here (one transfer to the host) when None. Plain version for
    CPU tensors, else one launch of the probe_reduce kernel, which loads
    16 bytes at a time and so wants g, v, hi and lo 16-byte aligned."""
    if _all_on_cpu(meta, g, v, hi, lo):
        return probe_reduce_plain(meta, g, v, hi, lo, n_strips, hr)
    device = g.device
    ngroups = int(meta.shape[0])
    rows = ngroups * GROUP_ROWS
    _check("meta", meta, torch.int32, (ngroups, 2), device)
    for name, t, dtype in (("g", g, torch.float32), ("v", v, torch.float32),
                           ("hi", hi, torch.int32), ("lo", lo, torch.int32)):
        _check(name, t, dtype, (rows, 128), device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if plan is None:
        plan = plan_probe_reduce(meta, n_strips)
    if plan.ngroups != ngroups or plan.n_strips != n_strips:
        raise ValueError("the plan was built for another table")
    if plan.chunks.device != device:
        raise ValueError(f"the plan is on {plan.chunks.device}")
    y = torch.empty(n_strips, hr, 128, dtype=torch.float32, device=device)
    scratch = torch.empty(
        max(plan.nchunks, 1), hr, 128, dtype=torch.float32, device=device
    )
    fn = kernels_build.kernel_function("probe_reduce")
    err = fn(
        plan.chunks.data_ptr(), g.data_ptr(), v.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), scratch.data_ptr(), plan.tickets.data_ptr(),
        y.data_ptr(), plan.nchunks, int(hr), plan.warps,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"probe_reduce launch failed: CUDA error {err}")
    LAUNCHES["probe_reduce"] += 1
    return y


# ---------------------------------------------------------------------------
# What each call must move, and the library calls beside the kernels
# ---------------------------------------------------------------------------


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def expand_bytes(strip_ids, x_strips, hi, lo) -> int:
    """Each input read once and g written once."""
    return _nbytes(strip_ids, x_strips, hi, lo) + 4 * hi.numel()


def reduce_bytes(meta, g, v, hi, lo, n_strips: int, hr: int = HR) -> int:
    """Each input read once and the output written once."""
    return _nbytes(meta, g, v, hi, lo) + 4 * n_strips * hr * 128


def bound_ms(nbytes: int, flops: int):
    """(least ms on an H100 SXM, "bytes" or "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def library_expand(strip_ids, x_strips, hi, lo) -> torch.Tensor:
    """The one indexing call that computes probe_expand; a yardstick the
    port never calls on its own paths. hi and lo are int64 here."""
    return x_strips[_row_strips(strip_ids), hi, lo]


def library_reduce(slots, g, v, n_strips: int, hr: int = HR):
    """The one index_add_ that computes probe_reduce, given the entries'
    flat_slots (flattened); a yardstick."""
    y = torch.zeros(n_strips * hr * 128, dtype=g.dtype, device=g.device)
    return y.index_add_(0, slots, (g * v).reshape(-1))


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 10) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def _profile_window(fn, calls: int):
    """(device us of the device records kept, device records kept,
    launches) of `calls` calls under torch.profiler. Launches are the
    host's launch and async copy calls, each of which puts one record
    on the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key in LAUNCH_CALLS)
    return (sum(e.self_device_time_total for e in device),
            sum(e.count for e in device), launches)


def _device_profile(fn, calls: int = 50):
    """(device ms, kernels launched, device records kept) per call."""
    fn()
    torch.cuda.synchronize()
    total_us, kept, launches = _profile_window(fn, calls)
    # more records than launches: a launch through a call not listed
    kernels = max(launches, kept)
    # the kernels the profiler lost, at the mean time of those it kept
    scale = kernels / kept if kept else 0.0
    return total_us * scale / 1e3 / calls, kernels / calls, kept / calls


def device_profile(fn, calls: int = 50):
    """(device ms, kernels launched) per call: every kernel under
    torch.profiler over `calls` calls, the library's and PyTorch's own
    included. The kernels are counted at their launches on the host (or
    as the device records kept, where those are more). In a process that
    has run for a minute or more the profiler keeps fewer device records
    than there were kernels, a share that grows with the process's age
    (PERF.md), so the device time of the records kept is scaled by
    kernels over kept, which is exact for a call of one kernel."""
    return _device_profile(fn, calls)[:2]


def in_turns(calls: Dict[str, object]) -> Dict[str, dict]:
    """Times every call of `calls` (name -> function) in TURNS turns:
    the names in order, then in reverse, and so on. Per name: "ms"
    (time_ms), "device_ms" and "kernels_per_call" (device_profile), and
    "kept_per_call" (the device records the profiler kept a call), one
    value a turn."""
    out = {key: {"ms": [], "device_ms": [], "kernels_per_call": [],
                 "kept_per_call": []}
           for key in calls}
    for r in range(TURNS):
        for key in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            out[key]["ms"].append(time_ms(calls[key]))
            device, launched, kept = _device_profile(calls[key])
            out[key]["device_ms"].append(device)
            out[key]["kernels_per_call"].append(launched)
            out[key]["kept_per_call"].append(kept)
    return out


def turn_summary(got: dict) -> dict:
    """One name of in_turns' result in numbers: "ms" and "device_ms",
    the medians over the turns; "kernels_per_call", the largest over the
    turns; and each turn's device ms, kernels launched and device
    records kept a call."""
    return {"ms": float(statistics.median(got["ms"])),
            "device_ms": float(statistics.median(got["device_ms"])),
            "device_ms_turns": list(got["device_ms"]),
            "kernels_per_call": max(got["kernels_per_call"]),
            "kernels_per_call_turns": list(got["kernels_per_call"]),
            "kept_per_call_turns": list(got["kept_per_call"])}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "nvidia-smi unavailable"


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------


def _timing_line(row, prefix=""):
    turns = ", ".join(f"{t:.5f}" for t in row[prefix + "device_ms_turns"])
    device = row[prefix + "device_ms"]
    device = "none complete" if device is None else f"{device:.4f} ms"
    counts = ", ".join(f"{k:g}"
                       for k in row[prefix + "kernels_per_call_turns"])
    return (f"{row[prefix + 'ms']:.4f} ms, device {device} ({turns}), "
            f"kernels a call ({counts})")


def run_probe(nnz: int = DEFAULT_NNZ, device=None) -> dict:
    """Runs the probe (seed 0) on `device` (CUDA when None; raises
    without a GPU) and returns what it printed as a dict."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe times kernels on a CUDA device")
    card = card_line()
    host = make_probe_inputs(nnz, seed=0, with_f64=True)
    nnz = host["hi"].size
    ngroups = nnz // GROUP_ENTRIES
    dev = {k: torch.as_tensor(a, device=device) for k, a in host.items()}
    print(f"card: {card}; torch {torch.__version__}")
    print(f"nnz={nnz} groups={ngroups} strips={N_STRIPS} H={H}")
    result = {"card": card, "nnz": nnz, "groups": ngroups,
              "strips": N_STRIPS}

    def line(text):
        print(f"[{card}] {text}")

    def record(name, calls, extra):
        """Times the kernel and the library call in turns."""
        timed = in_turns(calls)
        row = dict(extra)
        for who, got in timed.items():
            prefix = "" if who == "kernel" else f"{who}_"
            row.update({prefix + k: v for k, v in turn_summary(got).items()})
        result[name] = row
        line(f"{name}: {_timing_line(row)} (bound "
             f"{extra['bound_ms']:.4f} ms by {extra['bound_by']}; library "
             f"{_timing_line(row, 'library_')}; "
             f"{nnz / row['ms'] / 1e6:.2f} Gentry/s)")

    # expand
    args = (dev["strip_ids"], dev["x_strips"], dev["hi"], dev["lo"])
    g = probe_expand(*args)
    torch.cuda.synchronize()
    sid = np.repeat(host["strip_ids"], GROUP_ROWS)
    want = host["x_strips"][sid[:, None], host["hi"], host["lo"]]
    err = float(np.max(np.abs(g.cpu().numpy() - want), initial=0.0))
    hi64, lo64 = dev["hi"].long(), dev["lo"].long()
    calls = {"kernel": lambda: probe_expand(*args),
             "library": lambda: library_expand(
                 dev["strip_ids"], dev["x_strips"], hi64, lo64)}
    bound, by = bound_ms(expand_bytes(*args), 0)
    record("expand", calls,
           {"bound_ms": bound, "bound_by": by, "max_abs_err": err})
    line(f"expand max abs err vs numpy: {err:.2e}")

    # chunk gather: the rows of 128 entries in a permuted order
    src = dev["src"].long()
    ms = time_ms(lambda: torch.index_select(dev["g2"], 0, src))
    line(f"chunk gather: {ms:.4f} ms ({src.numel()} idx)")
    result["chunk_gather_ms"] = ms

    # reduce
    g2 = dev["g2"].reshape(ngroups * GROUP_ROWS, 128)
    rargs = (dev["meta"], g2, dev["v"], dev["hir"], dev["lor"])
    plan = plan_probe_reduce(dev["meta"], N_STRIPS)
    want_y = np.zeros((N_STRIPS, HR, 128), np.float32)
    rows = np.repeat(host["meta"][:, 0], GROUP_ROWS)
    np.add.at(want_y, (rows[:, None], host["hir"], host["lor"]),
              host["g2"].reshape(-1, 128) * host["v"])

    def rel_err(y):
        return float(np.max(np.abs(y.cpu().numpy() - want_y), initial=0.0)
                     / (np.max(np.abs(want_y), initial=0.0) + 1))

    err = rel_err(probe_reduce(*rargs, N_STRIPS, plan=plan))
    flat = flat_slots(dev["meta"][:, 0], dev["hir"], dev["lor"],
                      HR).reshape(-1)
    calls = {"kernel": lambda: probe_reduce(*rargs, N_STRIPS, plan=plan),
             "library": lambda: library_reduce(flat, g2, dev["v"],
                                               N_STRIPS)}
    bound, by = bound_ms(reduce_bytes(*rargs, N_STRIPS), 2 * nnz)
    extra = {"bound_ms": bound, "bound_by": by, "max_rel_err": err,
             "chunks": plan.nchunks, "warps": plan.warps,
             "bytes_beyond_inputs": reduce_scratch_bytes(plan)}
    record("reduce", calls, extra)
    line(f"reduce max rel err vs numpy: {err:.2e}; {plan.nchunks} chunks "
         f"of {plan.warps} warps, {extra['bytes_beyond_inputs']} bytes "
         "beyond the inputs")
    # f64 sanity
    a64, x64, big64 = dev["a64"], dev["x64"], dev["big64"]
    ms = time_ms(lambda: a64 @ x64, 10)
    line(f"f64 dense matvec 2048^2: {ms:.4f} ms")
    result["f64_matvec_ms"] = ms
    ms = time_ms(lambda: torch.sum(big64 * 1.000001 + 0.5), 10)
    line(f"f64 elementwise 1M: {ms:.4f} ms")
    result["f64_elementwise_ms"] = ms
    return result


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    nnz = int(argv[0]) if argv else DEFAULT_NNZ
    return run_probe(nnz)


if __name__ == "__main__":
    main()
