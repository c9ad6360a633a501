"""Microbenchmarks of the two halves of a routed sparse product: the
expand (a gather from strips of the input) and the reduce (a scatter-add
into strips of the output), the port's counterpart of the JAX package's
``benchmarking/probe_routed.py``.

    python3 -m firstorderlp_torch.ops.probe_routed [nnz]

prints, for each of the two kernels, its time on the card (CUDA events,
median of 100 launches), the bound from the bytes it must move, the time
of the one PyTorch call that computes the same, entries per second and
the largest error against numpy; then a chunk gather
(``torch.index_select`` of 128-wide rows, which the JAX package leaves
to XLA outside any kernel) and two f64 sanity lines. Every line follows
the card's name and power limit as ``nvidia-smi`` gives them.

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

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores

# Blocks of probe_expand, and chunks of probe_reduce (one warp each),
# aimed at: a few for each of the card's 132 SMs.
EXPAND_TARGET_BLOCKS = 2 * 132
REDUCE_TARGET_CHUNKS = 8 * 132

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
    """How probe_reduce cuts the groups into blocks: chunk c holds the
    groups chunk_ptr[c]..chunk_ptr[c+1], all of one strip, and strip s
    owns the chunks strip_chunk_ptr[s]..strip_chunk_ptr[s+1]."""

    chunk_ptr: torch.Tensor  # (nchunks + 1,) int32
    strip_chunk_ptr: torch.Tensor  # (n_strips + 1,) int32
    ngroups: int
    n_strips: int

    @property
    def nchunks(self) -> int:
        return int(self.chunk_ptr.shape[0]) - 1


def plan_probe_reduce(meta: torch.Tensor, n_strips: int,
                      target_chunks: int = REDUCE_TARGET_CHUNKS
                      ) -> ProbeReducePlan:
    """Host-side build of the chunk table from `meta` (one transfer to
    the host; build it once for a table that is used again). Each strip's
    run of groups is cut into chunks of ceil(ngroups / target_chunks)
    groups. Raises ValueError unless the strips are sorted and in range
    and meta[:, 1] marks exactly the first group of every strip."""
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
    per_chunk = max(1, -(-ngroups // max(int(target_chunks), 1)))
    run_start = np.flatnonzero(first)
    run_len = np.diff(np.append(run_start, ngroups))
    pieces = -(-run_len // per_chunk)
    within = np.arange(int(pieces.sum())) - np.repeat(
        np.cumsum(pieces) - pieces, pieces
    )
    chunk_start = np.repeat(run_start, pieces) + per_chunk * within
    chunk_strip = np.repeat(strips[run_start], pieces)
    strip_chunk_ptr = np.searchsorted(chunk_strip, np.arange(n_strips + 1))

    def i32(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=meta.device
        )

    return ProbeReducePlan(
        chunk_ptr=i32(np.append(chunk_start, ngroups)),
        strip_chunk_ptr=i32(strip_chunk_ptr),
        ngroups=ngroups,
        n_strips=int(n_strips),
    )


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
    zero. `plan`: the
    chunk table of `meta` from plan_probe_reduce; built here (one
    transfer to the host) when None. Plain version for CPU tensors, else
    the probe_reduce kernel."""
    if _all_on_cpu(meta, g, v, hi, lo):
        return probe_reduce_plain(meta, g, v, hi, lo, n_strips, hr)
    device = g.device
    ngroups = int(meta.shape[0])
    rows = ngroups * GROUP_ROWS
    _check("meta", meta, torch.int32, (ngroups, 2), device)
    for name, t, dtype in (("g", g, torch.float32), ("v", v, torch.float32),
                           ("hi", hi, torch.int32), ("lo", lo, torch.int32)):
        _check(name, t, dtype, (rows, 128), device)
    if plan is None:
        plan = plan_probe_reduce(meta, n_strips)
    if plan.ngroups != ngroups or plan.n_strips != n_strips:
        raise ValueError("the plan was built for another table")
    if plan.chunk_ptr.device != device:
        raise ValueError(f"the plan is on {plan.chunk_ptr.device}")
    y = torch.empty(n_strips, hr, 128, dtype=torch.float32, device=device)
    parts = torch.empty(
        max(plan.nchunks, 1), hr, 128, dtype=torch.float32, device=device
    )
    fn = kernels_build.kernel_function("probe_reduce")
    err = fn(
        plan.chunk_ptr.data_ptr(), plan.strip_chunk_ptr.data_ptr(),
        g.data_ptr(), v.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        parts.data_ptr(), y.data_ptr(), plan.nchunks, int(n_strips),
        int(hr), torch.cuda.current_stream(device).cuda_stream,
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

    # expand
    args = (dev["strip_ids"], dev["x_strips"], dev["hi"], dev["lo"])
    g = probe_expand(*args)
    torch.cuda.synchronize()
    sid = np.repeat(host["strip_ids"], GROUP_ROWS)
    want = host["x_strips"][sid[:, None], host["hi"], host["lo"]]
    err = float(np.max(np.abs(g.cpu().numpy() - want), initial=0.0))
    hi64, lo64 = dev["hi"].long(), dev["lo"].long()
    ms = time_ms(lambda: probe_expand(*args))
    lib = time_ms(
        lambda: library_expand(dev["strip_ids"], dev["x_strips"], hi64, lo64)
    )
    bound, by = bound_ms(expand_bytes(*args), 0)
    line(f"expand: {ms:.4f} ms (bound {bound:.4f} ms by {by}, library "
         f"{lib:.4f} ms, {nnz / ms / 1e6:.2f} Gentry/s)")
    line(f"expand max abs err vs numpy: {err:.2e}")
    result["expand"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib, "max_abs_err": err}

    # chunk gather: the rows of 128 entries in a permuted order
    src = dev["src"].long()
    ms = time_ms(lambda: torch.index_select(dev["g2"], 0, src))
    line(f"chunk gather: {ms:.4f} ms ({src.numel()} idx)")
    result["chunk_gather_ms"] = ms

    # reduce
    g2 = dev["g2"].reshape(ngroups * GROUP_ROWS, 128)
    rargs = (dev["meta"], g2, dev["v"], dev["hir"], dev["lor"])
    plan = plan_probe_reduce(dev["meta"], N_STRIPS)
    y = probe_reduce(*rargs, N_STRIPS, plan=plan)
    torch.cuda.synchronize()
    want_y = np.zeros((N_STRIPS, HR, 128), np.float32)
    rows = np.repeat(host["meta"][:, 0], GROUP_ROWS)
    np.add.at(want_y, (rows[:, None], host["hir"], host["lor"]),
              host["g2"].reshape(-1, 128) * host["v"])
    err = float(np.max(np.abs(y.cpu().numpy() - want_y), initial=0.0)
                / (np.max(np.abs(want_y), initial=0.0) + 1))
    flat = flat_slots(dev["meta"][:, 0], dev["hir"], dev["lor"],
                      HR).reshape(-1)
    ms = time_ms(lambda: probe_reduce(*rargs, N_STRIPS, plan=plan))
    lib = time_ms(lambda: library_reduce(flat, g2, dev["v"], N_STRIPS))
    bound, by = bound_ms(reduce_bytes(*rargs, N_STRIPS), 2 * nnz)
    line(f"reduce: {ms:.4f} ms (bound {bound:.4f} ms by {by}, library "
         f"{lib:.4f} ms, {nnz / ms / 1e6:.2f} Gentry/s, "
         f"{plan.nchunks} chunks)")
    line(f"reduce max rel err vs numpy: {err:.2e}")
    result["reduce"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib, "max_rel_err": err,
                        "chunks": plan.nchunks}

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
