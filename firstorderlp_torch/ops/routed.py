"""The kernel operator: A x, A' y and the fused PDLP step kernels, the
port's counterpart of the JAX package's ``ops/routed.py``.

The JAX package's routed operator selects x entries with one-hot matrix
products over tile plans, because gathers on the TPU are bound by index
rate. Hopper gathers natively, so the port keeps the contract of each
Pallas kernel and not its arithmetic. Like the JAX package it has two
layouts, and ``DEFAULT_TILE_ALIGNED`` (environment variable
``FOLP_TILE_ALIGNED=1``) picks the second:

- CSR (the default): A and A' are each stored as CSR (int32 indptr and
  indices, f32 values) and cut into work items of about equal work
  (``csr_work_items``: runs of short rows, or a long row or a piece of
  one); one launch per product, one block per item, the epilogue once
  per output row on complete sums. Three CUDA kernels cover the
  composed Pallas kernels:
  ``spmv_csr`` (B1 expand + chunk gather + B2 reduce),
  ``spmv_dual_step`` (B1 + B3 reduce-dual) and ``spmv_rmv_stats``
  (B1 + B4 reduce-rmv-stats).
- Tile plan (``tile_aligned=True``): the matrix is cut into tiles of
  `out_strip` output rows by `in_window` input columns and each output
  strip's entries into work items of about equal size; one launch per
  product, one block per item, the strip's sums in shared memory, x
  gathered straight from device memory, the epilogue once per output
  row on complete sums. Three CUDA kernels replace the fused Pallas
  kernels: ``tiled_spmv`` (B5 fused),
  ``tiled_dual_step`` (B6 fused-dual) and ``tiled_rmv_stats`` (B7
  fused-rmv-stats).

No kernel uses floating-point atomics and every sum has one fixed
order, so two runs give the same bits. Each wrapper
takes the plain PyTorch version beside it only when the matrix and the
vectors are on the CPU; for a CUDA tensor it launches its kernel or
raises. Each launch adds one to the wrapper's entry in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels_build
from .device import resolve_device

# Default layout for build_routed_op(tile_aligned=None), read when the
# operator is built: the tile plan when FOLP_TILE_ALIGNED=1 was set at
# import (the JAX package's switch), else CSR.
DEFAULT_TILE_ALIGNED = os.environ.get("FOLP_TILE_ALIGNED", "0") == "1"

# Work items of the CSR kernels (csrc/csr_spmv.cuh), chosen for the H100
# (132 SMs, 2,048 threads an SM: eight blocks of 256).
# - A row is short when its group of TPR lanes (TPR from the mean row
#   length) walks it in at most LONG_ROW_TRIPS trips. Short rows are
#   packed in row order into runs of about `item_entries` units of work
#   (a stored entry is one unit and a row one more: its pointer and its
#   epilogue), at most MAX_ITEM_ROWS rows (the kernel stages their
#   pointers in shared memory).
# - A long row is walked by a whole block, alone; a row longer than
#   `item_entries` is cut into pieces of equal shares, one block each,
#   so the PageRank LP's dense equality row is many blocks, not one.
# - ITEM_ENTRIES units an item: the card's sweeps of 256-8,192 put 2,048
#   first or within 5% of the first at the 100k-node PageRank LP (900k
#   units, 544 items for A: four blocks an SM) and at a million nodes
#   (4,884 items); larger items leave too few blocks at 100k nodes and
#   are no faster at a million (PERF.md). No smaller LP was measured.
# One block per item; no item holds more than ITEM_ENTRIES plus one
# short row's entries.
# B2 (csrc/spmv_csr.cu) has its own table of the same size
# (csr_stage_items): every row of a run counts its entries plus one (its
# store), an empty row one; one thread sums each row of a run, so a row
# longer than STAGE_LONG_ROW entries is long (a whole block's): 256 was
# faster than 64 at every shape the card measured (PERF.md).
ITEM_BLOCK_THREADS = 256  # kBlockThreads, kStageThreads
LONG_ROW_TRIPS = 16
MAX_ITEM_ROWS = 1024  # kMaxItemRows
ITEM_ENTRIES = 2048
STAGE_LONG_ROW = 256
STAGE_GATHER = 8  # kGather: B2's loads a thread has in flight

# Launch counts per kernel wrapper (A x and A' y counted apart).
LAUNCHES: Dict[str, int] = {
    "spmv_csr:A": 0,
    "spmv_csr:AT": 0,
    # a heterogeneous QP fleet's objective matrix (ops/block_lanes.py)
    "spmv_csr:Q": 0,
    "spmv_csr:QT": 0,
    "spmv_dual_step": 0,
    "spmv_rmv_stats": 0,
    "tiled_spmv:A": 0,
    "tiled_spmv:AT": 0,
    "tiled_dual_step": 0,
    "tiled_rmv_stats": 0,
    # PDLP's step trial around B3/B4 or B6/B7 (ops/pdhg_step.py)
    "primal_step": 0,
    "trial_epilogue": 0,
    # the f32 exact trust region (ops/trust_region_search.py): F2b on a
    # cluster a row (tr_search) or on the whole card (tr_knots, then the
    # trips, tr_trip), F2c
    "tr_search": 0,
    "tr_knots": 0,
    "tr_trip": 0,
    "tr_solution": 0,
    # an evaluation's statistics (ops/eval_stats.py)
    "stats_point": 0,
    "stats_primal": 0,
    "stats_dual": 0,
}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


class _StageArgs(ctypes.Structure):
    """csrc/spmv_csr.cu's StageArgs: B2's constant kernel arguments,
    passed by address."""

    _fields_ = [
        ("indptr", ctypes.c_void_p),
        ("indices", ctypes.c_void_p),
        ("vals", ctypes.c_void_p),
        ("items", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("tickets", ctypes.c_void_p),
        ("nitems", ctypes.c_int),
        ("stage", ctypes.c_int),
        ("rows", ctypes.c_int),
    ]


class _CsrArgs(ctypes.Structure):
    """csrc/csr_spmv.cuh's CsrArgs: a matrix's constant kernel
    arguments, passed by address."""

    _fields_ = [
        ("indptr", ctypes.c_void_p),
        ("indices", ctypes.c_void_p),
        ("vals", ctypes.c_void_p),
        ("items", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("tickets", ctypes.c_void_p),
        ("nitems", ctypes.c_int),
        ("tpr", ctypes.c_int),
    ]


@dataclasses.dataclass(frozen=True)
class CsrKernelMatrix:
    """One orientation of the matrix, as the kernels take it: the CSR
    arrays, the work items of B3 and B4 (csr_work_items) and of B2
    (csr_stage_items, the `stage_*` fields), each table with the
    kernels' own `scratch` (piece sums and per-item partial sums) and
    `tickets` (integer counters, zero between launches). Matrices built
    with the same index tensors share items, scratch and tickets, so
    they launch on one stream."""

    indptr: torch.Tensor  # (rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) f32
    num_rows: int
    num_cols: int
    label: str  # "A" or "AT" ("Q", "QT": an objective matrix)
    tpr: int  # lanes per row in a run of short rows
    item_entries: int  # the item size the items were cut to
    # (nitems + 1, 4) int32 [first entry, first row, index of the piece
    # in its row, pieces of its row (0: a run of short rows)]; the last
    # row holds [nnz, rows, 0, 0]
    items: torch.Tensor
    scratch: torch.Tensor  # (3 max(nitems, 1),) f32
    tickets: torch.Tensor  # (nitems + 1,) int32
    # B2's table (csr_stage_items), in the same format
    stage_items: torch.Tensor
    stage_scratch: torch.Tensor  # (max(nstage, 1),) f32
    stage_tickets: torch.Tensor  # (max(nstage, 1),) int32
    stage_entries: int  # entry slots of a block's stage (stage_slots)
    stage_rows: int  # row-pointer slots

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nitems(self) -> int:
        return int(self.items.shape[0]) - 1

    @property
    def nstage(self) -> int:
        """B2's items (blocks a launch)."""
        return int(self.stage_items.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @functools.cached_property
    def kernel_args(self) -> _CsrArgs:
        """The constant arguments of every launch on this matrix, built
        at its first launch."""
        return _CsrArgs(
            self.indptr.data_ptr(), self.indices.data_ptr(),
            self.vals.data_ptr(), self.items.data_ptr(),
            self.scratch.data_ptr(), self.tickets.data_ptr(),
            self.nitems, self.tpr,
        )

    @functools.cached_property
    def kernel_args_address(self) -> int:
        return ctypes.addressof(self.kernel_args)

    @functools.cached_property
    def stage_args(self) -> _StageArgs:
        """B2's constant arguments, built at its first launch."""
        return _StageArgs(
            self.indptr.data_ptr(), self.indices.data_ptr(),
            self.vals.data_ptr(), self.stage_items.data_ptr(),
            self.stage_scratch.data_ptr(), self.stage_tickets.data_ptr(),
            self.nstage, self.stage_entries, self.stage_rows,
        )

    @functools.cached_property
    def stage_args_address(self) -> int:
        return ctypes.addressof(self.stage_args)


def _threads_per_row(rows: int, nnz: int) -> int:
    """Lanes per short row: the power of two nearest the mean row length
    (in log scale), in [2, 32]: 8 at the PageRank LPs' mean of 8-9
    entries, where 16 lanes left half the lanes idle."""
    mean = max(nnz / max(rows, 1), 1.0)
    return int(min(max(1 << int(np.round(np.log2(mean))), 2), 32))


def csr_work_items(indptr: np.ndarray, tpr: int, item_entries: int,
                   split_rows: bool = True) -> np.ndarray:
    """The item table of B3 and B4 (csr_spmv.cuh) for a CSR matrix with
    row pointers `indptr`, in row order: (nitems + 1, 4) int64 rows
    [first entry, first row, index of the piece in its row, pieces of
    its row], and a last row [nnz, rows, 0, 0]. A row longer than
    LONG_ROW_TRIPS * tpr entries is long: its own item (pieces 1), or,
    longer than `item_entries` and with `split_rows`, ceil(len /
    item_entries) pieces of floor or ceil of equal shares. The short
    rows between long rows are cut into runs (pieces 0) at the rows
    where the run's work before the row (entries plus rows, a row at
    least item_entries / MAX_ITEM_ROWS) passes a multiple of
    `item_entries`: at most MAX_ITEM_ROWS rows and item_entries plus one
    row's entries."""
    indptr = np.asarray(indptr, dtype=np.int64)
    long = np.diff(indptr) > LONG_ROW_TRIPS * int(tpr)
    return _item_table(indptr, long, item_entries, split_rows,
                       least=-(-int(item_entries) // MAX_ITEM_ROWS))


def csr_stage_items(indptr: np.ndarray, item_entries: int,
                    split_rows: bool = True) -> np.ndarray:
    """B2's item table (csrc/spmv_csr.cu), in csr_work_items' format: a
    row longer than STAGE_LONG_ROW entries is long (its own item, or
    pieces of at most `item_entries`); the rows between long rows are
    cut into runs where the run's work before the row passes a multiple
    of `item_entries`, a row counting its entries plus one (its store;
    an empty row costs that one only). So a run holds at most
    item_entries plus one row's entries and at most item_entries + 1
    rows; the kernel stages all of them (stage_slots)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    long = np.diff(indptr) > STAGE_LONG_ROW
    return _item_table(indptr, long, item_entries, split_rows, least=1)


def _item_table(indptr: np.ndarray, long: np.ndarray, item_entries: int,
                split_rows: bool, least: int) -> np.ndarray:
    """The item table of the rows `long` marks long and the short runs
    between them, each row of a run counting max(len + 1, least) units
    (csr_work_items, csr_stage_items)."""
    if item_entries < 1:
        raise ValueError("item_entries must be positive")
    row_len = np.diff(indptr)
    rows = len(row_len)

    # runs of short rows: a new run where a row follows a long row, or
    # where the run's work before it passes a multiple of item_entries
    short = np.flatnonzero(~long)
    starts = np.ones(len(short), dtype=bool)
    starts[1:] = short[1:] != short[:-1] + 1
    seg_first = np.flatnonzero(starts)[np.cumsum(starts) - 1]
    work_before = _exclusive_cumsum(np.maximum(row_len[short] + 1, least))
    key = (work_before - work_before[seg_first]) // int(item_entries)
    cut = starts.copy()
    cut[1:] |= key[1:] != key[:-1]
    run_rows = short[cut]

    longs = np.flatnonzero(long)
    pieces = (np.maximum(-(-row_len[longs] // int(item_entries)), 1)
              if split_rows else np.ones(len(longs), dtype=np.int64))
    piece_row = np.repeat(longs, pieces)
    count = np.repeat(pieces, pieces)
    index = np.arange(int(pieces.sum())) - np.repeat(
        _exclusive_cumsum(pieces), pieces
    )
    first = indptr[piece_row] + (index * row_len[piece_row]) // count

    zeros = np.zeros(len(run_rows), dtype=np.int64)
    table = np.stack([
        np.concatenate([indptr[run_rows], first]),
        np.concatenate([run_rows, piece_row]),
        np.concatenate([zeros, index]),
        np.concatenate([zeros, count]),
    ], axis=1)
    order = np.lexsort((table[:, 2], table[:, 1]))
    items = np.zeros((len(order) + 1, 4), dtype=np.int64)
    items[:-1] = table[order]
    items[-1] = [indptr[-1], rows, 0, 0]
    return items


def stage_slots(items: np.ndarray) -> Tuple[int, int]:
    """(entry slots, row-pointer slots) of B2's shared memory for the
    item table `items`: room for the largest run's entries plus the up
    to three slots its first entry sits into its 16-byte word, and for
    the largest run's row pointers; each a multiple of 4. Long rows and
    their pieces are not staged."""
    items = np.asarray(items, dtype=np.int64)
    runs = items[:-1, 3] == 0
    sizes = np.diff(items[:, 0])[runs]
    nrows = np.diff(items[:, 1])[runs]
    entries = int(sizes.max()) if len(sizes) else 0
    rows = int(nrows.max()) if len(nrows) else 0
    return 4 * ((entries + 3 + 3) // 4), 4 * ((rows + 1 + 3) // 4)


def stage_copies(e0: int, e1: int, word: int) -> Dict[str, Tuple[int, int]]:
    """How B2 stages entries [e0, e1) of one array whose entry 0 sits at
    4-byte slot `word` (0-3) of its 16-byte word (csrc/spmv_csr.cu,
    stage_array): the 16-byte-aligned `middle` by one bulk copy, the
    `head` before it and the `tail` after it (fewer than four entries
    each) by plain loads, as [start, stop) entry ranges (empty: start ==
    stop); `lo`, the slot of entry e0, so entry e goes to slot e - e0 +
    lo."""
    lo = (word + e0) & 3
    a0 = e0 + ((4 - lo) & 3)
    a1 = e1 - ((word + e1) & 3)
    head_end = min(a0, e1)
    tail_start = max(a1, head_end)
    middle = (a0, a1) if a1 > a0 else (head_end, head_end)
    return {"head": (e0, head_end), "middle": middle,
            "tail": (tail_start, e1), "lo": (lo, lo)}


def _f32_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(
        np.ascontiguousarray(a, dtype=np.float32), device=device
    )


def _i32_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(
        np.ascontiguousarray(a, dtype=np.int32), device=device
    )


def _item_tensors(indptr: np.ndarray, tpr: int, item_entries: int,
                  split_rows: bool, device) -> Dict[str, torch.Tensor]:
    """Both item tables of a matrix with row pointers `indptr`, with
    their scratch and tickets (CsrKernelMatrix's fields)."""
    items = csr_work_items(indptr, tpr, item_entries, split_rows)
    nitems = len(items) - 1
    stage = csr_stage_items(indptr, item_entries, split_rows)
    nstage = max(len(stage) - 1, 1)
    entries, rows = stage_slots(stage)
    return {
        "items": _i32_tensor(items, device),
        "scratch": torch.empty(3 * max(nitems, 1), dtype=torch.float32,
                               device=device),
        "tickets": torch.zeros(nitems + 1, dtype=torch.int32, device=device),
        "stage_items": _i32_tensor(stage, device),
        "stage_scratch": torch.empty(nstage, dtype=torch.float32,
                                     device=device),
        "stage_tickets": torch.zeros(nstage, dtype=torch.int32,
                                     device=device),
        "stage_entries": entries,
        "stage_rows": rows,
    }


def build_csr_kernel_matrix(
    csr: sp.csr_matrix, device, label: str,
    index_from: "Optional[CsrKernelMatrix]" = None,
) -> CsrKernelMatrix:
    """Host-side build of one orientation (vectorized numpy), its items
    cut to ITEM_ENTRIES units.

    index_from: the same orientation of a matrix with the same sparsity
    pattern; its index tensors, items, scratch and tickets are reused on
    the device and only the values are transferred."""
    rows, cols = csr.shape
    # B2's int32 walk of a long row steps up to STAGE_GATHER times
    # ITEM_BLOCK_THREADS past its end
    if csr.nnz >= 2**31 - STAGE_GATHER * ITEM_BLOCK_THREADS:
        raise ValueError("int32 CSR indices cannot hold this matrix")
    if index_from is not None:
        return dataclasses.replace(
            index_from, vals=_f32_tensor(csr.data, index_from.device)
        )
    tpr = _threads_per_row(rows, csr.nnz)
    return CsrKernelMatrix(
        indptr=_i32_tensor(csr.indptr, device),
        indices=_i32_tensor(csr.indices, device),
        vals=_f32_tensor(csr.data, device),
        num_rows=rows,
        num_cols=cols,
        label=label,
        tpr=tpr,
        item_entries=ITEM_ENTRIES,
        **_item_tensors(csr.indptr, tpr, ITEM_ENTRIES, True, device),
    )


def csr_with_items(mat: CsrKernelMatrix, item_entries: Optional[int] = None,
                   split_rows: bool = True,
                   tpr: Optional[int] = None) -> CsrKernelMatrix:
    """`mat` with items of another size or another group width (B3 and
    B4's only), or with no row cut into pieces (split_rows=False: a long
    row is one block however long), in both tables; new scratch and
    tickets. A timing and testing yardstick."""
    item_entries = int(item_entries or mat.item_entries)
    tpr = int(tpr or mat.tpr)
    return dataclasses.replace(
        mat, item_entries=item_entries, tpr=tpr,
        **_item_tensors(mat.indptr.cpu().numpy(), tpr, item_entries,
                        split_rows, mat.device),
    )


def csr_item_stats(mat: CsrKernelMatrix) -> Dict[str, float]:
    """What a launch over `mat` looks like: blocks (one per item), stored
    entries of the largest and of the mean block, rows walked by a whole
    block and rows cut into pieces."""
    items = mat.items.cpu().numpy().astype(np.int64)
    sizes = np.diff(items[:, 0])
    block = items[:-1, 3] > 0
    return {
        "blocks": mat.nitems,
        "tpr": mat.tpr,
        "item_entries": mat.item_entries,
        "entries_per_block_max": int(sizes.max()) if len(sizes) else 0,
        "entries_per_block_mean": float(sizes.mean()) if len(sizes) else 0.0,
        "max_over_mean": (float(sizes.max() / sizes.mean())
                          if len(sizes) and sizes.mean() > 0 else 0.0),
        "long_rows": int(np.sum(block & (items[:-1, 2] == 0))),
        "split_rows": int(np.sum((items[:-1, 3] > 1) & (items[:-1, 2] == 0))),
        "matrix_bytes": csr_kernel_bytes(mat),
        "item_table_bytes": int(mat.items.numel()) * 4,
    }


def stage_item_stats(mat: CsrKernelMatrix) -> Dict[str, float]:
    """What a launch of B2 over `mat` looks like: blocks (one per item of
    csr_stage_items), stored entries of the largest and of the mean
    block, the stage's slots and the dynamic shared memory a block takes
    for them, the bytes staged (each run's indices, values and row
    pointers; long rows are walked from device memory), the empty rows
    (a store of 0 each: no gather, no trip), rows walked by a whole
    block and rows cut into pieces."""
    items = mat.stage_items.cpu().numpy().astype(np.int64)
    sizes = np.diff(items[:, 0])
    runs = items[:-1, 3] == 0
    block = ~runs
    lengths = np.diff(mat.indptr.cpu().numpy().astype(np.int64))
    return {
        "design": "staged entries, a thread a row (csr_stage_items)",
        "blocks": mat.nstage,
        "item_entries": mat.item_entries,
        "entries_per_block_max": int(sizes.max()) if len(sizes) else 0,
        "entries_per_block_mean": float(sizes.mean()) if len(sizes) else 0.0,
        "stage_entries": mat.stage_entries,
        "stage_rows": mat.stage_rows,
        "smem_bytes": 4 * (2 * mat.stage_entries + mat.stage_rows),
        "bytes_staged": int(np.sum(8 * sizes[runs]
                                   + 4 * (np.diff(items[:, 1])[runs] + 1))),
        "empty_rows": int(np.sum(lengths == 0)),
        "long_rows": int(np.sum(block & (items[:-1, 2] == 0))),
        "split_rows": int(np.sum((items[:-1, 3] > 1) & (items[:-1, 2] == 0))),
        "matrix_bytes": csr_kernel_bytes(mat),
        "item_table_bytes": int(mat.stage_items.numel()) * 4,
    }


def csr_kernel_bytes(mat) -> int:
    """Bytes of the matrix a product must read, in CSR: indptr, indices
    and values, each once. A CsrKernelMatrix's item table is the
    kernels' own, not the product's (csr_item_stats counts it apart);
    a TilePlan of the same matrix is held to the same bytes, since its
    padding, group table and item table are the plan's own
    (tile_plan_stats counts them apart as plan_bytes)."""
    return 4 * (mat.num_rows + 1) + 8 * mat.nnz


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------


def spmv_csr_plain(mat: CsrKernelMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x as a gather and a segmented sum, in f32."""
    prod = mat.vals * x[mat.indices.long()]
    return torch.segment_reduce(
        prod, "sum", offsets=mat.indptr.long(), initial=0.0
    )


def spmv_dual_step_plain(mat, z, y, b, is_eq, sigma):
    """(y+, sum((y+ - y)^2)) with y+ = proj(y + sigma (b - A z))."""
    az = spmv_csr_plain(mat, z)
    cand = y + sigma * (b - az)
    y_next = torch.where(is_eq != 0, cand, torch.clamp_min(cand, 0.0))
    dy = y_next - y
    return y_next, torch.sum(dy * dy)


def spmv_rmv_stats_plain(mat, y, dx, aty_old):
    """(A' y, sum(dx (A' y - aty_old)), sum(dx^2)); `mat` holds A'."""
    aty = spmv_csr_plain(mat, y)
    return aty, torch.sum(dx * (aty - aty_old)), torch.sum(dx * dx)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(plan_or_mat, vec: torch.Tensor) -> bool:
    return vec.device.type == "cpu" and plan_or_mat.device.type == "cpu"


def _launch(lib: str, mat: CsrKernelMatrix, *args) -> None:
    """One launch of `lib` on the matrix's device and its current stream
    (whichever device is current: a mesh's blocks lie on several): the
    matrix's constant arguments by address (built once; B2's own for
    spmv_csr), then the call's own."""
    if mat.device.type != "cuda":
        raise ValueError(f"{lib}: the matrix is not on a CUDA device")
    fn = kernels_build.kernel_function(lib)
    address = (mat.stage_args_address if lib == "spmv_csr"
               else mat.kernel_args_address)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = fn(address, *args, stream)
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")


def spmv_csr(mat: CsrKernelMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x (f32). Plain version for CPU tensors, else the
    spmv_csr kernel."""
    if _on_cpu(mat, x):
        return spmv_csr_plain(mat, x)
    _check("x", x, (mat.num_cols,), mat.device)
    y = torch.empty(mat.num_rows, dtype=torch.float32, device=mat.device)
    _launch("spmv_csr", mat, x.data_ptr(), y.data_ptr())
    LAUNCHES[f"spmv_csr:{mat.label}"] += 1
    return y


def spmv_csr_attributes() -> Dict[str, int]:
    """B2's kernel as the compiler gave it (cudaFuncGetAttributes):
    registers a thread and static shared memory a block; its dynamic
    shared memory is the matrix's (stage_item_stats' smem_bytes)."""
    lib = kernels_build.build_kernels()["spmv_csr"]
    regs, smem = ctypes.c_int(), ctypes.c_int()
    err = lib.folp_spmv_csr_attributes(ctypes.byref(regs),
                                       ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"spmv_csr attributes: CUDA error {err}")
    return {"registers": regs.value, "static_smem_bytes": smem.value}


def spmv_dual_step(mat, z, y, b, is_eq, sigma):
    """Fused dual step; returns (y+, sum((y+ - y)^2)). `sigma` is a
    one-element f32 tensor on the matrix's device (read by the kernel,
    so the host never waits for it). y+ and the sum share one new
    tensor; the sum is never a view of the matrix's scratch."""
    if _on_cpu(mat, z):
        return spmv_dual_step_plain(mat, z, y, b, is_eq, sigma)
    m = mat.num_rows
    _check("z", z, (mat.num_cols,), mat.device)
    for name, t in (("y", y), ("b", b), ("is_eq", is_eq)):
        _check(name, t, (m,), mat.device)
    _check("sigma", sigma.reshape(()), (), mat.device)
    out = torch.empty(m + 1, dtype=torch.float32, device=mat.device)
    ptr = out.data_ptr()
    _launch(
        "spmv_dual_step", mat, z.data_ptr(), y.data_ptr(), b.data_ptr(),
        is_eq.data_ptr(), sigma.data_ptr(), ptr, ptr + 4 * m,
    )
    LAUNCHES["spmv_dual_step"] += 1
    return out[:m], out[m]


def spmv_rmv_stats(mat, y, dx, aty_old):
    """Fused A' y+ with the step-control sums; `mat` holds A'. Returns
    (aty+, sum(dx (aty+ - aty_old)), sum(dx^2)), all three in one new
    tensor."""
    if _on_cpu(mat, y):
        return spmv_rmv_stats_plain(mat, y, dx, aty_old)
    n = mat.num_rows
    _check("y", y, (mat.num_cols,), mat.device)
    _check("dx", dx, (n,), mat.device)
    _check("aty_old", aty_old, (n,), mat.device)
    out = torch.empty(n + 2, dtype=torch.float32, device=mat.device)
    ptr = out.data_ptr()
    _launch(
        "spmv_rmv_stats", mat, y.data_ptr(), dx.data_ptr(),
        aty_old.data_ptr(), ptr, ptr + 4 * n,
    )
    LAUNCHES["spmv_rmv_stats"] += 1
    return out[:n], out[n], out[n + 1]


# ---------------------------------------------------------------------------
# Tile plan (the layout of the fused kernels)
# ---------------------------------------------------------------------------

# Strip sizes, group size and work items, chosen for the H100 (132 SMs,
# 227 KB of shared memory a block).
# - A local index has 16 bits, and the JAX package's plan allows strips
#   of at most 16,384, so a window or a strip is at most 64 KB of f32.
# - One block owns one work item: a run of groups of one output strip.
#   A strip is cut into items of at most `cap` groups, cap = ITEM_SLACK
#   times the mean number of groups per strip (per NUM_SMS-th of the
#   plan when there are fewer strips than SMs), in equal shares. A strip
#   up to a quarter over the mean is one item (with cap at the mean,
#   half the strips of an even matrix would be cut in two); the strip of
#   a dense row is many. So no item holds more than 2.25 times the mean
#   item plus two groups, whatever the matrix (work_items). A split strip's items leave partial strips in
#   `scratch`, and the one that draws the strip's last ticket adds them
#   in item order.
# - The output strip is the largest power of two that still gives
#   NUM_SMS strips (512 rows at the 100k-node PageRank LP: 196 strips),
#   at least MIN_STRIP and at most MAX_PICKED_STRIP: the fewer strips,
#   the fewer tiles and the less padding, but a warp's copy of a strip of
#   4,096 rows leaves room for 12 warps on an SM, too few to keep the
#   device memory busy (at a million nodes strips of 4,096 took twice
#   the time of strips of 1,024).
# - No block stages a window: every entry gathers its x from device
#   memory. The window only bounds the local column, so it is as wide as
#   the packing allows: fewer tiles, so less padding.
# - Every warp of a block sums into its own copy of the strip in shared
#   memory, so a block has as many warps (a power of two, at most
#   MAX_BLOCK_WARPS) as SHARED_BUDGET holds copies: 16 warps and 32 KB
#   at strips of 512 rows.
# - A group is the unit of padding and of the group table: a nonempty
#   tile wastes half a group on average. The group is the power of two
#   in [MIN_GROUP, TILE_GROUP] nearest under a quarter of the mean tile
#   (pick_group): 128 entries at the 100k-node size (583 entries a tile,
#   padding near a tenth, the table 16 bytes per 128 entries), 32 at a
#   million nodes, where a strip's entries spread over 62 windows.
NUM_SMS = 132
MAX_STRIP = 16384
MAX_PICKED_STRIP = 1024
MIN_STRIP = 32
TILE_GROUP = 128
MIN_GROUP = 32
ITEM_SLACK = 1.25
MAX_BLOCK_WARPS = 16
SHARED_BUDGET = 64 * 1024
# The kernels key a run of equal rows by 16 bits of its window number.
MAX_WINDOWS = 65536


def pick_out_strip(num_rows: int) -> int:
    """Largest power of two in [MIN_STRIP, MAX_PICKED_STRIP] that cuts
    `num_rows` into at least NUM_SMS strips (MIN_STRIP when none does)."""
    per_sm = max(num_rows // NUM_SMS, 1)
    return int(min(max(1 << (per_sm.bit_length() - 1), MIN_STRIP),
                   MAX_PICKED_STRIP))


def pick_in_window(num_cols: int) -> int:
    """Smallest power of two in [MIN_STRIP, MAX_STRIP] that holds
    `num_cols` (MAX_STRIP when none does)."""
    need = 1 << max(int(num_cols) - 1, 0).bit_length()
    return int(min(max(need, MIN_STRIP), MAX_STRIP))


def pick_group(shape, nnz: int, out_strip: int, in_window: int) -> int:
    """Largest power of two in [MIN_GROUP, TILE_GROUP] that is at most a
    quarter of the mean number of entries per tile."""
    rows, cols = shape
    tiles = -(-rows // out_strip) * -(-cols // in_window)
    quarter = max(int(nnz) // (4 * max(tiles, 1)), 1)
    return int(min(max(1 << (quarter.bit_length() - 1), MIN_GROUP),
                   TILE_GROUP))


def pick_block_warps(out_strip: int) -> int:
    """Largest power of two, at most MAX_BLOCK_WARPS, of f32 copies of a
    strip that fit SHARED_BUDGET (at least 1)."""
    copies = max(SHARED_BUDGET // (4 * int(out_strip)), 1)
    return int(min(1 << (copies.bit_length() - 1), MAX_BLOCK_WARPS))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One orientation of the matrix as a tile plan: tiles of
    `out_strip` output rows by `in_window` input columns, a tile's
    entries together and in row-major order, zero-padded to whole groups
    of `group` entries. `items` cuts every strip's run of groups into
    the kernels' work items; `scratch` and `tickets` are the kernels'
    own (partial strips of split strips; integer counters that are zero
    between launches), shared by every plan with these index tensors, so
    such plans launch on one stream."""

    loc: torch.Tensor  # (ngroups * group,) int32: local_col | local_row << 16
    vals: torch.Tensor  # (ngroups * group,) f32, 0 on padding
    meta: torch.Tensor  # (ngroups, 4) int32 [out strip, first, last, in strip]
    # the tiles, for the plan's readers; the kernels walk `items`
    tile_ptr: torch.Tensor  # (ntiles + 1,) int32 first group of each tile
    strip_tile_ptr: torch.Tensor  # (nstrips + 1,) int32 first tile of a strip
    # (nitems + 1, 4) int32 [first group, index in its strip, items of
    # its strip, scratch slot of the strip's first item]; the last row
    # holds ngroups
    items: torch.Tensor
    scratch: torch.Tensor  # (max(slots, 1), out_strip) f32
    tickets: torch.Tensor  # (nstrips + 1,) int32
    warps: int  # warps per block
    num_rows: int
    num_cols: int
    out_strip: int
    in_window: int
    group: int
    nnz: int  # stored entries that are not padding
    label: str  # "A" or "AT"

    @property
    def nstrips(self) -> int:
        return int(self.strip_tile_ptr.shape[0]) - 1

    @property
    def ngroups(self) -> int:
        return int(self.meta.shape[0])

    @property
    def nitems(self) -> int:
        return int(self.items.shape[0]) - 1

    @property
    def padding_share(self) -> float:
        return 1.0 - self.nnz / float(self.ngroups * self.group)

    @property
    def device(self) -> torch.device:
        return self.vals.device


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), dtype=np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def work_items(strip_groups: np.ndarray) -> np.ndarray:
    """The item table of a plan whose strips hold `strip_groups` groups
    (each at least 1), in plan order: (nitems + 1, 4) int64 rows [first
    group, index inside its strip, items of its strip, scratch slot of
    the strip's first item (0 for a strip of one item)], and a last row
    that holds the number of groups. A strip of g groups is cut into
    ceil(g / cap) items of floor or ceil of equal shares, cap =
    ceil(ITEM_SLACK groups / max(strips, NUM_SMS)): no item holds more
    than cap groups, and there are at most (1 + 1 / ITEM_SLACK)
    max(strips, NUM_SMS) items, so the largest item is at most
    1 + ITEM_SLACK = 2.25 times the mean item, plus two groups."""
    strip_groups = np.asarray(strip_groups, dtype=np.int64)
    nstrips = len(strip_groups)
    ngroups = int(strip_groups.sum())
    cap = int(np.ceil(ITEM_SLACK * ngroups / max(nstrips, NUM_SMS)))
    per_strip = -(-strip_groups // cap)
    nitems = int(per_strip.sum())
    strip_of = np.repeat(np.arange(nstrips, dtype=np.int64), per_strip)
    index = np.arange(nitems, dtype=np.int64) - np.repeat(
        _exclusive_cumsum(per_strip), per_strip
    )
    slots = _exclusive_cumsum(np.where(per_strip > 1, per_strip, 0))
    items = np.zeros((nitems + 1, 4), dtype=np.int64)
    items[:-1, 0] = _exclusive_cumsum(strip_groups)[strip_of] + (
        index * strip_groups[strip_of]
    ) // per_strip[strip_of]
    items[:-1, 1] = index
    items[:-1, 2] = per_strip[strip_of]
    items[:-1, 3] = slots[strip_of]
    items[-1, 0] = ngroups
    return items


def _host_tile_plan(csr: sp.csr_matrix, out_strip: int, in_window: int,
                    group: int) -> Dict[str, np.ndarray]:
    """The plan's arrays in numpy (vectorized). `csr` is in canonical
    form (sorted indices, duplicates summed)."""
    rows, cols = csr.shape
    for name, size in (("out_strip", out_strip), ("in_window", in_window)):
        if not 1 <= size <= MAX_STRIP:
            raise ValueError(
                f"{name}={size}: strips above {MAX_STRIP} do not fit the "
                "16-bit packing"
            )
    if group < 1:
        raise ValueError("group must be positive")
    nstrips = -(-rows // out_strip)
    nwin = -(-cols // in_window)
    if nwin > MAX_WINDOWS:
        raise ValueError(
            f"in_window={in_window} cuts {cols} columns into more than "
            f"{MAX_WINDOWS} windows"
        )
    coo = csr.tocoo()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    tile = (row // out_strip) * nwin + col // in_window

    # entries sorted by tile, row-major (the csr's own order) inside
    order = np.argsort(tile, kind="stable")
    tile_sorted = tile[order]
    counts = np.bincount(tile, minlength=nstrips * nwin).astype(np.int64)
    tile_groups = -(-counts // group)
    empty_strip = tile_groups.reshape(nstrips, nwin).sum(axis=1) == 0
    strip_groups = np.where(
        empty_strip, 1, tile_groups.reshape(nstrips, nwin).sum(axis=1)
    )
    strip_ptr = np.zeros(nstrips + 1, dtype=np.int64)
    np.cumsum(strip_groups, out=strip_ptr[1:])
    ngroups = int(strip_ptr[-1])
    if ngroups * group >= 2**31 - 4096:  # the kernels look a batch ahead
        raise ValueError("int32 positions cannot hold this plan")
    # first group of each tile: the groups of the tiles before it, plus
    # the all-padding groups of the empty strips before its strip
    tile_ids = np.arange(nstrips * nwin, dtype=np.int64)
    tile_start = (
        _exclusive_cumsum(tile_groups)
        + _exclusive_cumsum(empty_strip.astype(np.int64))[tile_ids // nwin]
    )
    slot = np.arange(csr.nnz, dtype=np.int64) - _exclusive_cumsum(counts)[
        tile_sorted
    ]
    pos = tile_start[tile_sorted] * group + slot

    loc = np.zeros(ngroups * group, dtype=np.int32)
    vals = np.zeros(ngroups * group, dtype=np.float32)
    loc[pos] = (
        (col[order] % in_window) | ((row[order] % out_strip) << 16)
    ).astype(np.int32)
    vals[pos] = coo.data[order].astype(np.float32)

    nonempty = np.flatnonzero(tile_groups)
    per_tile = tile_groups[nonempty]
    within = np.arange(int(per_tile.sum()), dtype=np.int64) - np.repeat(
        _exclusive_cumsum(per_tile), per_tile
    )
    out_of_group = np.repeat(np.arange(nstrips, dtype=np.int64), strip_groups)
    meta = np.zeros((ngroups, 4), dtype=np.int32)
    meta[:, 0] = out_of_group
    meta[0, 1] = 1
    meta[1:, 1] = out_of_group[1:] != out_of_group[:-1]
    meta[-1, 2] = 1
    meta[:-1, 2] = meta[1:, 1]
    # an empty strip's all-padding group reads window 0
    meta[np.repeat(tile_start[nonempty], per_tile) + within, 3] = np.repeat(
        nonempty % nwin, per_tile
    )

    tile_first_group = np.sort(
        np.concatenate([tile_start[nonempty], strip_ptr[:-1][empty_strip]])
    )
    return {
        "loc": loc,
        "vals": vals,
        "meta": meta,
        "tile_ptr": np.append(tile_first_group, ngroups),
        "strip_tile_ptr": np.searchsorted(tile_first_group, strip_ptr),
        "items": work_items(strip_groups),
    }


def build_tile_plan(
    csr: sp.csr_matrix, device, label: str,
    out_strip: Optional[int] = None, in_window: Optional[int] = None,
    group: Optional[int] = None,
    index_from: "Optional[TilePlan]" = None,
) -> TilePlan:
    """Host-side build of one orientation's tile plan.

    index_from: the same orientation of a matrix with the same sparsity
    pattern; its geometry is taken over, its index tensors are reused on
    the device and only the values are transferred."""
    if index_from is not None:
        out_strip, in_window, group = (
            index_from.out_strip, index_from.in_window, index_from.group
        )
    rows, cols = csr.shape
    if out_strip is None:
        out_strip = pick_out_strip(rows)
    if in_window is None:
        in_window = pick_in_window(cols)
    if group is None:
        group = pick_group(csr.shape, csr.nnz, out_strip, in_window)
    host = _host_tile_plan(csr, int(out_strip), int(in_window), int(group))
    if index_from is not None:
        return dataclasses.replace(
            index_from, vals=_f32_tensor(host["vals"], index_from.device)
        )
    items = host["items"]
    nstrips = len(host["strip_tile_ptr"]) - 1
    split = items[:-1, 2] > 1
    slots = (items[:-1, 3] + items[:-1, 2])[split].max() if split.any() else 0
    return TilePlan(
        loc=_i32_tensor(host["loc"], device),
        vals=_f32_tensor(host["vals"], device),
        meta=_i32_tensor(host["meta"], device),
        tile_ptr=_i32_tensor(host["tile_ptr"], device),
        strip_tile_ptr=_i32_tensor(host["strip_tile_ptr"], device),
        items=_i32_tensor(items, device),
        scratch=torch.empty(
            max(int(slots), 1), int(out_strip), dtype=torch.float32,
            device=device,
        ),
        tickets=torch.zeros(nstrips + 1, dtype=torch.int32, device=device),
        warps=pick_block_warps(out_strip),
        num_rows=rows,
        num_cols=cols,
        out_strip=int(out_strip),
        in_window=int(in_window),
        group=int(group),
        nnz=int(csr.nnz),
        label=label,
    )


def tile_plan_stats(plan: TilePlan) -> Dict[str, float]:
    """What the kernels' launch over `plan` looks like: blocks (one per
    item), stored entries (padding included) of the largest and of the
    mean block, how many tiles stage their window into shared memory
    and how many gather x straight from device memory, and the bytes
    staged per product. The kernels stage nothing (csrc/tiled_spmv.cuh),
    so the staged counts are 0 by design."""
    items = plan.items.cpu().numpy().astype(np.int64)
    sizes = np.diff(items[:, 0]) * plan.group
    split = items[:-1, 2] > 1
    return {
        "blocks": plan.nitems,
        "block_warps": plan.warps,
        "entries_per_block_max": int(sizes.max()),
        "entries_per_block_mean": float(sizes.mean()),
        "max_over_mean": float(sizes.max() / sizes.mean()),
        "split_strips": int(np.sum(split & (items[:-1, 1] == 0))),
        "scratch_bytes": int(4 * split.sum() * plan.out_strip),
        "tiles_staged": 0,
        "tiles_gathered": int(plan.tile_ptr.shape[0]) - 1,
        "bytes_staged": 0,
        "plan_bytes": tile_plan_bytes(plan),
    }


def tile_plan_bytes(plan: TilePlan) -> int:
    """Bytes the plan's kernels read: packed indices and values of every
    stored entry, padding included, the group table and the item table,
    each once. Not a bound: the product needs only the CSR bytes of the
    matrix (csr_kernel_bytes)."""
    return (8 * plan.ngroups * plan.group + 16 * plan.ngroups
            + 16 * (plan.nitems + 1))


def tile_plan_coordinates(plan: TilePlan):
    """(row, col) of every stored entry, padding included, as int64
    tensors: the local indices unpacked and the strip offsets added. A
    padding entry lands on the first row and column of its group's
    strips, with value 0."""
    loc = plan.loc.long()
    group_of = torch.arange(
        loc.shape[0], device=loc.device
    ) // plan.group
    meta = plan.meta.long()
    rows = meta[group_of, 0] * plan.out_strip + (loc >> 16)
    cols = meta[group_of, 3] * plan.in_window + (loc & 0xFFFF)
    return rows, cols


def _strip_total(plan: TilePlan, per_row: torch.Tensor) -> torch.Tensor:
    """The sum of `per_row` over the plan's output strips, one partial a
    strip as the kernels' epilogues give, accumulated in f64 and rounded
    once to `per_row`'s dtype: on the card index_add_'s atomics add in
    no fixed order, and in f32 that order moves the sum."""
    strip_of = torch.arange(
        plan.num_rows, device=per_row.device
    ) // plan.out_strip
    partials = torch.zeros(
        plan.nstrips, dtype=torch.float64, device=per_row.device
    ).index_add_(0, strip_of, per_row.to(torch.float64))
    return torch.sum(partials).to(per_row.dtype)


def tiled_spmv_plain(plan: TilePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A x on the plan's tensors: unpack, gather, multiply and add
    into the padded strips in f64 (each f32 product exact there, and the
    sum free of index_add_'s order on the card), rounded once to f32."""
    rows, cols = tile_plan_coordinates(plan)
    y = torch.zeros(
        plan.nstrips * plan.out_strip, dtype=torch.float64, device=x.device
    ).index_add_(0, rows, plan.vals.to(torch.float64)
                 * x[cols].to(torch.float64))
    return y[: plan.num_rows].to(torch.float32)


def tiled_dual_step_plain(plan, z, y, b, is_eq, sigma):
    """(y+, sum((y+ - y)^2)) with y+ = proj(y + sigma (b - A z)); the
    sum is taken over one partial per strip."""
    az = tiled_spmv_plain(plan, z)
    cand = y + sigma * (b - az)
    y_next = torch.where(is_eq != 0, cand, torch.clamp_min(cand, 0.0))
    dy = y_next - y
    return y_next, _strip_total(plan, dy * dy)


def tiled_rmv_stats_plain(plan, y, dx, aty_old):
    """(A' y, sum(dx (A' y - aty_old)), sum(dx^2)); `plan` holds A'.
    Each sum is taken over one partial per strip."""
    aty = tiled_spmv_plain(plan, y)
    return (
        aty,
        _strip_total(plan, dx * (aty - aty_old)),
        _strip_total(plan, dx * dx),
    )


def _launch_tiled(lib: str, plan: TilePlan, *args) -> None:
    if plan.device.type != "cuda":
        raise ValueError(f"{lib}: the plan is not on a CUDA device")
    fn = kernels_build.kernel_function(lib)
    with torch.cuda.device(plan.device):  # as _launch
        stream = torch.cuda.current_stream(plan.device).cuda_stream
        err = fn(
            plan.loc.data_ptr(), plan.vals.data_ptr(), plan.meta.data_ptr(),
            plan.items.data_ptr(), plan.scratch.data_ptr(),
            plan.tickets.data_ptr(), plan.nitems, plan.nstrips, plan.group,
            plan.out_strip, plan.in_window, plan.num_rows, plan.num_cols,
            plan.warps, *args, stream,
        )
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")


def tiled_spmv(plan: TilePlan, x: torch.Tensor) -> torch.Tensor:
    """y = plan @ x (f32). Plain version for CPU tensors, else the
    tiled_spmv kernel."""
    if _on_cpu(plan, x):
        return tiled_spmv_plain(plan, x)
    _check("x", x, (plan.num_cols,), plan.device)
    y = torch.empty(plan.num_rows, dtype=torch.float32, device=plan.device)
    _launch_tiled("tiled_spmv", plan, x.data_ptr(), y.data_ptr())
    LAUNCHES[f"tiled_spmv:{plan.label}"] += 1
    return y


def tiled_dual_step(plan, z, y, b, is_eq, sigma):
    """Fused dual step over the tile plan of A; returns (y+,
    sum((y+ - y)^2)). `sigma` is a one-element f32 tensor on the plan's
    device, read by the kernel."""
    if _on_cpu(plan, z):
        return tiled_dual_step_plain(plan, z, y, b, is_eq, sigma)
    m = plan.num_rows
    _check("z", z, (plan.num_cols,), plan.device)
    for name, t in (("y", y), ("b", b), ("is_eq", is_eq)):
        _check(name, t, (m,), plan.device)
    _check("sigma", sigma.reshape(()), (), plan.device)
    y_next = torch.empty(m, dtype=torch.float32, device=plan.device)
    # one partial per strip, then their sum in strip order
    parts = torch.empty(
        plan.nstrips + 1, dtype=torch.float32, device=plan.device
    )
    _launch_tiled(
        "tiled_dual_step", plan, z.data_ptr(), y.data_ptr(), b.data_ptr(),
        is_eq.data_ptr(), sigma.data_ptr(), y_next.data_ptr(),
        parts.data_ptr(),
    )
    LAUNCHES["tiled_dual_step"] += 1
    return y_next, parts[plan.nstrips]


def tiled_rmv_stats(plan, y, dx, aty_old):
    """Fused A' y+ with the step-control sums over the tile plan of A'.
    Returns (aty+, sum(dx (aty+ - aty_old)), sum(dx^2))."""
    if _on_cpu(plan, y):
        return tiled_rmv_stats_plain(plan, y, dx, aty_old)
    n = plan.num_rows
    _check("y", y, (plan.num_cols,), plan.device)
    _check("dx", dx, (n,), plan.device)
    _check("aty_old", aty_old, (n,), plan.device)
    aty = torch.empty(n, dtype=torch.float32, device=plan.device)
    # two partials per strip, then the two sums in strip order
    parts = torch.empty(
        2 * plan.nstrips + 2, dtype=torch.float32, device=plan.device
    )
    _launch_tiled(
        "tiled_rmv_stats", plan, y.data_ptr(), dx.data_ptr(),
        aty_old.data_ptr(), aty.data_ptr(), parts.data_ptr(),
    )
    LAUNCHES["tiled_rmv_stats"] += 1
    return aty, parts[2 * plan.nstrips], parts[2 * plan.nstrips + 1]


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoutedOp:
    """Kernel linear operator (drop-in LinOp: mv / rmv / shape), with the
    fused PDLP step methods of the JAX package's RoutedOp. It works on
    flat (m,)/(n,) vectors; the kernels compute in f32. `a` and `at`
    are CSR matrices, or tile plans when `tile_aligned` is set."""

    a: Union[CsrKernelMatrix, TilePlan]
    at: Union[CsrKernelMatrix, TilePlan]
    tile_aligned: bool = False
    # sha256 of the csr sparsity pattern (share_plan_with's check)
    pattern_hash: str = ""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.a.num_rows, self.a.num_cols)

    def _spmv(self, mat, v: torch.Tensor) -> torch.Tensor:
        product = tiled_spmv if self.tile_aligned else spmv_csr
        return product(mat, v.to(torch.float32)).to(v.dtype)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x (computed in f32, returned in x's dtype)."""
        return self._spmv(self.a, x)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """A' @ y."""
        return self._spmv(self.at, y)

    def mv_dual_step(self, z, y, b, is_eq, sigma):
        """Fused y+ = proj(y + sigma (b - A z)); returns (y+, y+ in the
        layout rmv_stats takes, sum((y+ - y)^2)). Flat vectors stand in
        for the JAX package's strip layout, so the two y+ are one
        tensor."""
        step = tiled_dual_step if self.tile_aligned else spmv_dual_step
        y_next, dy2 = step(self.a, z, y, b, is_eq, sigma)
        return y_next, y_next, dy2

    def rmv_stats(self, y_next, dx, aty_old):
        """Fused A' y+; returns (aty+, sum(dx (aty+ - aty_old)),
        sum(dx^2))."""
        stats = tiled_rmv_stats if self.tile_aligned else spmv_rmv_stats
        return stats(self.at, y_next, dx, aty_old)


def pattern_hash(csr: sp.csr_matrix) -> str:
    """sha256 of the shape and sparsity pattern of a canonical csr."""
    h = hashlib.sha256()
    h.update(repr((*csr.shape, csr.nnz)).encode())
    h.update(np.ascontiguousarray(csr.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def build_routed_op(
    matrix: sp.spmatrix,
    device=None,
    tile_aligned: Optional[bool] = None,
    share_plan_with: Optional[RoutedOp] = None,
    out_strip: Optional[int] = None,
    in_window: Optional[int] = None,
    group: Optional[int] = None,
) -> RoutedOp:
    """Stores `matrix` and its transpose on `device` (CUDA when None;
    raises without a GPU), as CSR or as tile plans.

    tile_aligned: None reads DEFAULT_TILE_ALIGNED at call time.
    share_plan_with: an operator over a matrix with the SAME sparsity
    pattern (for example the rescaled copy); the new operator takes its
    layout and device, reuses its index tensors and transfers only the
    values. Raises ValueError on another pattern.
    out_strip / in_window / group: the tile plan's geometry, applied to
    both orientations (default: pick_out_strip, pick_in_window,
    pick_group)."""
    csr = sp.csr_matrix(matrix, dtype=np.float64)
    csr.sum_duplicates()
    m, n = csr.shape
    if csr.nnz == 0 or m == 0 or n == 0:
        raise ValueError("the kernel operator requires a nonempty matrix")
    fingerprint = pattern_hash(csr)
    donor = share_plan_with
    if donor is not None:
        if donor.pattern_hash != fingerprint:
            raise ValueError(
                "share_plan_with requires an identical sparsity pattern"
            )
        tile_aligned = donor.tile_aligned
        device = donor.a.device
    else:
        device = resolve_device(device)
        if tile_aligned is None:
            tile_aligned = DEFAULT_TILE_ALIGNED
    csr_t = sp.csr_matrix(csr.T)
    csr_t.sum_duplicates()
    if tile_aligned:
        geometry = dict(out_strip=out_strip, in_window=in_window, group=group)
        return RoutedOp(
            a=build_tile_plan(
                csr, device, "A", index_from=donor and donor.a, **geometry
            ),
            at=build_tile_plan(
                csr_t, device, "AT", index_from=donor and donor.at,
                **geometry,
            ),
            tile_aligned=True,
            pattern_hash=fingerprint,
        )
    return RoutedOp(
        a=build_csr_kernel_matrix(
            csr, device, "A", index_from=donor and donor.a
        ),
        at=build_csr_kernel_matrix(
            csr_t, device, "AT", index_from=donor and donor.at
        ),
        tile_aligned=False,
        pattern_hash=fingerprint,
    )


def library_spmv(mat: CsrKernelMatrix) -> "torch.Tensor":
    """torch.sparse_csr_tensor over `mat`: the library yardstick that
    chip_smoke.py times beside the kernels. The port never calls it."""
    return torch.sparse_csr_tensor(
        mat.indptr.long(), mat.indices.long(), mat.vals,
        size=(mat.num_rows, mat.num_cols),
    )

