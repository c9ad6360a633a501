"""The shared-pattern lane operator: one sparsity pattern, a fleet of B
matrices that differ only in their values, as the fleet solver
(batch.py) takes them.

Layout (the JAX package's minor batch axis, batch.py:74-90 there): every
lane vector is (dim, B), contiguous in B, and the values are an (nnz, B)
plane in the matrix's entry order, so entry k of every lane is one
contiguous row of B values. The pattern's index tensors are held once:

- ``LanesPattern``: A's CSR and the transposed CSR (int32), each with its
  work items (``routed.csr_work_items``) and integer tickets, the
  permutation from A' entries to A entries (computed once on the host),
  and the row of every entry (the plain version's scatter index);
- ``LanesOp``: a pattern and the value planes of one copy of the fleet
  (the scaled or the original), in A's entry order and in A''s;
  ``mv`` takes (n, B) to (m, B), ``rmv`` (m, B) to (n, B).

One kernel, L1 ``lanes_spmv`` (csrc/lanes_spmv.cu), computes
y[r, b] = sum_{k in row r} vals[k, b] x[cols[k], b] for either
orientation, in f32 or f64, without floating-point atomics. The JAX
package computes this product with XLA gathers over ELL planes under
vmap (ops/linops.py:68-129 there); no Pallas kernel does. The wrapper
takes the plain version (``lanes_spmv_plain``: a gather and
``index_add_``) only for CPU tensors; on a CUDA tensor it launches the
kernel or raises. Each launch adds one to ``LAUNCHES``, whichever
variant ran: the vector one (16-byte lanes) where the planes and x are
16-byte aligned and a lane row is a multiple of 16 bytes, else the
scalar one (``lanes_plan``). What every launch on a half at one lane
count and dtype reuses is built at the first: the pieces' scratch and
the kernel's constant arguments, bound once in a ctypes structure
passed by address.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels_build
from .routed import LONG_ROW_TRIPS, csr_work_items, pattern_hash

# Work items of the lane kernel (csrc/lanes_spmv.cu): one block per item
# of about LANE_ITEM_ENTRIES entries (and rows); a row longer than that
# is cut into pieces of about that size, added in piece order behind a
# ticket. 64 entries give the 128-lane 20k-node PageRank fleet about
# 2,850 blocks for A (the dense row 313 pieces).
LANE_ITEM_ENTRIES = 64
# Entries whose values and x rows a warp loads at once (4, 8 or 16),
# and the bytes of a thread's lanes in the vector variant (16: float4,
# double2; 4 or 8 only for compare_kernels --sweep).
LANE_UNROLL = 8
LANE_VECTOR_BYTES = 16

# Launch counts per orientation (A x and A' y counted apart; Q x: a QP
# fleet's objective matrix), and of the fleet's lane trial
# (ops/lanes_step.py): LF1a, L1 with the dual step, L1' with the
# step-control sums, LF1b.
LAUNCHES: Dict[str, int] = {"lanes_spmv:A": 0, "lanes_spmv:AT": 0,
                            "lanes_spmv:Q": 0, "lanes_spmv:QT": 0,
                            "lane_primal_step": 0, "lanes_spmv:A+dual": 0,
                            "lanes_spmv:AT+stats": 0,
                            "lane_trial_epilogue": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@dataclasses.dataclass(frozen=True)
class LanesHalf:
    """One orientation of the pattern, as the kernel takes it."""

    indptr: torch.Tensor  # (rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    rows: torch.Tensor  # (nnz,) int64, the row of each entry (plain path)
    # (nitems + 1, 4) int32: [first entry, first row, index of the piece
    # in its row, pieces of its row (0: a run of short rows)], then
    # [nnz, rows, 0, 0] (routed.csr_work_items)
    items: torch.Tensor
    tickets: torch.Tensor  # (nitems + 1,) int32, zero between launches
    num_rows: int
    num_cols: int
    label: str  # "A" or "AT" ("Q", "QT": an objective matrix)
    item_entries: int
    # (dtype, lanes) -> the pieces' partial sums, shared by the value
    # planes of this half, whose products run on one stream; and (dtype,
    # lanes, aligned, plan) -> _Launch: both made at the first launch
    scratch: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)
    launches: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nitems(self) -> int:
        return int(self.items.shape[0]) - 1

    @functools.cached_property
    def device(self) -> torch.device:
        return self.indices.device


@dataclasses.dataclass(frozen=True)
class LanesPattern:
    """A's pattern in both orientations. `perm_t[k]` is the A entry that
    A' entry k holds, so a plane in A' order is ``plane[perm_t]``."""

    fwd: LanesHalf  # A
    bwd: LanesHalf  # A'
    perm_t: torch.Tensor  # (nnz,) int64
    pattern_hash: str
    # lanes -> the lane trial's scratch (ops/lanes_step.trial_workspace),
    # made at the first trial
    workspaces: dict = dataclasses.field(default_factory=dict,
                                         compare=False, repr=False)

    @property
    def shape(self):
        return (self.fwd.num_rows, self.fwd.num_cols)

    @property
    def nnz(self) -> int:
        return self.fwd.nnz

    @property
    def device(self) -> torch.device:
        return self.fwd.device


def _half(csr: sp.csr_matrix, label: str, item_entries: int,
          device) -> LanesHalf:
    rows, cols = csr.shape
    items = csr_work_items(
        csr.indptr, max(item_entries // LONG_ROW_TRIPS, 1), item_entries
    )
    return LanesHalf(
        indptr=torch.as_tensor(csr.indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(csr.indices.astype(np.int32), device=device),
        rows=torch.as_tensor(
            np.repeat(np.arange(rows, dtype=np.int64), np.diff(csr.indptr)),
            device=device,
        ),
        items=torch.as_tensor(items.astype(np.int32), device=device),
        tickets=torch.zeros(len(items), dtype=torch.int32, device=device),
        num_rows=rows,
        num_cols=cols,
        label=label,
        item_entries=int(item_entries),
    )


def build_lanes_pattern(pattern: sp.csr_matrix, device,
                        item_entries: int = LANE_ITEM_ENTRIES,
                        label: str = "A") -> LanesPattern:
    """The index tensors of `pattern` (a canonical csr: sorted indices,
    no duplicates) on `device`, its halves labelled `label` and
    `label`T (their launches count under ``lanes_spmv:<label>``). The A'
    permutation comes from a transpose of the entry ids on the host."""
    csr = sp.csr_matrix(pattern)
    if not csr.has_canonical_format:
        raise ValueError("the lane pattern must be a canonical csr matrix")
    if csr.nnz >= 2**31 - 1:
        raise ValueError("int32 CSR indices cannot hold this matrix")
    m, n = csr.shape
    ids = sp.csr_matrix(
        (np.arange(1, csr.nnz + 1, dtype=np.float64), csr.indices,
         csr.indptr), shape=(m, n),
    )
    ids_t = sp.csr_matrix(ids.T)
    ids_t.sort_indices()
    perm_t = ids_t.data.astype(np.int64) - 1
    return LanesPattern(
        fwd=_half(csr, label, item_entries, device),
        bwd=_half(ids_t, label + "T", item_entries, device),
        perm_t=torch.as_tensor(perm_t, device=device),
        pattern_hash=pattern_hash(csr),
    )


def lanes_kernel_bytes(half: LanesHalf, lanes: int, elem_bytes: int) -> int:
    """Bytes one product must move, each input read once and the output
    written once: the value plane, the CSR indices and row pointers, x
    and y."""
    return (half.nnz * lanes * elem_bytes + 4 * half.nnz
            + 4 * (half.num_rows + 1)
            + (half.num_cols + half.num_rows) * lanes * elem_bytes)


def lanes_spmv_plain(half: LanesHalf, vals: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """y = A x per lane as a gather and ``index_add_`` over rows."""
    prod = vals * x[half.indices.long()]
    y = torch.zeros((half.num_rows, x.shape[1]), dtype=x.dtype,
                    device=x.device)
    return y.index_add_(0, half.rows, prod)


@dataclasses.dataclass(frozen=True)
class LanesPlan:
    """How one launch of L1 walks a half: the variant (`vec` lanes a
    thread, 1 for the scalar one), the slabs of 32 vec lanes (a warp's)
    it cuts the lanes into, the entries a warp loads at once and the grid
    (one block of four warps per item)."""

    vec: int
    slabs: int
    unroll: int
    blocks: int

    @property
    def variant(self) -> str:
        return "scalar" if self.vec == 1 else f"vector{self.vec}"


def lanes_plan(half: LanesHalf, lanes: int, elem_bytes: int,
               aligned: bool, unroll: int = LANE_UNROLL,
               vector_bytes: int = LANE_VECTOR_BYTES) -> LanesPlan:
    """The launch of L1 on `half` at `lanes` lanes of `elem_bytes` bytes:
    the vector variant (vector_bytes / elem_bytes lanes a thread) when a
    lane row (lanes elem_bytes) is a multiple of `vector_bytes` and the
    planes and vectors are `aligned` to it, else the scalar one."""
    if unroll not in (4, 8, 16):
        raise ValueError(f"unroll must be 4, 8 or 16, got {unroll}")
    vec = max(vector_bytes // elem_bytes, 1)
    if not aligned or (lanes * elem_bytes) % (vec * elem_bytes):
        vec = 1
    return LanesPlan(vec=vec, slabs=-(-lanes // (32 * vec)),
                     unroll=int(unroll), blocks=half.nitems)


class _LanesArgs(ctypes.Structure):
    """csrc/lanes_spmv.cu's LanesArgs: a half's constant kernel
    arguments at one lane count, dtype and plan, passed by address."""

    _fields_ = [
        ("indptr", ctypes.c_void_p),
        ("indices", ctypes.c_void_p),
        ("items", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("tickets", ctypes.c_void_p),
        ("nitems", ctypes.c_int),
        ("lanes", ctypes.c_int),
        ("elem_bytes", ctypes.c_int),
        ("vec", ctypes.c_int),
        ("unroll", ctypes.c_int),
    ]


@dataclasses.dataclass(frozen=True)
class _Launch:
    """What every launch on a half at one lane count, dtype and plan
    reuses: the constant arguments, bound once, their address and the C
    entry point."""

    args: _LanesArgs
    address: int
    fn: object


def _aligned(vals: torch.Tensor, x: torch.Tensor) -> bool:
    return (vals.data_ptr() | x.data_ptr()) % LANE_VECTOR_BYTES == 0


def _launch_for(half: LanesHalf, dtype: torch.dtype, lanes: int,
                aligned: bool, plan: Optional[LanesPlan]) -> _Launch:
    key = (dtype, lanes, aligned, plan)
    got = half.launches.get(key)
    if got is not None:
        return got
    if plan is not None and plan.vec > 1 and not aligned:
        raise ValueError("lanes_spmv: a vector plan on unaligned tensors")
    elem_bytes = torch.finfo(dtype).bits // 8
    plan = plan or lanes_plan(half, lanes, elem_bytes, aligned)
    scratch = half.scratch.get((dtype, lanes))
    if scratch is None:
        scratch = half.scratch[(dtype, lanes)] = torch.empty(
            max(half.nitems, 1) * lanes, dtype=dtype, device=half.device)
    args = _LanesArgs(
        half.indptr.data_ptr(), half.indices.data_ptr(),
        half.items.data_ptr(), scratch.data_ptr(), half.tickets.data_ptr(),
        half.nitems, lanes, elem_bytes, plan.vec, plan.unroll,
    )
    got = half.launches[key] = _Launch(
        args=args, address=ctypes.addressof(args),
        fn=kernels_build.kernel_function("lanes_spmv"))
    return got


def _current_stream(index: int) -> int:
    """The handle of the current CUDA stream of device `index`: torch's
    raw accessor (the one its own generated kernels call; 0.1 us a call
    on the card's host, against 8 us for the public
    torch.cuda.current_stream(...).cuda_stream) where the build has it."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _check(half: LanesHalf, vals: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lanes_spmv takes f32 or f64, got {x.dtype}")
    if vals.dtype != x.dtype:
        raise TypeError(f"vals must be {x.dtype}, got {vals.dtype}")
    device = half.device
    if x.device != device or vals.device != device:
        raise ValueError(f"x on {x.device} and vals on {vals.device}, the "
                         f"pattern on {device}")
    if x.dim() != 2 or x.shape[0] != half.num_cols:
        raise ValueError(f"x has shape {tuple(x.shape)}, want "
                         f"({half.num_cols}, lanes)")
    if vals.shape != (half.nnz, x.shape[1]):
        raise ValueError(f"vals has shape {tuple(vals.shape)}, want "
                         f"({half.nnz}, {x.shape[1]})")
    if not (x.is_contiguous() and vals.is_contiguous()):
        raise ValueError("x and vals must be contiguous")


def lanes_spmv(half: LanesHalf, vals: torch.Tensor, x: torch.Tensor,
               plan: Optional[LanesPlan] = None) -> torch.Tensor:
    """y = A x for every lane: `vals` (nnz, B) in `half`'s entry order,
    x (cols, B), y (rows, B), f32 or f64. The plain version for CPU
    tensors, else the lanes_spmv kernel: the vector variant where the
    planes and x are 16-byte aligned and a lane row a multiple of 16
    bytes, else the scalar one (lanes_plan). `plan`: another plan, for
    compare_kernels --sweep; the solver passes none."""
    if x.device.type == "cpu" and half.device.type == "cpu":
        return lanes_spmv_plain(half, vals, x)
    if half.device.type != "cuda":
        raise ValueError("lanes_spmv: the pattern is not on a CUDA device")
    _check(half, vals, x)
    lanes = x.shape[1]
    launch = _launch_for(half, x.dtype, lanes, _aligned(vals, x), plan)
    y = torch.empty((half.num_rows, lanes), dtype=x.dtype, device=x.device)
    err = launch.fn(launch.address, vals.data_ptr(), x.data_ptr(),
                    y.data_ptr(), _current_stream(half.device.index))
    if err != 0:
        raise RuntimeError(f"lanes_spmv launch failed: CUDA error {err}")
    LAUNCHES[f"lanes_spmv:{half.label}"] += 1
    return y


def launch_plan(half: LanesHalf, vals: torch.Tensor,
                x: torch.Tensor) -> LanesPlan:
    """The plan lanes_spmv(half, vals, x) launches with."""
    return lanes_plan(half, x.shape[1], x.element_size(), _aligned(vals, x))


@dataclasses.dataclass(frozen=True)
class LanesOp:
    """The lane operator of one copy of the fleet (drop-in LinOp for
    DeviceQp: mv / rmv / shape). `vals` and `vals_t` are the (nnz, B)
    value planes in A's and in A''s entry order."""

    pattern: LanesPattern
    vals: torch.Tensor
    vals_t: torch.Tensor

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def lanes(self) -> int:
        return int(self.vals.shape[1])

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A x per lane: (n, B) -> (m, B)."""
        return lanes_spmv(self.pattern.fwd, self.vals, x.contiguous())

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """A' y per lane: (m, B) -> (n, B)."""
        return lanes_spmv(self.pattern.bwd, self.vals_t, y.contiguous())


def lanes_op(pattern: LanesPattern, vals: torch.Tensor) -> LanesOp:
    """The operator of the (nnz, B) plane `vals` (A's entry order); the
    A' plane is gathered once on the device."""
    vals = vals.contiguous()
    return LanesOp(pattern=pattern, vals=vals,
                   vals_t=vals[pattern.perm_t].contiguous())


def library_lanes_matrix(half: LanesHalf, vals: torch.Tensor) -> torch.Tensor:
    """The block-diagonal (rows B) x (cols B) torch.sparse_csr_tensor with
    lane-interleaved indices (row r B + b, column c B + b, nnz B
    entries), so that ``matrix @ x.reshape(-1)`` is the lane product in
    one library call: the yardstick chip_smoke.py and compare_kernels
    time beside the kernel. The port never calls it."""
    lanes = int(vals.shape[1])
    device = vals.device
    indptr = half.indptr.long()
    length = indptr[1:] - indptr[:-1]
    lane = torch.arange(lanes, device=device)
    # row (r, b) holds the entries of row r, lane b, in entry order:
    # entry e of row r, lane b goes to indptr[r] B + b len(r) + (e -
    # indptr[r])
    start = indptr[half.rows]
    offset = torch.arange(half.nnz, device=device) - start
    pos = (start[:, None] * lanes + lane[None, :] * length[half.rows][:, None]
           + offset[:, None]).reshape(-1)
    values = torch.empty(half.nnz * lanes, dtype=vals.dtype, device=device)
    values[pos] = vals.reshape(-1)
    cols = torch.empty(half.nnz * lanes, dtype=torch.int64, device=device)
    cols[pos] = (half.indices.long()[:, None] * lanes
                 + lane[None, :]).reshape(-1)
    crow = torch.cat([
        (indptr[:-1, None] * lanes + lane[None, :] * length[:, None])
        .reshape(-1),
        indptr[-1:] * lanes,
    ])
    return torch.sparse_csr_tensor(
        crow, cols, values,
        size=(half.num_rows * lanes, half.num_cols * lanes),
    )
