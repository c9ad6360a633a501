"""The heterogeneous lane operator: a fleet of B matrices of one shape
(each instance padded to it, parallel.pad_problem) whose sparsity
patterns differ, as batch.solve_batch takes them.

The JAX package aligns every instance's ELL planes to common shapes and
vmaps XLA gathers over a leading batch axis (_align_ell_ops and
_align_bundle_ops, firstorderlp_tpu/batch.py:1248-1361); no Pallas kernel
computes that product. The port stacks the B matrices into one
interleaved block-diagonal CSR matrix instead:

- row i of lane b is row i B + b, and column j of lane b is column
  j B + b;
- so a (dim, B) lane tensor, contiguous in B, flattened is exactly that
  matrix's vector, and one product computes every lane's A_b x_b with no
  transpose;
- each row holds the entries of one lane, so the CSR kernels' work items
  (routed.csr_work_items) balance rows of mixed lengths and cut every
  lane's long rows into pieces;
- it stores sum_b nnz_b entries per orientation, as the JAX package's
  aligned planes do (up to their padding).

In f32 the product is B2 ``spmv_csr`` (csrc/spmv_csr.cu) on a
routed.CsrKernelMatrix of each orientation; in f64 it runs on the
operator the single-instance f64 path builds (linops.CsrOp), over the
same block matrix, since B2 computes in f32 only. On CPU tensors
``spmv_csr`` takes its plain version (``block_lanes_spmv_plain``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .device import resolve_device
from .linops import CsrHalf, build_csr_op
from .routed import (
    ITEM_BLOCK_THREADS,
    CsrKernelMatrix,
    build_csr_kernel_matrix,
    pattern_hash,
    spmv_csr,
    spmv_csr_plain,
)

# The kernels index rows, columns and entries with int32.
_INT32_LIMIT = 2**31 - ITEM_BLOCK_THREADS


def block_matrix(mats: Sequence[sp.spmatrix]) -> sp.csr_matrix:
    """The interleaved block-diagonal CSR matrix of `mats` (B matrices
    of one shape (m, n)): entry (i, j) of lane b at (i B + b, j B + b),
    canonical (sorted indices, no duplicates), f64."""
    lanes = len(mats)
    if lanes == 0:
        raise ValueError("a block lane matrix needs at least one lane")
    shape = mats[0].shape
    rows, cols, vals = [], [], []
    for b, mat in enumerate(mats):
        if mat.shape != shape:
            raise ValueError(
                f"lane {b} has shape {mat.shape}, lane 0 {shape}: pad the "
                "fleet to one shape first (parallel.pad_problem)")
        coo = sp.coo_matrix(mat)
        rows.append(coo.row.astype(np.int64) * lanes + b)
        cols.append(coo.col.astype(np.int64) * lanes + b)
        vals.append(coo.data.astype(np.float64))
    block = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(shape[0] * lanes, shape[1] * lanes),
    )
    block.sum_duplicates()
    block.sort_indices()
    return block


def block_lanes_spmv_plain(mat: CsrKernelMatrix,
                           x: torch.Tensor) -> torch.Tensor:
    """y = A_b x_b for every lane, (cols, B) -> (rows, B), as
    ``spmv_csr_plain`` on the block matrix `mat` (one orientation)."""
    lanes = x.shape[1]
    return spmv_csr_plain(mat, x.contiguous().reshape(-1)).reshape(
        mat.num_rows // lanes, lanes)


def _product(mat, v: torch.Tensor, rows: int) -> torch.Tensor:
    flat = v.contiguous().reshape(-1)
    if isinstance(mat, CsrKernelMatrix):
        return spmv_csr(mat, flat).reshape(rows, -1)
    return mat.mv(flat).reshape(rows, -1)


@dataclasses.dataclass(frozen=True)
class BlockLanesOp:
    """The lane operator of one copy of a heterogeneous fleet (drop-in
    LinOp for DeviceQp: mv / rmv / shape, on (dim, B) lane tensors).
    `a` and `at` are the block matrix and its transpose: CSR kernel
    matrices (f32) or the f64 operator's CSR halves."""

    a: Union[CsrKernelMatrix, CsrHalf]
    at: Union[CsrKernelMatrix, CsrHalf]
    num_rows: int  # a lane's m
    num_cols: int  # a lane's n
    lanes: int
    pattern_hash: str  # of the block matrix (share_with's check)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.num_cols)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A_b x_b per lane: (n, B) -> (m, B)."""
        return _product(self.a, x, self.num_rows)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """A_b' y_b per lane: (m, B) -> (n, B)."""
        return _product(self.at, y, self.num_cols)


def build_block_lanes(
    mats: Sequence[sp.spmatrix], device=None, dtype=torch.float32,
    label: str = "A", share_with: Optional[BlockLanesOp] = None,
) -> BlockLanesOp:
    """The block matrix of `mats` and its transpose on `device` (CUDA
    when None; raises without a GPU), built once. f32: CSR kernel
    matrices labelled `label` and `label`T (their launches count under
    ``spmv_csr:<label>``); f64: the f64 operator's CSR halves.
    `share_with`: the operator of another copy of the fleet (the scaled
    one); where its block matrix has this one's pattern, its index
    tensors, items and tickets are reused and only the values move."""
    device = resolve_device(device)
    m, n = mats[0].shape
    lanes = len(mats)
    block = block_matrix(mats)
    fingerprint = pattern_hash(block)
    if dtype == torch.float64:
        op = build_csr_op(block, dtype, device)
        a, at = op.fwd, op.bwd
    elif dtype == torch.float32:
        if max(m, n) * lanes >= _INT32_LIMIT or block.nnz >= _INT32_LIMIT:
            raise ValueError(
                f"a fleet of {lanes} lanes of {m} x {n} with {block.nnz} "
                "stored entries in all does not fit the kernels' int32 "
                "indices (rows and columns times lanes, and the entries, "
                f"must stay under {_INT32_LIMIT})")
        donor = share_with
        if not (isinstance(donor, BlockLanesOp)
                and isinstance(donor.a, CsrKernelMatrix)
                and donor.pattern_hash == fingerprint):
            donor = None
        block_t = sp.csr_matrix(block.T)
        block_t.sort_indices()
        a = build_csr_kernel_matrix(block, device, label,
                                    index_from=donor and donor.a)
        at = build_csr_kernel_matrix(block_t, device, label + "T",
                                     index_from=donor and donor.at)
    else:
        raise TypeError(f"block lanes compute in f32 or f64, not {dtype}")
    return BlockLanesOp(a=a, at=at, num_rows=m, num_cols=n, lanes=lanes,
                        pattern_hash=fingerprint)
