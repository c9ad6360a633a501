"""Linear operators for the constraint and objective matrices.

- DenseOp: the matrix as a dense (m, n) tensor; products by
  torch.matmul (the JAX package also leaves the dense product to XLA).
- CsrOp: A and A' each stored as CSR in the working dtype (the same
  trade as the JAX package's ELL operator, which stores both
  orientations); products as a gather and a segmented sum in plain
  PyTorch. It stands in for the JAX package's "sparse"/"ell" and "coo"
  layouts and is the f64 path.
- RoutedOp (ops/routed.py): the f32 kernel operator.
- ShardedRoutedOp (ops/routed_sharded.py): any of the three, cut into a
  (D, P) grid of blocks over a solver mesh (build_linop's shard_plan).

Reference call sites these replace: `problem.constraint_matrix * x` and
`problem.constraint_matrix' * y` (src/saddle_point.jl:1089,1106;
src/primal_dual_hybrid_gradient.jl:492).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .device import resolve_device
from .routed import RoutedOp, build_routed_op, pattern_hash


@dataclasses.dataclass(frozen=True)
class DenseOp:
    a: torch.Tensor  # (m, n)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        return y @ self.a


@dataclasses.dataclass(frozen=True)
class CsrHalf:
    """One orientation: int64 indptr/indices and values in the dtype."""

    indptr: torch.Tensor
    indices: torch.Tensor
    vals: torch.Tensor

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.vals * x[self.indices]
        return torch.segment_reduce(
            prod, "sum", offsets=self.indptr, initial=0.0
        )


@dataclasses.dataclass(frozen=True)
class CsrOp:
    fwd: CsrHalf  # A
    bwd: CsrHalf  # A'
    num_rows: int
    num_cols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.num_cols)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self.fwd.mv(x)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        return self.bwd.mv(y)


LinOp = Union[DenseOp, CsrOp, RoutedOp]


def matvec(op: Optional[LinOp], x: torch.Tensor) -> torch.Tensor:
    if op is None:
        return torch.zeros_like(x)
    return op.mv(x)


def rmatvec(op: Optional[LinOp], y: torch.Tensor) -> torch.Tensor:
    if op is None:
        return torch.zeros_like(y)
    return op.rmv(y)


def _csr_half(csr: sp.csr_matrix, dtype, device) -> CsrHalf:
    return CsrHalf(
        indptr=torch.as_tensor(csr.indptr.astype(np.int64), device=device),
        indices=torch.as_tensor(csr.indices.astype(np.int64), device=device),
        vals=torch.as_tensor(csr.data, device=device).to(dtype),
    )


def build_csr_op(matrix: sp.spmatrix, dtype, device) -> CsrOp:
    csr = sp.csr_matrix(matrix)
    csr.sum_duplicates()
    csr_t = sp.csr_matrix(csr.T)
    csr_t.sum_duplicates()
    return CsrOp(
        fwd=_csr_half(csr, dtype, device),
        bwd=_csr_half(csr_t, dtype, device),
        num_rows=matrix.shape[0],
        num_cols=matrix.shape[1],
    )


def build_dense_op(matrix: sp.spmatrix, dtype, device) -> DenseOp:
    return DenseOp(
        a=torch.as_tensor(np.asarray(matrix.todense()), device=device).to(
            dtype
        )
    )


# The auto-format cutovers (the JAX package's defaults): dense up to
# this many matrix entries, the kernel operator from this many nonzeros.
DENSE_SIZE_LIMIT = 2_000_000
ROUTED_NNZ_THRESHOLD = 50_000


def build_linop(
    matrix: sp.spmatrix,
    dtype=torch.float64,
    format: str = "auto",
    device=None,
    share_plan_with: Optional[LinOp] = None,
    shard_plan=None,
) -> LinOp:
    """Chooses a layout for `matrix` (the JAX package's format rules)
    and builds it on `device`: CUDA when None (raises without a GPU),
    the CPU only when asked.

    format: "dense" (also "dense_onchip"), "sparse"/"ell"/"coo" (CsrOp),
    "routed" (the f32 kernel operator), or "auto": dense when
    m*n <= DENSE_SIZE_LIMIT, the kernel operator on a CUDA device for
    f32 matrices with >= ROUTED_NNZ_THRESHOLD nonzeros (the JAX package
    asks for a TPU backend there), CsrOp otherwise.

    share_plan_with: an operator built for a matrix of the same shape;
    when it is a kernel operator on `device` (or a routed
    ShardedRoutedOp on the same mesh) with this matrix's sparsity
    pattern and the kernel layout is chosen here too, its index tensors
    are reused and only the values are transferred.

    shard_plan: a RoutedShardPlan (ops/routed_sharded.py) for
    multi-device solves: the layout is chosen as above, on the whole
    matrix and the mesh's home device, and the matrix is built as a
    ShardedRoutedOp whose blocks have that layout.
    """
    if shard_plan is not None:
        device = shard_plan.mesh.home_device
    else:
        device = resolve_device(device)
    m, n = matrix.shape
    if format in ("dense", "dense_onchip") or (
        format == "auto" and m * n <= DENSE_SIZE_LIMIT
    ):
        layout = "dense"
    elif format == "routed" or (
        format == "auto"
        and dtype == torch.float32
        and matrix.nnz >= ROUTED_NNZ_THRESHOLD
        and device.type == "cuda"
    ):
        if dtype != torch.float32:
            raise ValueError("routed layout computes in f32")
        layout = "routed"
    elif format in ("auto", "sparse", "ell", "coo"):
        layout = "sparse"
    else:
        raise ValueError(f"unknown matrix format {format!r}")
    donor = share_plan_with
    if shard_plan is not None:
        from .routed_sharded import ShardedRoutedOp, build_sharded_routed_op

        if (layout == "routed" and isinstance(donor, ShardedRoutedOp)
                and donor.format == "routed"
                and donor.mesh == shard_plan.mesh
                and donor.tile_aligned == shard_plan.tile_aligned):
            csr = sp.csr_matrix(matrix, dtype=np.float64)
            csr.sum_duplicates()
            if pattern_hash(csr) == donor.pattern_hash:
                return build_sharded_routed_op(
                    csr, shard_plan, share_plan_with=donor
                )
        return build_sharded_routed_op(
            matrix, shard_plan, dtype=dtype, format=layout
        )
    if layout == "dense":
        return build_dense_op(matrix, dtype, device)
    if layout == "routed":
        if isinstance(donor, RoutedOp) and donor.a.device == device:
            csr = sp.csr_matrix(matrix, dtype=np.float64)
            csr.sum_duplicates()
            if pattern_hash(csr) == donor.pattern_hash:
                return build_routed_op(csr, share_plan_with=donor)
        return build_routed_op(matrix, device)
    return build_csr_op(matrix, dtype, device)
