"""The block-partitioned constraint operator of multi-device solves, the
port's counterpart of the JAX package's ``ops/routed_sharded.py``.

Design (what differs from the JAX package, and why):

- Only the constraint operator is partitioned. A is a (D, P) grid of
  blocks over the ('dual', 'primal') mesh (parallel/mesh.py); block
  (d, p) = A[d-rows, p-cols] is one of the port's single-device
  operators on the device of mesh cell (d, p): a `RoutedOp` (CSR with
  the spmv_csr kernel B2, or the tile plan with tiled_spmv B5) for the
  f32 kernel layout, else a `CsrOp` or `DenseOp`. The layout is chosen
  once, on the whole matrix, by linops.build_linop's rule.
- Vectors stay whole (replicated) on each process's home device. The
  JAX package shards every vector and lets GSPMD insert the
  collectives for products, norms, restarts and trust-region sorts;
  PyTorch has no GSPMD. With whole vectors the solvers, termination,
  iteration stats and trust regions run unchanged on the same
  iterates, and the matrix, which holds O(nnz) of the memory against
  the vectors' O(m + n), keeps its scaling.
- mv(x): every block computes A[d, p] x[p-cols] into a partial of m/D
  rows; y[d-rows] = sum over p of the partials, added in p order; the
  D row pieces are concatenated. rmv is the mirror image (n/P columns,
  added in d order). Under a process group each rank computes its own
  block's partial, one all_gather of the equal-sized partials follows
  (parallel.distributed.gather_in_rank_order), and every rank adds them
  in the same order. No all_reduce: it has no fixed order, and the
  iterates must be bitwise equal on every rank and to the
  single-process mesh of the same shape.
- Padding: the problem is padded to multiples of (D, P)
  (parallel.sharded.pad_problem), so every block has m/D rows and n/P
  columns. The JAX package pads its layout further, to whole strips,
  so that one compiled Pallas kernel serves every block; here each
  block builds its own work items or tile plan and launches its own
  kernel, so no more padding is needed (nor the JAX package's
  pad_plan_block, which pads each block's plan to the shared chunk and
  group counts).
- Row-sharded ingest (parallel/shard_ingest.py) builds the operator
  from the cells a process owns (build_sharded_op_from_blocks), cut
  from its loaded row blocks; no process holds the whole matrix.
- A block with no stored entry (common on a (4, 2) mesh of a small LP,
  or a padded strip) is None: its partial is exact zeros and it
  launches nothing.

The fused step kernels (B3, B4, B6, B7) are not on this path: the PDHG
step's fused gate takes a single-device RoutedOp only (models/pdhg.py),
as the JAX package's does, so a sharded operator runs plain mv / rmv.

Reference semantics: `problem.constraint_matrix * x` and `' * y`
(src/saddle_point.jl:1089,1106).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from . import routed
from .linops import CsrOp, DenseOp, build_csr_op, build_dense_op
from .routed import RoutedOp, build_routed_op, pattern_hash

BlockOp = Optional[Union[RoutedOp, CsrOp, DenseOp]]  # None: no block here


@dataclasses.dataclass(frozen=True)
class RoutedShardPlan:
    """Static plan for building a ShardedRoutedOp: the mesh and the
    blocks' layout. `row_multiple` / `col_multiple` are what the problem
    must be padded to (parallel.sharded.pad_problem) before the
    operator can be built: D and P, so that every block has m/D rows and
    n/P columns. (The JAX package asks for whole 128-row strips of every
    block as well, so that one compiled kernel serves them all; each of
    the port's blocks builds its own work items and launches its own
    kernel.)

    b2, hr, group_rows: the JAX package's strip geometry, kept for its
    callers; the port's blocks pick their own (routed.ITEM_ENTRIES, or
    the tile plan's pick_out_strip / pick_in_window / pick_group).
    tile_aligned: routed blocks as tile plans (B5) instead of CSR (B2)."""

    mesh: object  # parallel.mesh.SolverMesh
    b2: int = 1
    hr: int = 1
    group_rows: int = 32
    tile_aligned: bool = False

    @property
    def n_dual(self) -> int:
        return self.mesh.n_dual

    @property
    def n_primal(self) -> int:
        return self.mesh.n_primal

    @property
    def row_multiple(self) -> int:
        return self.n_dual

    @property
    def col_multiple(self) -> int:
        return self.n_primal


def plan_routed_shards(
    num_rows: int,
    num_cols: int,
    nnz: int,
    mesh,
    group_rows: int = 32,
) -> RoutedShardPlan:
    """The plan for a (num_rows, num_cols) matrix with `nnz` entries on
    `mesh`. The blocks' layout follows routed.DEFAULT_TILE_ALIGNED, the
    single-device operator's switch, read now."""
    del num_rows, num_cols, nnz  # each block sizes its own kernel
    return RoutedShardPlan(
        mesh=mesh, group_rows=group_rows,
        tile_aligned=routed.DEFAULT_TILE_ALIGNED,
    )


def _sum_in_order(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


@dataclasses.dataclass(frozen=True)
class ShardedRoutedOp:
    """Block-partitioned operator over a ('dual', 'primal') mesh
    (drop-in LinOp: mv / rmv / shape) on whole vectors that lie on the
    mesh's home device. `blocks[d][p]` is block (d, p) on its cell's
    device, None when it is empty or, under a process group, owned by
    another rank."""

    blocks: Tuple[Tuple[BlockOp, ...], ...]
    mesh: object  # parallel.mesh.SolverMesh
    num_rows: int
    num_cols: int
    format: str  # "routed", "sparse" or "dense": the blocks' layout
    tile_aligned: bool = False
    # sha256 of the whole matrix's csr sparsity pattern, or of the
    # cells' (blocks_fingerprint) when no process holds the whole matrix
    # (share_plan_with compares it)
    pattern_hash: str = ""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.num_cols)

    def _partial(self, d: int, p: int, v: torch.Tensor,
                 transpose: bool) -> torch.Tensor:
        """Block (d, p)'s product with its slice of `v`, on v's device."""
        row_len = self.num_rows // self.mesh.n_dual
        col_len = self.num_cols // self.mesh.n_primal
        out_len, in_len, piece = (
            (col_len, row_len, d) if transpose else (row_len, col_len, p)
        )
        block = self.blocks[d][p]
        if block is None:
            return torch.zeros(out_len, dtype=v.dtype, device=v.device)
        v_in = v[piece * in_len:(piece + 1) * in_len].to(
            self.mesh.devices[d][p]
        )
        out = block.rmv(v_in) if transpose else block.mv(v_in)
        return out.to(v.device)

    def _product(self, v: torch.Tensor, transpose: bool) -> torch.Tensor:
        n_dual, n_primal = self.mesh.shape
        cells = [(d, p) for d in range(n_dual) for p in range(n_primal)]
        if self.mesh.rank is None:
            parts = [self._partial(d, p, v, transpose) for d, p in cells]
        else:
            from ..parallel.distributed import gather_in_rank_order

            d, p = divmod(self.mesh.rank, n_primal)
            parts = gather_in_rank_order(
                self._partial(d, p, v, transpose)
            ).unbind(0)
        # parts[d * P + p]; add over the reduced axis in its order
        if transpose:
            pieces = [
                _sum_in_order([parts[d * n_primal + p]
                               for d in range(n_dual)])
                for p in range(n_primal)
            ]
        else:
            pieces = [
                _sum_in_order([parts[d * n_primal + p]
                               for p in range(n_primal)])
                for d in range(n_dual)
            ]
        return torch.cat(pieces)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x: the blocks' partials added over 'primal' in order."""
        return self._product(x, transpose=False)

    def rmv(self, y: torch.Tensor) -> torch.Tensor:
        """A' @ y: the blocks' partials added over 'dual' in order."""
        return self._product(y, transpose=True)


def _build_block(block: sp.csr_matrix, format: str, dtype, device,
                 tile_aligned: bool, donor: BlockOp) -> BlockOp:
    if block.nnz == 0:
        return None
    if format == "routed":
        return build_routed_op(block, device, tile_aligned=tile_aligned,
                               share_plan_with=donor)
    if format == "dense":
        return build_dense_op(block, dtype, device)
    return build_csr_op(block, dtype, device)


def build_sharded_routed_op(
    matrix: sp.spmatrix,
    plan: RoutedShardPlan,
    share_plan_with: "ShardedRoutedOp | None" = None,
    dtype=torch.float32,
    format: str = "routed",
) -> ShardedRoutedOp:
    """Builds the (D, P) grid of blocks, each on its mesh cell's device
    (under a process group, this rank's block only).

    Requires the matrix pre-padded so that the grid divides exactly:
    m % D == 0 and n % P == 0 (parallel.sharded.pad_problem with the
    plan's multiples).

    format: the blocks' layout, "routed" (f32 kernel operators, CSR or
    tile plan as `plan.tile_aligned` says), "sparse" (CsrOp) or "dense"
    (DenseOp), in `dtype`.
    share_plan_with: a routed ShardedRoutedOp over a matrix with the
    same sparsity pattern and plan; every block reuses its donor
    block's index tensors and transfers only the values. Raises
    ValueError on another mesh, layout or pattern."""
    csr = sp.csr_matrix(matrix, dtype=np.float64)
    csr.sum_duplicates()
    m, n = csr.shape
    mesh = plan.mesh
    n_dual, n_primal = mesh.shape
    if m % plan.row_multiple or n % plan.col_multiple:
        raise ValueError(
            f"matrix ({m}, {n}) must be padded to multiples of "
            f"({plan.row_multiple}, {plan.col_multiple}) for the "
            f"{n_dual}x{n_primal} mesh (see parallel.sharded.pad_problem)"
        )
    row_len, col_len = m // n_dual, n // n_primal
    cells = {}
    for d in range(n_dual):
        row_block = csr[d * row_len:(d + 1) * row_len]
        for p in range(n_primal):
            if mesh.owns(d, p):
                cells[d, p] = row_block[:, p * col_len:(p + 1) * col_len]
    return build_sharded_op_from_blocks(
        cells, plan, (m, n), share_plan_with=share_plan_with, dtype=dtype,
        format=format, fingerprint=pattern_hash(csr),
    )


def blocks_fingerprint(cells) -> str:
    """sha256 of the (d, p) cells' shapes and sparsity patterns, in
    cell order: the pattern hash of a matrix that no process holds
    whole."""
    h = hashlib.sha256()
    for key in sorted(cells):
        h.update(repr(key).encode())
        h.update(pattern_hash(cells[key]).encode())
    return h.hexdigest()


def build_sharded_op_from_blocks(
    cells,
    plan: RoutedShardPlan,
    shape: Tuple[int, int],
    share_plan_with: "ShardedRoutedOp | None" = None,
    dtype=torch.float32,
    format: str = "routed",
    fingerprint: Optional[str] = None,
) -> ShardedRoutedOp:
    """The (D, P) operator of an (m, n) `shape` matrix from the blocks
    this process owns: `cells` maps (d, p) to block (d, p), an
    (m/D, n/P) scipy matrix, for every cell the mesh lets this process
    own (parallel/shard_ingest.py cuts them from its loaded row blocks;
    no process holds the whole matrix). Each block is built on its
    cell's device as build_sharded_routed_op builds it.

    fingerprint: the operator's pattern_hash; default blocks_fingerprint
    of the cells (share_plan_with compares it).
    share_plan_with: a routed ShardedRoutedOp over the same cells'
    patterns and plan; every block reuses its donor block's index
    tensors (for example the unscaled copy of a rescaled operator)."""
    if format not in ("routed", "sparse", "dense"):
        raise ValueError(f"unknown block format {format!r}")
    if format == "routed" and dtype != torch.float32:
        raise ValueError("routed layout computes in f32")
    m, n = shape
    mesh = plan.mesh
    n_dual, n_primal = mesh.shape
    row_len, col_len = m // n_dual, n // n_primal
    canonical = {}
    for (d, p), block in cells.items():
        if not mesh.owns(d, p):
            raise ValueError(f"cell ({d}, {p}) belongs to another rank")
        block = sp.csr_matrix(block, dtype=np.float64)
        block.sum_duplicates()
        if block.shape != (row_len, col_len):
            raise ValueError(
                f"block ({d}, {p}) has shape {block.shape}, want "
                f"({row_len}, {col_len}) on the {n_dual}x{n_primal} mesh"
            )
        canonical[d, p] = block
    if fingerprint is None:
        fingerprint = blocks_fingerprint(canonical)
    donor = share_plan_with
    if donor is not None and format == "routed":
        if (
            donor.mesh != mesh
            or donor.format != "routed"
            or donor.tile_aligned != plan.tile_aligned
            or donor.shape != (m, n)
            or donor.pattern_hash != fingerprint
        ):
            raise ValueError(
                "share_plan_with requires an identical block plan"
            )
    else:
        donor = None
    blocks = tuple(
        tuple(
            None if (d, p) not in canonical else _build_block(
                canonical[d, p], format, dtype, mesh.devices[d][p],
                plan.tile_aligned, donor and donor.blocks[d][p],
            )
            for p in range(n_primal)
        )
        for d in range(n_dual)
    )
    return ShardedRoutedOp(
        blocks=blocks,
        mesh=mesh,
        num_rows=m,
        num_cols=n,
        format=format,
        tile_aligned=plan.tile_aligned if format == "routed" else False,
        pattern_hash=fingerprint,
    )


def agreed_seconds(op, seconds: float) -> float:
    """The elapsed-time reading the solvers feed their time limit: under
    a process group rank 0's, on every rank (each rank reads its own
    clock, and a time limit must stop all ranks at the same
    evaluation); else `seconds`."""
    if isinstance(op, ShardedRoutedOp) and op.mesh.rank is not None:
        from ..parallel.distributed import broadcast_seconds

        return broadcast_seconds(seconds, op.mesh.home_device)
    return seconds

