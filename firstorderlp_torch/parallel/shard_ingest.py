"""Row-sharded ingest: each process loads and builds only its own row
blocks of the constraint matrix, the port's counterpart of the JAX
package's ``parallel/shard_ingest.py``.

The other ingest paths (models.pdhg.prepare_problem, parallel.sharded)
hold the whole problem on every process before they cut it. For the
1e6-1e8-nnz instances of multi-process solves that whole-problem ingest
is both the wall-clock bottleneck and the host-memory ceiling. Here no
process ever holds the whole matrix:

1. A RowShardSpec describes the problem by O(m + n) metadata and a
   `row_loader(lo, hi)` that returns the entries of rows [lo, hi) only
   (mps_row_shard_spec streams them out of an MPS file,
   problem_row_shard_spec slices an in-memory problem).
2. Each process loads its row blocks: every block d in a single
   process; under a process group rank (d, p) loads row block d. A
   block is a canonical CSR of (m'/D, n') with block-local rows on the
   row block's device (cell (d, 0)'s, or the rank's own).
3. The rescaling (Ruiz l_inf, the optional l2 and Pock-Chambolle
   steps) runs on the devices on each block's entries
   (sharded_rescale). Row statistics are the block's own; the blocks'
   column statistics are folded in d order
   (parallel.distributed.reduce_row_blocks). Maxima are scatter maxima,
   exact in any order. Sums are the block's own product with a vector
   of ones: B2 (spmv_csr) with the block's values swapped in on the f32
   kernel layout, the CsrOp product (a segmented sum) otherwise. No
   floating-point atomics, so every rank and the single-process mesh of
   the same shape get the same bits.
4. The scaled values come back to the host (O(local nnz)); each owned
   (d, p) cell is cut from its row block and built on its device
   (ops/routed_sharded.build_sharded_op_from_blocks: B2 or B5 blocks in
   f32, CsrOp blocks in the solve dtype); the unscaled operator shares
   the scaled one's index tensors.
5. models/pdhg.optimize runs on the prepared bundle, every vector whole
   on the home device (parallel/sharded.py).

What differs from the JAX package, and why:
- No common block shape. The JAX package pads every block's entries to
  the largest block's count and every block's Pallas plan to shared
  chunk and group counts (its routed_sharded.pad_plan_block), so that
  one compiled program serves every block. Each of the port's blocks
  launches its own kernel, so each keeps its own entries and plan. No
  pad entry exists, so none can enter a sum: the JAX package's pads
  (value 0 at row 0, column 0) add 0 ** 0 = 1 to row 0's and column 0's
  Pock-Chambolle sums when alpha is 2 (or 0).
- The JAX package's row-block ELL operator (RowBlockEllOp) is here a
  (D, 1) ShardedRoutedOp of CsrOp blocks: the port replaced the ELL
  layout.

Reference semantics: qps_reader_to_standard_form (row types, sign
flips, equalities first) and rescale_problem
(quadratic_programming_io.jl:147-197, preprocess.jl:631-687).

Scope, as the JAX package's: LP only, PDHG with the adaptive step rule,
no RANGES (a two-sided row adds a slack column, which a row-range loader
cannot number without every row; convert such instances through
qps_reader_to_standard_form and io.mps_writer first). Two layouts:
matrix_format="routed" (f32 kernel blocks, on 1-D and 2-D meshes,
host_sharded_routed_optimize) and any other (CsrOp blocks in the solve
dtype, f64 included, rows only).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..io.mps import MpsParseError, _fixed_fields, _lines
from ..ops import routed
from ..ops.linops import CsrHalf

# ---------------------------------------------------------------------------
# Problem spec: global metadata + a per-row-range loader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowShardSpec:
    """A problem described by O(m + n) metadata plus a row-range loader.

    `row_loader(lo, hi)` returns the COO triplet of rows [lo, hi) in
    STANDARD FORM row order (equalities first) as
    (rows_global, cols, vals) int64/int64/float64 arrays - it is called
    once per locally-owned row block and must not materialize rows
    outside the range (that is the whole point).
    """

    num_constraints: int
    num_variables: int
    num_equalities: int
    objective_vector: np.ndarray  # (n,)
    objective_constant: float
    variable_lower_bound: np.ndarray  # (n,)
    variable_upper_bound: np.ndarray  # (n,)
    right_hand_side: np.ndarray  # (m,) standard-form order
    row_loader: Callable[[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]]
    # total constraint entries, when the loader can count them cheaply
    # (pass 1 reads every COLUMNS line anyway); the ingest checks that
    # its row blocks loaded exactly these. None: not checked.
    nnz: Optional[int] = None


def mps_row_shard_spec(filename: str, fixed_format: bool = False) -> RowShardSpec:
    """Streaming row-sharded reader for one-sided MPS files.

    Pass 1 (here) builds only O(m + n) metadata: row names/types, column
    order, c, bounds, rhs - the COLUMNS matrix entries are NOT stored.
    The returned spec's row_loader re-scans the COLUMNS section keeping
    only entries whose standard-form row index falls in [lo, hi), so a
    process ingesting 1/P of the rows holds 1/P of the nonzeros.

    Standard-form conventions mirror io.standard_form.transform_to_
    standard_form (reference quadratic_programming_io.jl:34-87): L rows
    are sign-flipped to >=, equalities are permuted first (stable).
    RANGES (two-sided rows, which add slack columns) and quadratic
    sections are rejected - convert those instances through
    qps_reader_to_standard_form + io.mps_writer first.
    """
    obj_row: Optional[str] = None
    row_types: dict = {}
    row_order: list = []
    col_index: dict = {}
    c_entries: dict = {}
    rhs: dict = {}
    obj_rhs = 0.0
    bounds: list = []
    section = None
    nnz_count = 0

    for line in _lines(filename):
        if not line[0].isspace():
            head = line.split()[0].upper()
            if head == "ENDATA":
                break
            if head in ("RANGES",):
                # peek: any data line in RANGES is a two-sided row
                section = "RANGES"
                continue
            if head in ("QUADOBJ", "QMATRIX", "QSECTION"):
                raise MpsParseError(
                    "mps_row_shard_spec is LP-only; use "
                    "qps_reader_to_standard_form for QPs"
                )
            section = head
            continue
        fields = _fixed_fields(line) if fixed_format else line.split()
        if section == "RANGES":
            raise MpsParseError(
                "mps_row_shard_spec does not support RANGES (two-sided "
                "rows add slack columns); convert through "
                "qps_reader_to_standard_form + io.mps_writer first"
            )
        if section == "ROWS":
            rtype = fields[0].upper()
            rname = fields[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                continue
            if rtype not in ("E", "L", "G"):
                raise MpsParseError(f"Unknown row type {rtype!r}")
            if rname in row_types:
                raise MpsParseError(f"Duplicate row name {rname!r}")
            row_types[rname] = rtype
            row_order.append(rname)
        elif section == "COLUMNS":
            if "'MARKER'" in fields:
                continue
            colname = fields[0]
            if colname not in col_index:
                col_index[colname] = len(col_index)
            col = col_index[colname]
            pairs = fields[1:]
            for i in range(0, len(pairs), 2):
                if pairs[i] == obj_row:
                    c_entries[col] = c_entries.get(col, 0.0) + float(
                        pairs[i + 1]
                    )
                else:
                    nnz_count += 1
                # matrix entries are intentionally NOT stored here
        elif section == "RHS":
            pairs = fields[1:]
            for i in range(0, len(pairs), 2):
                rname, sval = pairs[i], pairs[i + 1]
                if rname == obj_row:
                    obj_rhs = float(sval)
                elif rname in row_types:
                    rhs[rname] = float(sval)
                else:
                    raise MpsParseError(f"Unknown row {rname!r} in RHS")
        elif section == "BOUNDS":
            btype = fields[0].upper()
            if btype in ("FR", "MI", "PL", "BV"):
                bounds.append((btype, fields[2], None))
            else:
                bounds.append((btype, fields[2], float(fields[3])))
        elif section in ("NAME", "OBJSENSE"):
            continue

    m = len(row_order)
    n = len(col_index)

    # standard-form row index: equalities first, both classes stable
    # (mirrors transform_to_standard_form's new_row_to_old)
    std_index = {}
    eq_count = 0
    for rname in row_order:
        if row_types[rname] == "E":
            std_index[rname] = eq_count
            eq_count += 1
    ineq_pos = eq_count
    for rname in row_order:
        if row_types[rname] != "E":
            std_index[rname] = ineq_pos
            ineq_pos += 1

    sign = {
        rname: (-1.0 if row_types[rname] == "L" else 1.0)
        for rname in row_order
    }
    b = np.zeros(m)
    for rname in row_order:
        b[std_index[rname]] = sign[rname] * rhs.get(rname, 0.0)

    c = np.zeros(n)
    for col, val in c_entries.items():
        c[col] = val
    lvar = np.zeros(n)
    uvar = np.full(n, np.inf)
    lower_set = np.zeros(n, dtype=bool)
    for btype, colname, value in bounds:
        if colname not in col_index:
            raise MpsParseError(f"Unknown column {colname!r} in BOUNDS")
        j = col_index[colname]
        if btype in ("LO", "LI"):
            lvar[j] = value
            lower_set[j] = True
        elif btype in ("UP", "UI"):
            uvar[j] = value
            if value < 0 and not lower_set[j]:
                lvar[j] = -np.inf
        elif btype == "FX":
            lvar[j] = value
            uvar[j] = value
            lower_set[j] = True
        elif btype == "FR":
            lvar[j], uvar[j] = -np.inf, np.inf
        elif btype == "MI":
            lvar[j] = -np.inf
            lower_set[j] = True
        elif btype == "PL":
            uvar[j] = np.inf
        elif btype == "BV":
            lvar[j], uvar[j] = 0.0, 1.0
            lower_set[j] = True
        else:
            raise MpsParseError(f"Unknown bound type {btype!r}")

    def row_loader(lo: int, hi: int):
        rows_l, cols_l, vals_l = [], [], []
        sec = None
        for line in _lines(filename):
            if not line[0].isspace():
                head = line.split()[0].upper()
                if head == "ENDATA" or (
                    sec == "COLUMNS" and head != "COLUMNS"
                ):
                    break
                sec = head
                continue
            if sec != "COLUMNS":
                continue
            fields = _fixed_fields(line) if fixed_format else line.split()
            if "'MARKER'" in fields:
                continue
            col = col_index[fields[0]]
            pairs = fields[1:]
            for i in range(0, len(pairs), 2):
                rname = pairs[i]
                if rname == obj_row:
                    continue
                r = std_index[rname]
                if lo <= r < hi:
                    rows_l.append(r)
                    cols_l.append(col)
                    vals_l.append(sign[rname] * float(pairs[i + 1]))
        return (
            np.asarray(rows_l, dtype=np.int64),
            np.asarray(cols_l, dtype=np.int64),
            np.asarray(vals_l, dtype=np.float64),
        )

    return RowShardSpec(
        num_constraints=m,
        num_variables=n,
        num_equalities=eq_count,
        objective_vector=c,
        objective_constant=-obj_rhs,
        variable_lower_bound=lvar,
        variable_upper_bound=uvar,
        right_hand_side=b,
        row_loader=row_loader,
        nnz=nnz_count,
    )


def problem_row_shard_spec(problem) -> RowShardSpec:
    """RowShardSpec over an in-memory standard-form problem (generator
    output). The loader slices a CSR copy per block - memory is NOT
    reduced (use mps_row_shard_spec or a custom loader for that); this
    adapter exists for tests and for generator fleets where each process
    generates its own rows."""
    csr = sp.csr_matrix(problem.constraint_matrix)
    csr.sum_duplicates()

    def row_loader(lo, hi):
        block = csr[lo:hi].tocoo()
        return (
            block.row.astype(np.int64) + lo,
            block.col.astype(np.int64),
            block.data.astype(np.float64),
        )

    return RowShardSpec(
        num_constraints=problem.num_constraints,
        num_variables=problem.num_variables,
        num_equalities=problem.num_equalities,
        objective_vector=np.asarray(problem.objective_vector, np.float64),
        objective_constant=float(problem.objective_constant),
        variable_lower_bound=np.asarray(
            problem.variable_lower_bound, np.float64
        ),
        variable_upper_bound=np.asarray(
            problem.variable_upper_bound, np.float64
        ),
        right_hand_side=np.asarray(problem.right_hand_side, np.float64),
        row_loader=row_loader,
        nnz=int(csr.nnz),
    )


# ---------------------------------------------------------------------------
# Row blocks and the on-device rescale
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """Row block d as one process loaded it: rows [d m_b, (d + 1) m_b)
    of the padded (m', n') matrix, block-local, on `device`.

    `fwd` and `bwd` hold the block's pattern and its transpose's, in the
    layout whose product gives the rescale's sums: CsrKernelMatrix (B2)
    on the f32 kernel layout, else CsrHalf. Their values are the
    original ones; a sum swaps other values in."""

    d: int
    csr: sp.csr_matrix  # (m_b, n') canonical, the original f64 values
    loaded: int  # entries the loader returned (duplicates not yet added)
    device: torch.device
    rows: torch.Tensor  # (nnz,) int64, each entry's block-local row
    cols: torch.Tensor  # (nnz,) int64
    perm_t: torch.Tensor  # (nnz,) int64: entry k of A' is entry perm_t[k]
    fwd: object
    bwd: object

    @property
    def nnz(self) -> int:
        return int(self.csr.nnz)


def load_row_block(spec: RowShardSpec, d: int, block_rows: int,
                   num_cols: int, device, layout: str,
                   dtype=torch.float32) -> RowBlock:
    """Loads row block d (rows [d block_rows, (d + 1) block_rows), those
    past the spec's rows empty) through the spec's row_loader and puts
    its pattern on `device` in `layout` ("routed": B2's CSR, f32; else
    CsrOp's halves in `dtype`)."""
    m = spec.num_constraints
    lo, hi = d * block_rows, min((d + 1) * block_rows, m)
    if lo < hi:
        rows_g, cols_g, vals = spec.row_loader(lo, hi)
    else:
        rows_g = cols_g = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float64)
    csr = sp.csr_matrix(
        (np.asarray(vals, np.float64),
         (np.asarray(rows_g, np.int64) - lo, np.asarray(cols_g, np.int64))),
        shape=(block_rows, num_cols),
    )
    csr.sum_duplicates()
    ids = sp.csr_matrix(
        (np.arange(1, csr.nnz + 1, dtype=np.float64), csr.indices,
         csr.indptr), shape=csr.shape,
    )
    ids_t = sp.csr_matrix(ids.T)
    ids_t.sort_indices()
    perm_t = ids_t.data.astype(np.int64) - 1
    csr_t = sp.csr_matrix(
        (csr.data[perm_t], ids_t.indices, ids_t.indptr), shape=ids_t.shape
    )
    if layout == "routed":
        fwd = routed.build_csr_kernel_matrix(csr, device, "A")
        bwd = routed.build_csr_kernel_matrix(csr_t, device, "AT")
    else:
        def half(mat):
            return CsrHalf(
                indptr=torch.as_tensor(mat.indptr.astype(np.int64),
                                       device=device),
                indices=torch.as_tensor(mat.indices.astype(np.int64),
                                        device=device),
                vals=torch.as_tensor(mat.data, device=device).to(dtype),
            )

        fwd, bwd = half(csr), half(csr_t)
    return RowBlock(
        d=d, csr=csr, loaded=int(len(vals)), device=torch.device(device),
        rows=torch.as_tensor(
            np.repeat(np.arange(block_rows, dtype=np.int64),
                      np.diff(csr.indptr)), device=device),
        cols=torch.as_tensor(csr.indices.astype(np.int64), device=device),
        perm_t=torch.as_tensor(perm_t, device=device),
        fwd=fwd, bwd=bwd,
    )


def _sums(block: RowBlock, values: torch.Tensor,
          transpose: bool) -> torch.Tensor:
    """Row sums (or, with `transpose`, column sums) of the block holding
    `values` in its entry order: the product of its pattern (or its
    transpose's) with a vector of ones, added in a fixed order."""
    rows, cols = block.csr.shape
    if block.nnz == 0:
        return torch.zeros(cols if transpose else rows, dtype=values.dtype,
                           device=values.device)
    half = block.bwd if transpose else block.fwd
    if transpose:
        values = values[block.perm_t]
    ones = torch.ones(rows if transpose else cols, dtype=values.dtype,
                      device=values.device)
    if isinstance(half, CsrHalf):
        return CsrHalf(half.indptr, half.indices, values).mv(ones)
    return routed.spmv_csr(
        dataclasses.replace(half, vals=values.contiguous()), ones)


def _seg_max(values: torch.Tensor, index: torch.Tensor,
             num: int) -> torch.Tensor:
    """(num,) max of `values` (>= 0) over the entries with each index; 0
    where there is none. Max is exact in any order."""
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, "amax")


class ShardedRescale(NamedTuple):
    """The rescaled problem, as sharded_rescale returns it: the blocks'
    scaled values on their devices, everything else whole on the home
    device in the value dtype."""

    values: Dict[int, torch.Tensor]  # row block d's, in its entry order
    constraint_rescaling: torch.Tensor  # (m',)
    variable_rescaling: torch.Tensor  # (n',)
    right_hand_side: torch.Tensor  # (m',) scaled b
    objective_vector: torch.Tensor  # (n',) scaled c
    variable_lower_bound: torch.Tensor  # (n',) scaled
    variable_upper_bound: torch.Tensor
    step_size: torch.Tensor  # 0-d, 1 / max |scaled A|
    norm_c: torch.Tensor  # 0-d, ||scaled c||
    norm_b: torch.Tensor  # 0-d, ||scaled b||
    linf_b: torch.Tensor  # 0-d, max |b| of the ORIGINAL b (qp cache)
    l2_b: torch.Tensor  # 0-d, ||b|| of the ORIGINAL b


def sharded_rescale(blocks: Dict[int, RowBlock], vectors: Dict[str, torch.Tensor],
                    mesh, ruiz_iterations: int, l2_norm_rescaling: bool,
                    pock_chambolle_alpha: Optional[float],
                    dtype=torch.float32) -> ShardedRescale:
    """Rescales the row-blocked problem on the devices in `dtype` (the
    JAX package's _rescale_coo_core and _sharded_rescale_coo,
    shard_ingest.py:470-628 there; reference preprocess.jl:626-687):
    `ruiz_iterations` l_inf Ruiz steps, the optional l2 step and the
    optional Pock-Chambolle step, each E^-1 A D^-1.

    blocks: this process's row blocks (load_row_block), all of the mesh's
    in a single process. vectors: "b" (m',), "c", "lo", "hi" (n',),
    whole on the mesh's home device in `dtype`. Row statistics are each
    block's own; column statistics are folded over the blocks in d order
    (reduce_row_blocks), sums through the blocks' own products (_sums),
    maxima as scatter maxima."""
    from .distributed import concat_row_blocks, reduce_row_blocks

    home = mesh.home_device
    n = int(vectors["c"].shape[0])
    v = {d: torch.as_tensor(blk.csr.data, device=blk.device).to(dtype)
         for d, blk in blocks.items()}
    cum_con = {d: torch.ones(blk.csr.shape[0], dtype=dtype, device=blk.device)
               for d, blk in blocks.items()}
    cum_var = torch.ones(n, dtype=dtype, device=home)

    def fix(s):
        return torch.where(s > 0, s, 1.0)

    def columns(stat, op):
        return reduce_row_blocks({d: stat(d) for d in blocks}, mesh, op)

    def apply(con, var):
        nonlocal cum_var
        for d, blk in blocks.items():
            # (E^-1 A) D^-1: rows first, then columns
            v[d] = v[d] / con[d][blk.rows] / var.to(blk.device)[blk.cols]
            cum_con[d] = cum_con[d] * con[d]
        cum_var = cum_var * var

    for _ in range(ruiz_iterations):
        con = {d: fix(torch.sqrt(_seg_max(v[d].abs(), blk.rows,
                                          blk.csr.shape[0])))
               for d, blk in blocks.items()}
        var = fix(torch.sqrt(columns(
            lambda d: _seg_max(v[d].abs(), blocks[d].cols, n), "max")))
        apply(con, var)
    if l2_norm_rescaling:
        con = {d: fix(torch.sqrt(torch.sqrt(_sums(blk, v[d] * v[d],
                                                  False))))
               for d, blk in blocks.items()}
        var = fix(torch.sqrt(torch.sqrt(columns(
            lambda d: _sums(blocks[d], v[d] * v[d], True), "sum"))))
        apply(con, var)
    if pock_chambolle_alpha is not None:
        alpha = float(pock_chambolle_alpha)
        absv = {d: v[d].abs() for d in blocks}
        var = fix(torch.sqrt(columns(
            lambda d: _sums(blocks[d], absv[d] ** (2.0 - alpha), True),
            "sum")))
        con = {d: fix(torch.sqrt(_sums(blk, absv[d] ** alpha, False)))
               for d, blk in blocks.items()}
        apply(con, var)

    cum_con_all = concat_row_blocks(cum_con, mesh)
    b, c = vectors["b"], vectors["c"]
    b_scaled = b / cum_con_all
    c_scaled = c / cum_var
    inf_norm = reduce_row_blocks(
        {d: (v[d].abs().max() if v[d].numel()
             else torch.zeros((), dtype=dtype, device=v[d].device))[None]
         for d in blocks}, mesh, "max")[0]
    zero = torch.zeros((), dtype=dtype, device=home)
    return ShardedRescale(
        values=v,
        constraint_rescaling=cum_con_all,
        variable_rescaling=cum_var,
        right_hand_side=b_scaled,
        objective_vector=c_scaled,
        variable_lower_bound=vectors["lo"] * cum_var,
        variable_upper_bound=vectors["hi"] * cum_var,
        step_size=torch.where(inf_norm > 0, 1.0 / inf_norm, 1.0),
        norm_c=torch.linalg.norm(c_scaled),
        norm_b=torch.linalg.norm(b_scaled),
        linf_b=b.abs().max() if b.numel() else zero,
        l2_b=torch.linalg.norm(b),
    )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_supported(params) -> None:
    from ..models import pdhg

    if not isinstance(params, pdhg.PdhgParameters):
        raise TypeError("host-sharded ingest solves with PDHG "
                        "(PdhgParameters)")
    if not isinstance(params.step_size_policy_params,
                      pdhg.AdaptiveStepsizeParams):
        raise ValueError(
            "host-sharded ingest requires the adaptive step rule"
        )
    if params.checkpoint_path or params.resume_from_checkpoint:
        raise ValueError(
            "checkpointing is not supported with host-sharded ingest"
        )
    if params.verbosity >= 7:
        raise ValueError(
            "verbosity >= 7 requires the full problem on every host"
        )
    if params.bound_width_rescaling:
        raise ValueError(
            "bound_width_rescaling is not supported with host-sharded "
            "ingest"
        )


def _padded(vec, size: int, dtype, device) -> torch.Tensor:
    out = np.zeros(size, np.float64)
    out[:len(vec)] = vec
    return torch.as_tensor(out, device=device).to(dtype)


def _sync(mesh) -> None:
    for device in {dev for row in mesh.devices for dev in row}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def host_sharded_optimize(params, spec: RowShardSpec, mesh,
                          report: Optional[dict] = None):
    """Multi-process solve with row-sharded ingest: this process's row
    blocks -> on-device rescale -> the block-partitioned operator ->
    PDHG (see the module docstring).

    Every process calls this with the same spec and parameters; only the
    row blocks this process's cells own are loaded. `mesh`: a
    parallel.mesh.solver_mesh (its devices; CUDA by default, raising
    without a GPU), or under a process group
    parallel.distributed.global_solver_mesh. matrix_format="routed"
    goes to host_sharded_routed_optimize; any other builds CsrOp blocks
    in the solve dtype and partitions rows only (an (D, 1) mesh).

    report: a dict to fill with "load_seconds", "rescale_seconds",
    "build_seconds", "solve_seconds", "block_nnz" (the entries of each
    row block, from every process), "loaded_nnz" (this process's),
    "rescale_sums" (the B2 launches of the rescale's fixed-order sums,
    by orientation) and "nonempty_cells" (the blocks this process built
    that hold an entry: each product launches one kernel on each)."""
    _check_supported(params)
    if params.matrix_format == "routed":
        return host_sharded_routed_optimize(params, spec, mesh, report)
    if mesh.n_primal != 1:
        raise ValueError(
            "the row-block layout partitions rows only; for a 2-D "
            "('dual', 'primal') mesh use matrix_format='routed' "
            "(host_sharded_routed_optimize) or parallel.sharded_optimize"
        )
    return _host_sharded_solve(params, spec, mesh, "sparse", report)


def host_sharded_routed_optimize(params, spec: RowShardSpec, mesh,
                                 report: Optional[dict] = None):
    """host_sharded_optimize on the f32 kernel layout: every (d, p) cell
    of a 1-D or 2-D mesh is a B2 (CSR) or B5 (tile plan, as
    routed.DEFAULT_TILE_ALIGNED says) operator, and the rescale's sums
    run through B2."""
    if params.dtype != "float32":
        raise ValueError("the routed layout computes in f32")
    _check_supported(params)
    return _host_sharded_solve(params, spec, mesh, "routed", report)


def _host_sharded_solve(params, spec: RowShardSpec, mesh, layout: str,
                        report: Optional[dict]):
    from ..models import pdhg
    from ..models.common import torch_dtype
    from ..ops.device_problem import DeviceQp, DeviceQpCache, DeviceScaledQp
    from ..ops.routed_sharded import (
        build_sharded_op_from_blocks,
        plan_routed_shards,
    )
    from ..problem import ScaledQpProblem
    from ..saddle_point import SaddlePointOutput, fetch_global
    from .distributed import allmax_int

    report = {} if report is None else report
    dtype = torch_dtype(params.dtype)
    m, n = spec.num_constraints, spec.num_variables
    n_dual, n_primal = mesh.shape
    plan = plan_routed_shards(m, n, spec.nnz or 0, mesh)
    m_pad = max(-(-m // plan.row_multiple) * plan.row_multiple,
                plan.row_multiple)
    n_pad = max(-(-n // plan.col_multiple) * plan.col_multiple,
                plan.col_multiple)
    m_b, n_loc = m_pad // n_dual, n_pad // n_primal
    home = mesh.home_device
    owned = [(d, p) for d in range(n_dual) for p in range(n_primal)
             if mesh.owns(d, p)]

    # ---- host: load this process's row blocks ----
    t0 = time.perf_counter()
    blocks = {}
    for d in sorted({d for d, _ in owned}):
        device = home if mesh.rank is not None else mesh.devices[d][0]
        blocks[d] = load_row_block(spec, d, m_b, n_pad, device, layout,
                                   dtype)
    counts = np.zeros(n_dual, np.int64)
    for d, blk in blocks.items():
        counts[d] = blk.loaded
    block_nnz = allmax_int(counts, home)
    if spec.nnz is not None and int(block_nnz.sum()) != spec.nnz:
        raise ValueError(
            f"the row blocks hold {int(block_nnz.sum())} entries, the spec "
            f"{spec.nnz}"
        )
    vectors = {
        "b": _padded(spec.right_hand_side, m_pad, dtype, home),
        "c": _padded(spec.objective_vector, n_pad, dtype, home),
        "lo": _padded(spec.variable_lower_bound, n_pad, dtype, home),
        "hi": _padded(spec.variable_upper_bound, n_pad, dtype, home),
    }
    _sync(mesh)
    report.update(load_seconds=time.perf_counter() - t0,
                  block_nnz=[int(k) for k in block_nnz],
                  loaded_nnz=int(sum(b.loaded for b in blocks.values())))

    # ---- devices: the rescale ----
    t0 = time.perf_counter()
    before = (routed.LAUNCHES["spmv_csr:A"], routed.LAUNCHES["spmv_csr:AT"])
    scaled = sharded_rescale(
        blocks, vectors, mesh, int(params.l_inf_ruiz_iterations),
        bool(params.l2_norm_rescaling), params.pock_chambolle_alpha, dtype,
    )
    host_values = {d: v.cpu().numpy().astype(np.float64)
                   for d, v in scaled.values.items()}
    report.update(
        rescale_seconds=time.perf_counter() - t0,
        rescale_sums={
            "spmv_csr:A": routed.LAUNCHES["spmv_csr:A"] - before[0],
            "spmv_csr:AT": routed.LAUNCHES["spmv_csr:AT"] - before[1],
        },
    )

    # ---- host + devices: the owned (d, p) cells ----
    t0 = time.perf_counter()
    cells_scaled, cells_orig = {}, {}
    for d, p in owned:
        csr = blocks[d].csr
        cols = slice(p * n_loc, (p + 1) * n_loc)
        cells_orig[d, p] = csr[:, cols]
        cells_scaled[d, p] = sp.csr_matrix(
            (host_values[d], csr.indices, csr.indptr), shape=csr.shape
        )[:, cols]
    del host_values
    op_scaled = build_sharded_op_from_blocks(
        cells_scaled, plan, (m_pad, n_pad), dtype=dtype, format=layout)
    op_orig = build_sharded_op_from_blocks(
        cells_orig, plan, (m_pad, n_pad), share_plan_with=op_scaled,
        dtype=dtype, format=layout)
    del cells_scaled, cells_orig
    report["nonempty_cells"] = sum(
        block is not None for row in op_scaled.blocks for block in row)

    is_eq = torch.arange(m_pad, device=home) < spec.num_equalities

    def device_qp(op, c, b, lo, hi):
        return DeviceQp(
            variable_lower_bound=lo,
            variable_upper_bound=hi,
            objective_vector=c,
            objective_constant=torch.tensor(
                float(spec.objective_constant), dtype=dtype, device=home),
            right_hand_side=b,
            is_equality=is_eq,
            is_equality_f32=is_eq.to(torch.float32),
            constraint_matrix=op,
            objective_matrix=None,
        )

    c, b = vectors["c"], vectors["b"]
    bundle = DeviceScaledQp(
        scaled=device_qp(op_scaled, scaled.objective_vector,
                         scaled.right_hand_side,
                         scaled.variable_lower_bound,
                         scaled.variable_upper_bound),
        original=device_qp(op_orig, c, b, vectors["lo"], vectors["hi"]),
        constraint_rescaling=scaled.constraint_rescaling,
        variable_rescaling=scaled.variable_rescaling,
        qp_cache=DeviceQpCache(
            l_inf_norm_primal_linear_objective=c.abs().max(),
            l_inf_norm_primal_right_hand_side=scaled.linf_b,
            l2_norm_primal_linear_objective=torch.linalg.norm(c),
            l2_norm_primal_right_hand_side=scaled.l2_b,
        ),
    )
    norm_c, norm_b = scaled.norm_c, scaled.norm_b
    if params.scale_invariant_initial_primal_weight:
        primal_weight = torch.where(
            (norm_c > 0) & (norm_b > 0),
            params.primal_importance * norm_c
            / torch.where(norm_b > 0, norm_b, 1.0),
            params.primal_importance,
        ).to(dtype)
    else:
        primal_weight = torch.full((), float(params.primal_importance),
                                   dtype=dtype, device=home)
    state = dataclasses.replace(
        pdhg._initial_state(bundle, dtype, home),
        step_size=scaled.step_size.to(dtype),
        primal_weight=primal_weight,
        cumulative_kkt_passes=torch.full((), 0.5, dtype=torch.float64,
                                         device=home),
    )
    scaled_problem = ScaledQpProblem(
        original_qp=None,
        scaled_qp=None,
        constraint_rescaling=np.concatenate([
            fetch_global(scaled.constraint_rescaling)[:m].astype(np.float64),
            np.ones(m_pad - m)]),
        variable_rescaling=np.concatenate([
            fetch_global(scaled.variable_rescaling)[:n].astype(np.float64),
            np.ones(n_pad - n)]),
    )
    _sync(mesh)
    report["build_seconds"] = time.perf_counter() - t0

    # ---- the solve ----
    t0 = time.perf_counter()
    output = pdhg.optimize(params, None, prepared=pdhg.PreparedProblem(
        scaled_problem=scaled_problem, bundle=bundle, initial_state=state,
        device=home,
    ))
    report["solve_seconds"] = time.perf_counter() - t0
    return SaddlePointOutput(
        primal_solution=np.asarray(output.primal_solution)[:n],
        dual_solution=np.asarray(output.dual_solution)[:m],
        termination_reason=output.termination_reason,
        termination_string=output.termination_string,
        iteration_count=output.iteration_count,
        iteration_stats=output.iteration_stats,
    )
