"""Free-format MPS writer for standard-form problems.

Lets the instance generators emit .mps(.gz) files consumable by the
port's CLI, the JAX package's and the reference solver (the reference
generates its benchmark instances through JuMP's MPS writer; this is the
equivalent egress path). A copy of the JAX package's writer: both write
the same bytes for the same problem (tests/test_torch_io_native.py)."""

from __future__ import annotations

import gzip

import numpy as np
import scipy.sparse as sp

from ..problem import QuadraticProgrammingProblem


def write_mps(problem: QuadraticProgrammingProblem, filename: str,
              name: str = "problem") -> None:
    lines = []
    lines.append(f"NAME {name}")
    lines.append("ROWS")
    lines.append(" N OBJ")
    m = problem.num_constraints
    for i in range(m):
        rtype = "E" if i < problem.num_equalities else "G"
        lines.append(f" {rtype} R{i}")

    lines.append("COLUMNS")
    csc = sp.csc_matrix(problem.constraint_matrix)
    c = problem.objective_vector
    for j in range(problem.num_variables):
        col = f"X{j}"
        if c[j] != 0.0:
            lines.append(f" {col} OBJ {float(c[j])!r}")
        for idx in range(csc.indptr[j], csc.indptr[j + 1]):
            lines.append(f" {col} R{csc.indices[idx]} {float(csc.data[idx])!r}")
        if (
            c[j] == 0.0
            and csc.indptr[j] == csc.indptr[j + 1]
        ):
            # Empty column: mention it with a zero objective coefficient so
            # readers still create the variable.
            lines.append(f" {col} OBJ 0.0")

    lines.append("RHS")
    if problem.objective_constant != 0.0:
        lines.append(f" RHS OBJ {float(-problem.objective_constant)!r}")
    for i in range(m):
        if problem.right_hand_side[i] != 0.0:
            lines.append(f" RHS R{i} {float(problem.right_hand_side[i])!r}")

    lines.append("BOUNDS")
    lower = problem.variable_lower_bound
    upper = problem.variable_upper_bound
    for j in range(problem.num_variables):
        lo, up = lower[j], upper[j]
        col = f"X{j}"
        if lo == up:
            lines.append(f" FX BND {col} {float(lo)!r}")
            continue
        if np.isneginf(lo) and np.isposinf(up):
            lines.append(f" FR BND {col}")
            continue
        if np.isneginf(lo):
            lines.append(f" MI BND {col}")
        elif lo != 0.0:
            lines.append(f" LO BND {col} {float(lo)!r}")
        if not np.isposinf(up):
            lines.append(f" UP BND {col} {float(up)!r}")

    if problem.objective_matrix.nnz > 0:
        lines.append("QUADOBJ")
        coo = sp.coo_matrix(sp.tril(problem.objective_matrix))
        for i, j, v in zip(coo.row, coo.col, coo.data):
            lines.append(f" X{j} X{i} {float(v)!r}")

    lines.append("ENDATA")
    text = "\n".join(lines) + "\n"
    if filename.endswith(".gz"):
        with gzip.open(filename, "wt") as f:
            f.write(text)
    else:
        with open(filename, "w") as f:
            f.write(text)
