"""MPS / QPS file reader (host side).

Replaces the reference's use of the QPSReader.jl package
(reference: src/quadratic_programming_io.jl:147-197). Supports:

- free format (whitespace-delimited) and fixed format (column positions),
- gzip-compressed files (".gz" suffix),
- ROWS (N/E/L/G), COLUMNS (incl. integrality MARKER lines, which are
  ignored: LP relaxation, matching benchmarking/drop_integrality.jl),
- RHS (including the objective-row entry, which sets the negative of the
  objective constant), RANGES, BOUNDS (LO/UP/FX/FR/MI/PL/BV/LI/UI),
- QUADOBJ / QMATRIX sections (lower triangle of the quadratic objective,
  0.5 x'Qx convention),
- OBJSENSE (must be MIN / unset; the reference asserts the same at
  src/quadratic_programming_io.jl:183).

The fixed-format path makes the mps_fixed_to_free.awk workaround of the
reference benchmarking pipeline unnecessary: names containing spaces are
handled directly by column slicing.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class MpsData:
    """Raw parse result, mirrors the fields of QPSReader.jl's QPSData."""

    name: str
    objsense: str  # "notset", "min", or "max"
    nvar: int
    ncon: int
    c0: float
    c: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    lcon: np.ndarray
    ucon: np.ndarray
    arows: np.ndarray
    acols: np.ndarray
    avals: np.ndarray
    qrows: np.ndarray
    qcols: np.ndarray
    qvals: np.ndarray
    varnames: List[str]
    connames: List[str]


class MpsParseError(ValueError):
    pass


_SECTIONS = {
    "NAME",
    "OBJSENSE",
    "ROWS",
    "COLUMNS",
    "RHS",
    "RANGES",
    "BOUNDS",
    "QUADOBJ",
    "QMATRIX",
    "QSECTION",
    "ENDATA",
}

# 0-based [start, end) character spans of the six fixed-format fields.
_FIXED_FIELDS = [(1, 3), (4, 12), (14, 22), (24, 36), (39, 47), (49, 61)]


def _fixed_fields(line: str) -> List[str]:
    out = []
    for lo, hi in _FIXED_FIELDS:
        field = line[lo:hi].strip()
        if field:
            out.append(field)
    return out


def _open(filename: str):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename, "r")


def _lines(filename: str) -> Iterator[str]:
    with _open(filename) as f:
        for raw in f:
            line = raw.rstrip("\n").rstrip("\r")
            if not line.strip():
                continue
            if line.lstrip().startswith("*"):
                continue
            yield line


def read_mps(filename: str, fixed_format: bool = False) -> MpsData:
    """Parses an MPS/QPS file into an MpsData struct.

    Free-format files go through the native C++ tokenizer (io/native.py;
    its speed against the pure-Python parser is measured by
    chip_smoke.py's cli_path phase, PERF.md). Fixed format,
    FIRSTORDERLP_NO_NATIVE_MPS=1, or a machine without g++ and without
    the built library uses the pure-Python path below; the two are
    field-exact equivalent (tests/test_torch_io_native.py).
    """
    if not fixed_format:
        from . import native

        lib = native.load()
        if lib is not None:
            with open(filename, "rb") as f:
                raw = f.read()
            if filename.endswith(".gz"):
                raw = gzip.decompress(raw)
            return native.parse_bytes(lib, raw)
    return _read_mps_python(filename, fixed_format)


def _read_mps_python(filename: str, fixed_format: bool = False) -> MpsData:
    """Pure-Python reference parser (semantics source of truth)."""
    name = ""
    objsense = "notset"
    obj_row: Optional[str] = None
    row_types = {}  # name -> type in {E,L,G}
    row_order: List[str] = []
    row_index = {}
    col_index = {}
    varnames: List[str] = []
    c0 = 0.0
    c_entries = {}  # col -> coefficient
    a_rows: List[int] = []
    a_cols: List[int] = []
    a_vals: List[float] = []
    rhs = {}
    obj_rhs = 0.0
    ranges = {}
    q_rows: List[int] = []
    q_cols: List[int] = []
    q_vals: List[float] = []
    bounds = []  # (type, colname, value-or-None)

    section = None
    pending_objsense = False

    def get_col(colname: str) -> int:
        if colname not in col_index:
            col_index[colname] = len(varnames)
            varnames.append(colname)
        return col_index[colname]

    for line in _lines(filename):
        starts_flush = not line[0].isspace()
        tokens = line.split()
        if starts_flush:
            head = tokens[0].upper()
            if head in _SECTIONS:
                section = head
                if head == "NAME":
                    name = tokens[1] if len(tokens) > 1 else ""
                elif head == "OBJSENSE":
                    if len(tokens) > 1:
                        objsense = tokens[1].strip().lower()[:3]
                        pending_objsense = False
                    else:
                        pending_objsense = True
                elif head == "ENDATA":
                    break
                continue
            raise MpsParseError(f"Unknown section header: {line!r}")

        if section == "OBJSENSE" and pending_objsense:
            objsense = tokens[0].strip().lower()[:3]
            pending_objsense = False
            continue

        fields = _fixed_fields(line) if fixed_format else tokens

        if section == "ROWS":
            if len(fields) < 2:
                raise MpsParseError(f"Bad ROWS line: {line!r}")
            rtype = fields[0].upper()
            rname = fields[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                # Extra N rows are free rows; ignored like QPSReader does.
                continue
            if rtype not in ("E", "L", "G"):
                raise MpsParseError(f"Unknown row type {rtype!r}")
            if rname in row_index:
                raise MpsParseError(f"Duplicate row name {rname!r}")
            row_index[rname] = len(row_order)
            row_order.append(rname)
            row_types[rname] = rtype

        elif section == "COLUMNS":
            # Integrality markers: ignored (we solve the LP relaxation).
            if len(fields) >= 3 and "'MARKER'" in fields:
                continue
            colname = fields[0]
            col = get_col(colname)
            pairs = fields[1:]
            if len(pairs) % 2 != 0:
                raise MpsParseError(f"Bad COLUMNS line: {line!r}")
            for i in range(0, len(pairs), 2):
                rname, sval = pairs[i], pairs[i + 1]
                val = float(sval)
                if rname == obj_row:
                    c_entries[col] = c_entries.get(col, 0.0) + val
                elif rname in row_index:
                    a_rows.append(row_index[rname])
                    a_cols.append(col)
                    a_vals.append(val)
                else:
                    raise MpsParseError(f"Unknown row {rname!r} in COLUMNS")

        elif section == "RHS":
            # First field is the (arbitrary) RHS vector name.
            pairs = fields[1:]
            if len(pairs) % 2 != 0:
                raise MpsParseError(f"Bad RHS line: {line!r}")
            for i in range(0, len(pairs), 2):
                rname, sval = pairs[i], pairs[i + 1]
                val = float(sval)
                if rname == obj_row:
                    obj_rhs = val
                elif rname in row_index:
                    rhs[rname] = val
                else:
                    raise MpsParseError(f"Unknown row {rname!r} in RHS")

        elif section == "RANGES":
            pairs = fields[1:]
            if len(pairs) % 2 != 0:
                raise MpsParseError(f"Bad RANGES line: {line!r}")
            for i in range(0, len(pairs), 2):
                rname, sval = pairs[i], pairs[i + 1]
                if rname not in row_index:
                    raise MpsParseError(f"Unknown row {rname!r} in RANGES")
                ranges[rname] = float(sval)

        elif section == "BOUNDS":
            btype = fields[0].upper()
            if btype in ("FR", "MI", "PL", "BV"):
                # bound-name colname [ignored value]
                if len(fields) < 3:
                    raise MpsParseError(f"Bad BOUNDS line: {line!r}")
                bounds.append((btype, fields[2], None))
            else:
                if len(fields) < 4:
                    raise MpsParseError(f"Bad BOUNDS line: {line!r}")
                bounds.append((btype, fields[2], float(fields[3])))

        elif section in ("QUADOBJ", "QMATRIX", "QSECTION"):
            if len(fields) < 3:
                raise MpsParseError(f"Bad quadratic objective line: {line!r}")
            i = get_col(fields[0])
            j = get_col(fields[1])
            val = float(fields[2])
            if section == "QMATRIX":
                # QMATRIX lists the full matrix; keep only lower triangle to
                # unify with QUADOBJ (both are symmetrized downstream).
                if i < j:
                    continue
            q_rows.append(i)
            q_cols.append(j)
            q_vals.append(val)

        elif section in ("NAME", "OBJSENSE"):
            continue
        else:
            raise MpsParseError(f"Data line outside any section: {line!r}")

    ncon = len(row_order)
    nvar = len(varnames)

    c = np.zeros(nvar)
    for col, val in c_entries.items():
        c[col] = val

    lcon = np.full(ncon, -np.inf)
    ucon = np.full(ncon, np.inf)
    for idx, rname in enumerate(row_order):
        rtype = row_types[rname]
        b = rhs.get(rname, 0.0)
        if rtype == "E":
            lcon[idx] = b
            ucon[idx] = b
        elif rtype == "L":
            ucon[idx] = b
        elif rtype == "G":
            lcon[idx] = b

    # RANGES semantics (standard MPS, as implemented by QPSReader):
    #   E, r >= 0: [rhs, rhs + r];  E, r < 0: [rhs + r, rhs]
    #   L: [rhs - |r|, rhs];        G: [rhs, rhs + |r|]
    for rname, r in ranges.items():
        idx = row_index[rname]
        rtype = row_types[rname]
        b = rhs.get(rname, 0.0)
        if rtype == "E":
            if r >= 0:
                lcon[idx], ucon[idx] = b, b + r
            else:
                lcon[idx], ucon[idx] = b + r, b
        elif rtype == "L":
            lcon[idx], ucon[idx] = b - abs(r), b
        elif rtype == "G":
            lcon[idx], ucon[idx] = b, b + abs(r)

    lvar = np.zeros(nvar)
    uvar = np.full(nvar, np.inf)
    upper_set = np.zeros(nvar, dtype=bool)
    lower_set = np.zeros(nvar, dtype=bool)
    for btype, colname, value in bounds:
        if colname not in col_index:
            raise MpsParseError(f"Unknown column {colname!r} in BOUNDS")
        j = col_index[colname]
        if btype in ("LO", "LI"):
            lvar[j] = value
            lower_set[j] = True
        elif btype in ("UP", "UI"):
            uvar[j] = value
            upper_set[j] = True
            # Classic MPS convention: a negative upper bound with no explicit
            # lower bound implies the lower bound is -inf.
            if value < 0 and not lower_set[j]:
                lvar[j] = -np.inf
        elif btype == "FX":
            lvar[j] = value
            uvar[j] = value
            lower_set[j] = True
            upper_set[j] = True
        elif btype == "FR":
            lvar[j] = -np.inf
            uvar[j] = np.inf
        elif btype == "MI":
            lvar[j] = -np.inf
            lower_set[j] = True
        elif btype == "PL":
            uvar[j] = np.inf
            upper_set[j] = True
        elif btype == "BV":
            lvar[j] = 0.0
            uvar[j] = 1.0
            lower_set[j] = True
            upper_set[j] = True
        else:
            raise MpsParseError(f"Unknown bound type {btype!r}")

    return MpsData(
        name=name,
        objsense=objsense,
        nvar=nvar,
        ncon=ncon,
        c0=-obj_rhs,
        c=c,
        lvar=lvar,
        uvar=uvar,
        lcon=lcon,
        ucon=ucon,
        arows=np.asarray(a_rows, dtype=np.int64),
        acols=np.asarray(a_cols, dtype=np.int64),
        avals=np.asarray(a_vals, dtype=np.float64),
        qrows=np.asarray(q_rows, dtype=np.int64),
        qcols=np.asarray(q_cols, dtype=np.int64),
        qvals=np.asarray(q_vals, dtype=np.float64),
        varnames=varnames,
        connames=row_order,
    )
