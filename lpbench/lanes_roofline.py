"""The bytes a shared-pattern fleet's matrix products need, from the
pattern's shapes and each lane's KKT passes, whatever kernel carries
them (lpbench/roofline.py counts one LP's).

The lanes share A's pattern, so A's and A''s int32 column indices and row
pointers are read once a fleet pass, and the fleet makes as many passes
as its longest lane. Each lane's own f32 values of A and A', and its x,
A x, y and A'y, are read once for each of that lane's own passes. A
lane's passes after it has ended are not counted: they are not the
lanes' work, so a later compaction of ended lanes does not inflate the
count, and a kernel that fuses the passes does not dodge it.
"""

from __future__ import annotations

from lpbench.roofline import INDEX_BYTES, VALUE_BYTES


def pattern_bytes(m: int, n: int, nnz: int) -> int:
    """One fleet pass over the shared pattern: indices and row pointers
    of A (m rows) and A' (n rows)."""
    return INDEX_BYTES * (2 * nnz + (m + 1) + (n + 1))


def lane_pass_bytes(m: int, n: int, nnz: int) -> int:
    """One lane's pass: its values of A and A', and x, A x, y, A'y."""
    return VALUE_BYTES * (2 * nnz + 2 * (m + n))


def fleet_bytes(m: int, n: int, nnz: int, lane_passes) -> float:
    """A fleet solve whose lanes made `lane_passes` KKT passes each."""
    if not lane_passes:
        return 0.0
    return (pattern_bytes(m, n, nnz) * max(lane_passes)
            + lane_pass_bytes(m, n, nnz) * sum(lane_passes))
