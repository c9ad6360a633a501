"""The bytes the algorithm's matrix products need, from the LP's shapes,
and the chip's published peak bandwidth. The work is counted whatever
kernel carries it, so a later fusion neither dodges nor inflates it.

One KKT pass is one product with A and one with A' (FirstOrderLp.jl's
cumulative_kkt_matrix_passes). Its bytes: A in CSR once and A' in CSR
once (int32 column indices and row pointers, f32 values), and each
operand and result vector once (x and A x, y and A'y, f32). It is a
floor: the vector traffic of the steps around the products is left out.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s (700 W)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
INDEX_BYTES = 4
VALUE_BYTES = 4


def pass_bytes(m: int, n: int, nnz: int) -> int:
    """One KKT pass: indices and row pointers of A (m rows) and A' (n
    rows), their values, and x, A x, y, A'y."""
    return (INDEX_BYTES * (2 * nnz + (m + 1) + (n + 1))
            + VALUE_BYTES * (2 * nnz + 2 * (m + n)))


def peak_bytes_per_s(kind: str) -> float | None:
    return PEAK_BYTES_PER_S.get(kind)
