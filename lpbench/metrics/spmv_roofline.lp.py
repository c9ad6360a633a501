"""The matrix products' share of their roofline: the bytes the traced
window's KKT passes need (lpbench/roofline.py: A and A' in CSR once a
pass, each operand and result vector once) over the chip's published
peak bandwidth, over the device's busy seconds, in percent. Left out
on a card with no published peak in the table."""

from lpbench import roofline

LAYER = "Kernels"
UNIT = "%"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    peak = roofline.peak_bytes_per_s(record["device_kind"])
    if not trace or not peak or trace["busy_s"] <= 0:
        return None
    passes = sum(s["kkt_passes"] for s in record["solves"])
    window_bytes = roofline.pass_bytes(*record["shape"]) * passes
    return 100.0 * window_bytes / peak / trace["busy_s"]
