"""The fleet's matrix products' share of their roofline: the bytes the
traced window's fleet solves need (lpbench/lanes_roofline.py: the shared
pattern once a pass of the longest lane, each lane's values and vectors
once a pass of its own) over the chip's published peak bandwidth, over
the device's busy seconds, in percent. Left out on a card with no
published peak in the table."""

from lpbench import lanes_roofline, roofline

LAYER = "Kernels"
UNIT = "%"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    peak = roofline.peak_bytes_per_s(record["device_kind"])
    if not trace or not peak or trace["busy_s"] <= 0:
        return None
    if not all("lane_kkt_passes" in s for s in record["solves"]):
        return None
    window_bytes = sum(
        lanes_roofline.fleet_bytes(*record["shape"], s["lane_kkt_passes"])
        for s in record["solves"])
    return 100.0 * window_bytes / peak / trace["busy_s"]
