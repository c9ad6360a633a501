"""Seconds of the set-up's warm solve on the freshly prepared LP, which
captures the segment graphs (ops/graphs.SegmentGraphs), on the host
clock up to a device synchronize."""

LAYER = "Segment graphs"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return record["spans"].get("first_solve_s.lp")
