"""Seconds of the LP's ingest at set-up: the solver's prepare_problem
(preprocess.rescale_problem on the host, ops/device_problem
.to_device_scaled, ops/routed.build_routed_op), on the host clock up
to a device synchronize."""

LAYER = "Ingest"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return record["spans"].get("ingest_s.lp")
