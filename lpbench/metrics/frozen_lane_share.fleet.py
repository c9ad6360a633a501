"""The share of the fleet's lane work spent on lanes that take no step:
1 - (every lane's own iterations) / (the lanes the window's trials
computed, the change of the program's
firstorderlp_torch.spans.COUNTS["lane_steps"], B a trial), in percent.
Every trial computes every lane; a lane that has ended, or whose step
the adaptive rule rejects, computes it for nothing. Lane compaction or
early retirement would move it. None for a program without the
counter."""

LAYER = "Dispatch and segment"
UNIT = "%"
MOVES = "iters_per_s"


def read(record):
    lane_steps = sum(s.get("counts", {}).get("lane_steps", 0)
                     for s in record["solves"])
    if not record.get("trace") or not lane_steps:
        return None
    iterations = sum(s["iterations"] for s in record["solves"])
    return 100.0 * (1.0 - iterations / lane_steps)
