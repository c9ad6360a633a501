"""CUDA runtime and driver calls the host made in the traced window
(torch.profiler's host records whose names start cu...), over the fleet
step trials the window's solves launched (the change of the program's
firstorderlp_torch.spans.COUNTS["steps"] over each solve). The fleet's
host loop and its eager lane step (batch.run_segment) set it. None for
a program whose fleet does not count its trials."""

LAYER = "Dispatch and segment"
UNIT = "calls/trial"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    trials = sum(s.get("counts", {}).get("steps", 0)
                 for s in record["solves"])
    if not trace or not trace["busy_s"] or not trials:
        return None
    return trace["host_runtime_calls"] / trials
