"""CUDA runtime and driver calls the host made in the traced window
(kernel and graph launches, copies, synchronizations: torch.profiler's
host records whose names start cu...), over the iterations the window's
solves completed. The dispatch and segment loops of models/pdhg and
models/mirror_prox set it."""

LAYER = "Dispatch and segment"
UNIT = "calls/iter"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    iterations = sum(s["iterations"] for s in record["solves"])
    if not trace or not trace["busy_s"] or not iterations:
        return None
    return trace["host_runtime_calls"] / iterations
