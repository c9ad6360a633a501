"""Device milliseconds an iteration: the union of the device's kernel
and copy intervals in the traced window over the iterations its solves
completed. Steadier than iters_per_s, which carries each solve's host
work and so moves with the seed's iterations a solve."""

LAYER = "Device"
UNIT = "ms/iter"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    iterations = sum(s["iterations"] for s in record["solves"])
    if not trace or trace["busy_s"] <= 0 or not iterations:
        return None
    return 1000.0 * trace["busy_s"] / iterations
