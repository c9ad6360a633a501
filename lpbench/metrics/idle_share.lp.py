"""The device's idle share of the traced window: 1 - (the union of its
kernel and copy intervals) / (the window's length), in percent."""

LAYER = "Device"
UNIT = "%"
MOVES = "iters_per_s"


def read(record):
    trace = record.get("trace")
    # no device op: nothing to read
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
