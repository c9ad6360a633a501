"""Seconds of the ingest's host rescaling (preprocess.rescale_problem in
the solver's prepare_problem) at set-up, as the program counts them on
the host clock (firstorderlp_torch.spans.COUNTS["rescale_seconds"],
the span folp.ingest.rescale). Read once the window has closed: nothing
after set-up rescales, so the counter holds the set-up's seconds. None
for a program without the counter."""

LAYER = "Ingest"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    try:
        from firstorderlp_torch.spans import COUNTS
    except ImportError:
        return None
    return COUNTS.get("rescale_seconds") or None
