"""band_issue_ms: host ms per frame from the start of the first rank's
bands.replay span to the end of the last rank's (the program's span around
each rank's graph replay), from the tracer window (spans.py). Cells of
bands; missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.band_issue_ms(getattr(rec, "trace", None))
