"""gather_ms: device ms per frame on rank 0's card from the end of band
0's stage C (the program's device stamp 4) to its stamp after the bands
are gathered and assembled, from the tracer window (spans.py). Cells of
bands; missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.gather_ms(getattr(rec, "trace", None))
