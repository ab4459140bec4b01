"""verify_sync_ms: host ms of the program's span frozen.verify (the verify
frame's bucket check: the host sync on the frame's counts, and any
refreeze rounds), mean per verify frame, from the tracer window
(spans.py). Missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.span_ms(getattr(rec, "trace", None), "frozen.verify")
