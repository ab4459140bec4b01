"""drain_wait_ms: host ms of the program's span loop.drain (the loop's
wait for a frame's host copy), mean per frame, from the tracer window
(spans.py). Missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.span_ms(getattr(rec, "trace", None), "loop.drain")
