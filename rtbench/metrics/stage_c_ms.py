"""stage_c_ms: device ms per frame of the culled frame's stage C (the shadow
work list, K2, Phong, the write-back and the assembly): the program's
device stamps 3 to 4 of each band's frame, mean over the frames and the
cards, from the tracer window (spans.py). Missing without the program's
tracer."""

from rtbench import spans


def read(rec):
    return spans.stage_ms(getattr(rec, "trace", None), 3)
