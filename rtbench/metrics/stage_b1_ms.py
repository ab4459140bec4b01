"""stage_b1_ms: device ms per frame of the culled frame's stage B1 (the
primary work lists, K1 and the visited mask): the program's device stamps
1 to 2 of each band's frame, mean over the frames and the cards, from the
tracer window (spans.py). Missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.stage_ms(getattr(rec, "trace", None), 1)
