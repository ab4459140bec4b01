"""stage_a_ms: device ms per frame of the culled frame's stage A (raygen, ray
packing, the tile hulls and the top cull mask): the program's device
stamps 0 to 1 of each band's frame, mean over the frames and the cards,
from the tracer window (spans.py). Missing without the program's tracer."""

from rtbench import spans


def read(rec):
    return spans.stage_ms(getattr(rec, "trace", None), 0)
