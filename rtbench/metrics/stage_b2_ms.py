"""stage_b2_ms: device ms per frame of the culled frame's stage B2 (hit-tile
compaction, shading prep, the light gates and the light masks): the
program's device stamps 2 to 3 of each band's frame, mean over the frames
and the cards, from the tracer window (spans.py). Missing without the
program's tracer."""

from rtbench import spans


def read(rec):
    return spans.stage_ms(getattr(rec, "trace", None), 2)
