"""frame_ms: the window's wall time over the frames it displayed (closed
loop; the window runs from the first input tick until the loop has
displayed its last frame). Host clock."""


def read(rec):
    return rec.window_s * 1e3 / rec.shown if rec.shown else None
