"""enqueue_ms: the host's time in the render call of a frame that does
not verify (the frozen frame's graph replay, the camera write, the uint8
conversion), mean over the window's such frames. Host clock."""


def read(rec):
    if not rec.enqueue_s:
        return None
    return sum(rec.enqueue_s) / len(rec.enqueue_s) * 1e3
