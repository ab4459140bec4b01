"""device_idle_share: per card, 1 - (the union of the frames' intervals
on the card's frame streams, each between a CUDA event recorded before
the frame's render call and one after it) / the window's length on the
device; the mean over the cell's cards. No profiler is open."""


def union_ms(spans, length):
    total, end = 0.0, 0.0
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, length)
        if b > a:
            total += b - a
            end = b
    return total


def read(rec):
    if not rec.intervals:
        return None
    shares = [1.0 - union_ms(spans, length) / length
              for length, spans in rec.intervals]
    return sum(shares) / len(shares)
