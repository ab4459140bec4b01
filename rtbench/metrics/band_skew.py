"""band_skew: the slowest card's device ms per frame over the mean of the
cell's cards, each card's the mean length of the frames' intervals on its
frame streams (as for device_idle_share). Cells of more than one card."""


def read(rec):
    if not rec.intervals or len(rec.intervals) < 2:
        return None
    per_card = [sum(b - a for a, b in spans) / len(spans)
                for _, spans in rec.intervals if spans]
    return max(per_card) / (sum(per_card) / len(per_card))
