"""recaptures: the program's frozen-frame graph captures
(ops/frozen_graph.COUNTS["captures"]) across the warm loop and the timed
window: 0 when every pose's buckets were final before the window.
Program counter; missing where the run did not read it."""


def read(rec):
    return getattr(rec, "recaptures", None)
