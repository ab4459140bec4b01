"""fold_ms: device ms per frame of the dynamic frame's scene-diff fold (the
SceneDiff folded into the triangle rows, the shading table, the leaf-block
boxes and the light rows): the program's two "fold" device stamps of each
frame, mean over the frames and the cards, from the tracer window
(spans.py). Missing without the program's tracer, and in a cell whose
scene does not move."""


def read(rec):
    trace = getattr(rec, "trace", None)
    if not trace:
        return None
    rows = [r for r in trace["stamps"]
            if r["kind"] == "fold" and r["frame"] is not None]
    if not rows:
        return None
    return sum(r["ns"][1] - r["ns"][0] for r in rows) / len(rows) / 1e6
