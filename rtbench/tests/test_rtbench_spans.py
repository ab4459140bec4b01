"""The readers of the program's tracer (spans.py, metrics/stage_*_ms.py ...
metrics/recaptures.py) on a synthetic export, on the parent's Records (no
tracer: no reading), and whole tiny CPU cells through `spans.run`, which
report every reading that applies with no clock violation."""

import types

import pytest
import torch

from rtbench import spans, spec
from rtbench.tests.test_rtbench_run import cell

MS = 1_000_000


def span(name, frame, start, end, parent=None, **attrs):
    return {"name": name, "frame": frame, "start_ns": start, "end_ns": end,
            "parent": parent, "id": None, "attrs": attrs}


def stages(frame, rank, t, steps, issued=None):
    ns = [t]
    for s in steps:
        ns.append(ns[-1] + s)
    return {"kind": "stages", "card": f"cuda:{rank}", "rank": rank,
            "frame": frame, "issued_ns": issued, "ns": ns}


def synthetic():
    """Two frames on two bands: stages of 1, 2, 3, 4 ms on rank 0 and 3,
    2, 1, 0 ms on rank 1; verify 5 ms on frame 0; drains of 6 and 8 ms;
    replays issued 0.5 ms apart; the gather stamp 1.5 ms after band 0's
    stage C."""
    sp, st = [], []
    for f in (0, 1):
        t = f * 100 * MS
        sp.append(span("loop.issue", f, t, t + MS))
        sp += [span("bands.replay", f, t + r * MS // 2,
                    t + r * MS // 2 + MS // 4, parent=10 + f, rank=r)
               for r in (0, 1)]
        st.append(stages(f, 0, t + MS, [MS, 2 * MS, 3 * MS, 4 * MS],
                         issued=t))
        st.append(stages(f, 1, t + MS, [3 * MS, 2 * MS, MS, 0],
                         issued=t + MS // 2))
        st.append({"kind": "gather", "card": "cuda:0", "rank": None,
                   "frame": f, "issued_ns": None,
                   "ns": [t + 11 * MS + 3 * MS // 2]})
        sp.append(span("loop.drain", f, t + 20 * MS, t + (26 + 2 * f) * MS))
    sp.append(span("frozen.verify", 0, MS // 2, 5 * MS + MS // 2))
    return {"spans": sp, "stamps": st, "counters": {}, "clock": {}}


def read(name, trace, **extra):
    rec = types.SimpleNamespace(trace=trace, **extra)
    return spec.load_module("metrics", name).read(rec)


def test_readers_on_a_synthetic_export():
    t = synthetic()
    assert read("stage_a_ms", t) == pytest.approx(2.0)
    assert read("stage_b1_ms", t) == pytest.approx(2.0)
    assert read("stage_b2_ms", t) == pytest.approx(2.0)
    assert read("stage_c_ms", t) == pytest.approx(2.0)
    assert read("verify_sync_ms", t) == pytest.approx(5.0)
    assert read("drain_wait_ms", t) == pytest.approx(7.0)
    assert read("band_issue_ms", t) == pytest.approx(0.75)
    assert read("gather_ms", t) == pytest.approx(1.5)
    assert read("recaptures", t, recaptures=0) == 0
    assert spans.violations(t) == 0
    assert spans.frames_ms(t, 1) == pytest.approx(8.0)
    assert spans.frames_ms(t, 2) == pytest.approx(8.0)
    assert spans.frames_ms(t, 0) is None and spans.frames_ms(None, 1) is None


def test_violations_count_stamps_off_the_host_spans():
    t = synthetic()
    t["stamps"][0]["ns"][0] = -MS          # stage A before its issue
    t["stamps"][4]["ns"][-1] = 200 * MS    # stage C after its drain
    assert spans.violations(t) == 2
    assert spans.violations(t, slack_ns=10 ** 12) == 0


def test_no_tracer_no_reading():
    """The parent's Records (no trace, no recaptures) and an export with
    nothing for a reader give None."""
    rec = types.SimpleNamespace(setup_s=1.0)
    empty = {"spans": [], "stamps": [], "counters": {}, "clock": {}}
    for name in spans.READERS:
        reader = spec.load_module("metrics", name).read
        assert reader(rec) is None
        assert reader(types.SimpleNamespace(trace=empty)) is None
    assert spans.violations(None) == 0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chips", [1, 2])
def test_a_tiny_cell_reports_every_reading(chips):
    line = spans.run(cell(chips), 2**31 + 13, 1.0, device="cpu")
    want = set(spans.READERS)
    if chips == 1:
        want -= {"band_issue_ms", "gather_ms"}
    assert set(line["metrics"]) == want
    assert line["metrics"]["recaptures"] == 0
    assert line["violations"] == 0 and line["failed"] == 0
    assert line["frames_traced"] == 8 * cell(chips).traffic["verify_period"]
    for name in want - {"recaptures"}:
        assert line["metrics"][name] >= 0.0, name
