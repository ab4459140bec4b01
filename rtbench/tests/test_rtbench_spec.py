"""BENCHMARK.json against the rules of its format, and every piece of a
cell found by its name."""

import json
import os
import re
import shutil

from rtbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["rtbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(LINE.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_lines():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("rtbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert len(names) == len(set(names))


def test_per_layer_metrics_move_frame_ms_with_workloads():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "frame_ms" and LINE.match(m["layer"])
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_four_chip_cells_are_few():
    ws = bench()["workloads"]
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)


def test_every_piece_is_found_by_name():
    b = bench()
    for c in b["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config_name == w["config"] and cell.chips == w["chips"]
        layout = cell.config["layout"][str(cell.chips)]
        assert hasattr(spec.load_module("layouts", layout), "build")
        assert {"move_step", "frames_in_flight", "verify_period",
                "paced"} <= set(cell.traffic)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} == {
            "frame_ms", "latency_p95_ms", "setup_s"}
        assert cell.per_layer


def test_a_cell_written_as_data_alone_is_picked_up(tmp_path):
    """A later PR adds a cell as a new traffic file and a new entry: the
    harness finds both without an edit."""
    for folder in ("configs", "traffic"):
        shutil.copytree(os.path.join(spec.HERE, folder), tmp_path / folder)
    mix = dict(spec._json("traffic", "orbit"), paced=True,
               why="paced at 30 Hz")
    (tmp_path / "traffic" / "paced30.json").write_text(json.dumps(mix))
    b = bench()
    b["workloads"].append({"name": "ico9.paced30", "config": "ico9-640",
                           "traffic": "paced30", "chips": 1, "why": "x"})
    cell = spec.cell("ico9.paced30", b, here=str(tmp_path))
    assert cell.traffic["paced"] is True
    assert cell.config["scene"]["subdivisions"] == 9
    # Metrics without a workloads list reach the new cell too.
    assert {m["name"] for m in cell.end_to_end} >= {"frame_ms", "setup_s"}
