"""Finding a cell's pieces by name.

`BENCHMARK.json` (at the root of the checkout) names each cell's
configuration and traffic mix; their files are `configs/<config>.json` and
`traffic/<traffic>.json` beside this module, and each per-layer metric is
`metrics/<name>.py`. Nothing here lists a cell, a configuration, a mix or
a metric: a new one is a new file and a new entry. A cell whose mix moves
the scene needs a layout that sets MOVES (it takes each frame's scene
state); any other is refused when the cell is read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(folder: str, name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, folder, f"{name}.json")) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """`<folder>/<name>.py` beside this module, imported by its path (a name
    may hold dots or dashes)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder} module named {name!r} ({path})")
    key = f"rtbench.{folder}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    loaded = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(loaded)
    sys.modules[key] = mod
    loaded.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None, here: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`), with its files
    read from `here` (this folder)."""
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    config = _json("configs", w["config"], here)
    traffic = _json("traffic", w["traffic"], here)
    from rtbench.traffic import moves

    layout = config["layout"].get(str(w["chips"]))
    if moves(traffic) and not getattr(load_module("layouts", layout),
                                      "MOVES", False):
        raise ValueError(f"{name}: traffic {w['traffic']!r} moves the "
                         f"scene; layout {layout!r} cannot (no MOVES)")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer)
