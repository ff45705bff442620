"""The manifest (``BENCHMARK.json`` at the checkout's root) and the files it
names.

A cell is one entry of the manifest's ``workloads``.  It is resolved by
name into

* its configuration: the manifest's ``configs`` entry and the JSON file
  that entry names (``port_bench/configs/<config>.json``);
* its traffic: ``port_bench/traffic/<traffic>.json``, the driver's name and
  its parameters;
* its limits: ``port_bench/workloads/<cell>.json``, the numbers that decide
  ``correct`` and the limit of each;
* its metrics: the end-to-end metrics whose ``workloads`` name it (or that
  have no ``workloads``), and the per-layer metrics that list it (or that
  have no ``workloads`` and move an end-to-end metric the cell reports).

A driver is ``port_bench/drivers/<driver>.py`` and a per-layer metric's
reader ``port_bench/metrics/<metric>.py``; both are loaded from their
files, so a later change adds them as files and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None  # per-layer metrics only


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file: "driver" and its parameters
    limits: dict  # {number: limit}
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest with every file it names
    read from ``root`` (drivers and readers always come from this
    checkout's ``port_bench``)."""
    manifest = load_manifest(root / "BENCHMARK.json")
    bench = root / BENCH_DIR.name
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the manifest; valid: {', '.join(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [Metric(m["name"], m["unit"]) for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m.name for m in e2e}
    layer = [Metric(m["name"], m["unit"], m["moves"])
             for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name, chips=int(w["chips"]), config=_read_json(root / cfg_entry["file"]),
        traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench / "workloads" / f"{name}.json")["limits"],
        end_to_end=e2e, per_layer=layer,
    )


def _load_module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + label.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


_readers: Dict[str, Callable] = {}


def driver(name: str):
    """The driver module ``port_bench/drivers/<name>.py``."""
    return _load_module(BENCH_DIR / "drivers" / f"{name}.py", f"driver_{name}")


def reader(metric: str) -> Callable:
    """``read(ctx) -> float | None`` of ``port_bench/metrics/<metric>.py``."""
    if metric not in _readers:
        _readers[metric] = _load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                                        f"metric_{metric}").read
    return _readers[metric]
